"""Port parity for the training path: loss, gradients, AdamW and the train
step of repro_torch against repro's, at smoke size in f32.

The JAX params are converted key for key; batches come from seeded NumPy.
Tolerances are the reference's own (``tests/test_models.py``: 2e-3) unless
a test says otherwise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import config as jconfig
from repro.core.config import get_arch as jax_get_arch
from repro.launch import steps as jsteps
from repro.models import api as japi
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro_torch.convert import params_from_jax
from repro_torch.core import config as tconfig
from repro_torch.launch import steps as tsteps
from repro_torch.models import api as tapi
from repro_torch.models import lm as tlm
from repro_torch.optim import adamw as tadamw

TOL = dict(atol=2e-3, rtol=2e-3)
B, S = 2, 12
# the dense LM, one with GQA and an untied head, one with an MoE aux loss,
# and MLA (K2 and its backward at hd 24, hd_v 16) with a dense prefix layer
# and MoE layers
LOSS_ARCHS = ["qwen1.5-0.5b", "minitron-8b", "granite-moe-1b-a400m",
              "deepseek-v2-236b"]


def _f32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32",
                               compute_dtype="float32")


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _named(tree):
    """{path: leaf} of a nested dict of arrays or tensors."""
    return dict(tadamw.named_leaves(tree))


def _tokens(cfg, seed=0, batch=B, seq=S):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, seq)).astype(np.int32)


class Pair:
    """One arch's JAX params and their port twin."""

    def __init__(self, arch):
        self.jcfg = _f32(jax_get_arch(arch).smoke)
        self.tcfg = _f32(tconfig.get_arch(arch).smoke)
        self.jp = japi.init_params(jax.random.key(1), self.jcfg)
        self.np_params = _np_tree(self.jp)

    def tparams(self):
        return params_from_jax(self.np_params, "cpu")


@pytest.fixture(scope="module", params=LOSS_ARCHS)
def pair(request):
    return Pair(request.param)


def _torch_loss_and_grads(cfg, params, batch, remat="none"):
    named = tadamw.named_leaves(params)
    alias = {p: t.detach().requires_grad_() for p, t in named}
    loss, metrics = tapi.loss_fn(tadamw.tree_like(params, alias), cfg, batch,
                                 remat=remat)
    grads = torch.autograd.grad(loss, [alias[p] for p, _ in named])
    return loss, metrics, {p: g for (p, _), g in zip(named, grads)}


@pytest.mark.parametrize("masked", [False, True])
def test_loss_and_grads_match_jax(pair, masked):
    toks = _tokens(pair.jcfg)
    jbatch = {"tokens": jnp.asarray(toks)}
    tbatch = {"tokens": torch.from_numpy(toks)}
    if masked:
        mask = (np.random.default_rng(5).random((B, S)) < 0.6)
        mask = mask.astype(np.float32)
        jbatch["loss_mask"] = jnp.asarray(mask)
        tbatch["loss_mask"] = torch.from_numpy(mask)
    cfg = pair.jcfg
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: japi.loss_fn(p, cfg, b, remat="none"), has_aux=True))(
        pair.jp, jbatch)
    loss, metrics, grads = _torch_loss_and_grads(pair.tcfg, pair.tparams(),
                                                 tbatch)
    for key in ("loss", "aux", "total"):
        np.testing.assert_allclose(float(metrics[key].detach()),
                                   float(jmet[key]), **TOL)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **TOL)
    jnamed = _named(_np_tree(jgrads))
    assert jnamed.keys() == grads.keys()
    for path, g in grads.items():
        np.testing.assert_allclose(g.numpy(), jnamed[path], **TOL,
                                   err_msg=path)
    if pair.tcfg.moe is not None:
        got = {k: float(v.detach()) for k, v in metrics.items()}
        assert got["aux"] > 0
        np.testing.assert_allclose(
            got["total"], got["loss"] + pair.tcfg.moe.aux_loss_coef
            * got["aux"], rtol=1e-6)


@pytest.mark.parametrize("S_,chunk", [(13, 4), (13, 512), (7, 7)])
def test_chunked_xent_matches_jax(S_, chunk):
    """S not a multiple of the chunk (the port takes a ragged last chunk, the
    reference pads it), a single chunk, and chunk = S."""
    p = Pair("qwen1.5-0.5b")
    rng = np.random.default_rng(2)
    h = rng.standard_normal((B, S_, p.jcfg.d_model)).astype(np.float32)
    tgt = rng.integers(0, p.jcfg.vocab_size, (B, S_)).astype(np.int32)
    mask = (rng.random((B, S_)) < 0.7).astype(np.float32)
    cfg = p.jcfg

    def jfn(params, hh):
        return jlm.chunked_xent(params, cfg, hh, jnp.asarray(tgt),
                                jnp.asarray(mask), chunk=chunk)

    jval, (jdp, jdh) = jax.jit(jax.value_and_grad(jfn, argnums=(0, 1)))(
        p.jp, jnp.asarray(h))
    tp = p.tparams()
    table = tp["embed"]["table"].requires_grad_()
    th = torch.from_numpy(h).requires_grad_()
    val = tlm.chunked_xent(tp, p.tcfg, th, torch.from_numpy(tgt),
                           torch.from_numpy(mask), chunk=chunk)
    dtable, dh = torch.autograd.grad(val, [table, th])
    np.testing.assert_allclose(float(val), float(jval), **TOL)
    np.testing.assert_allclose(dh.numpy(), np.asarray(jdh), **TOL)
    np.testing.assert_allclose(dtable.numpy(),
                               np.asarray(jdp["embed"]["table"]), **TOL)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def test_optimizer_configs_are_copies():
    for name in ("OptimizerConfig", "RematConfig", "TrainConfig"):
        j, t = getattr(jconfig, name)(), getattr(tconfig, name)()
        assert dataclasses.asdict(j) == dataclasses.asdict(t)


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_lr_schedule_matches_jax(schedule):
    cfg = jconfig.OptimizerConfig(schedule=schedule, warmup_steps=4,
                                  total_steps=20)
    tcfg = tconfig.OptimizerConfig(schedule=schedule, warmup_steps=4,
                                   total_steps=20)
    for step in (0, 1, 3, 4, 5, 12, 20, 25):
        want = float(jadamw.lr_schedule(cfg, jnp.asarray(step, jnp.int32)))
        got = float(tadamw.lr_schedule(
            tcfg, torch.tensor(step, dtype=torch.int32)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_compress_decompress_matches_jax_to_one_quantum():
    rng = np.random.default_rng(3)
    g = rng.standard_normal((64, 33)).astype(np.float32)
    ef = (0.01 * rng.standard_normal((64, 33))).astype(np.float32)
    jdeq, jres = jadamw.compress_decompress(jnp.asarray(g), jnp.asarray(ef))
    deq, res = tadamw.compress_decompress(torch.from_numpy(g),
                                          torch.from_numpy(ef))
    quantum = np.abs(g + ef).max() / 127.0
    np.testing.assert_allclose(deq.numpy(), np.asarray(jdeq), atol=quantum,
                               rtol=0)
    np.testing.assert_allclose(res.numpy(), np.asarray(jres), atol=quantum,
                               rtol=0)
    np.testing.assert_allclose(deq + res, g + ef, atol=1e-6, rtol=0)
    # round half to even, as jnp.round
    half = torch.tensor([0.5, 1.5, 2.5, -0.5, -2.5])
    assert torch.round(half).tolist() == np.asarray(
        jnp.round(jnp.asarray(half.numpy()))).tolist()


@pytest.mark.parametrize("n_steps", [1, 3])
@pytest.mark.parametrize("compression", ["none", "int8_ef"])
def test_adamw_update_matches_jax(n_steps, compression):
    """Leaf by leaf, after one and three steps from the same params and the
    same gradients.  Under int8_ef an element whose int8 rounding went the
    other way in the two (its error feedback one quantum apart) may differ
    by what one quantum of gradient moves; every other element is held
    tightly."""
    p = Pair("qwen1.5-0.5b")
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10,
              grad_compression=compression)
    jcfg, tcfg = jconfig.OptimizerConfig(**kw), tconfig.OptimizerConfig(**kw)
    jparams, tparams = p.jp, p.tparams()
    jstate = jadamw.init_opt_state(jparams, jcfg)
    tstate = tadamw.init_opt_state(tparams, tcfg)
    rng = np.random.default_rng(4)
    update = jax.jit(lambda pp, gg, ss: jadamw.adamw_update(pp, gg, ss, jcfg))
    flipped = {}
    for _ in range(n_steps):
        grads = jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(
            np.float32) * 0.1, p.np_params)
        jparams, jstate, jmet = update(jparams, grads, jstate)
        tparams, tstate, tmet = tadamw.adamw_update(
            tparams, params_from_jax(grads, "cpu"), tstate, tcfg)
        if compression == "int8_ef":
            jef, tef = _named(_np_tree(jstate["ef"])), _named(tstate["ef"])
            for path, e in tef.items():
                quantum = np.abs(_named(grads)[path]).max() / 127.0 * 1.5
                np.testing.assert_allclose(e.numpy(), jef[path],
                                           atol=quantum, rtol=0)
                flipped[path] = flipped.get(path, False) | (
                    np.abs(e.numpy() - jef[path]) > quantum / 3)
    for key in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(tmet[key]), float(jmet[key]),
                                   rtol=1e-5, atol=0)
    assert int(tstate["step"]) == int(jstate["step"]) == n_steps
    assert tstate["step"].dtype == torch.int32
    for tree in ("m", "v"):
        _close_leaves(tstate[tree], jstate[tree], flipped)
    _close_leaves(tparams, jparams, flipped)


def _close_leaves(ttree, jtree, flipped):
    jnamed = _named(_np_tree(jtree))
    tnamed = _named(ttree)
    assert jnamed.keys() == tnamed.keys()
    for path, t in tnamed.items():
        keep = ~flipped.get(path, np.zeros(t.shape, bool))
        np.testing.assert_allclose(t.numpy()[keep], jnamed[path][keep],
                                   atol=1e-6, rtol=1e-5, err_msg=path)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "rwkv6-1.6b",
                                  "jamba-1.5-large-398b",
                                  "granite-moe-1b-a400m"])
def test_decay_mask_matches_jax(arch):
    """The port's paths through its own tree decay exactly where the
    reference's paths through its tree do (norms, biases, A_log, D, mu_,
    w0 and u exempt)."""
    jcfg = _f32(jax_get_arch(arch).smoke)
    jp = jax.eval_shape(lambda: japi.init_params(jax.random.key(0), jcfg))
    jmask = {}

    def walk(tree, prefix=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f"{prefix}/{k}")
        else:
            jmask[prefix] = jadamw._decay_mask(prefix)

    walk(jp)
    tcfg = _f32(tconfig.get_arch(arch).smoke)
    tp = tapi.init_params(torch.Generator().manual_seed(0), tcfg)
    tmask = {path: tadamw._decay_mask(path)
             for path, _ in tadamw.named_leaves(tp)}
    assert tmask == jmask
    assert 0.0 in tmask.values() and 1.0 in tmask.values()


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "minitron-8b",
                                  "rwkv6-1.6b", "jamba-1.5-large-398b",
                                  "granite-moe-1b-a400m", "internvl2-2b",
                                  "seamless-m4t-large-v2"])
def test_param_count_matches_jax(arch):
    j, t = jax_get_arch(arch), tconfig.get_arch(arch)
    for jc, tc in ((j.smoke, t.smoke), (j.model, t.model)):
        for active in (False, True):
            assert tapi.param_count(tc, active) == \
                japi.param_count(jc, active)


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("compression", ["none", "int8_ef"])
def test_train_step_matches_jax(compression):
    """One step from the same params and batch: params, m, v and every
    metric."""
    p = Pair("qwen1.5-0.5b")
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10,
              grad_compression=compression)
    jcfg, tcfg = jconfig.OptimizerConfig(**kw), tconfig.OptimizerConfig(**kw)
    toks = _tokens(p.jcfg, seed=7)
    jstep = jax.jit(jsteps.make_train_step(p.jcfg, jcfg, remat="none"))
    jparams, jstate, jmet = jstep(p.jp, jadamw.init_opt_state(p.jp, jcfg),
                                  {"tokens": jnp.asarray(toks)})
    tparams = p.tparams()
    tstep = tsteps.make_train_step(p.tcfg, tcfg, remat="none")
    out_params, tstate, tmet = tstep(
        tparams, tadamw.init_opt_state(tparams, tcfg),
        {"tokens": torch.from_numpy(toks)})
    assert out_params is tparams                      # updated in place
    assert not any(t.requires_grad for t in tadamw.leaves(tparams))
    assert set(tmet) == set(jmet)
    for key in jmet:
        np.testing.assert_allclose(float(tmet[key]), float(jmet[key]), **TOL)
    for tree, jtree in ((tparams, jparams), (tstate["m"], jstate["m"]),
                        (tstate["v"], jstate["v"])):
        jnamed = _named(_np_tree(jtree))
        for path, t in _named(tree).items():
            np.testing.assert_allclose(t.numpy(), jnamed[path], **TOL,
                                       err_msg=path)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "jamba-1.5-large-398b",
                                  "deepseek-v2-236b"])
def test_remat_modes_give_equal_grads(arch):
    cfg = _f32(tconfig.get_arch(arch).smoke)
    params = tapi.init_params(torch.Generator().manual_seed(3), cfg)
    batch = {"tokens": torch.from_numpy(_tokens(cfg, seed=8))}
    results = {remat: _torch_loss_and_grads(cfg, params, batch, remat)
               for remat in ("none", "dots", "full")}
    loss0, _, grads0 = results["none"]
    for remat in ("dots", "full"):
        loss, _, grads = results[remat]
        np.testing.assert_allclose(float(loss), float(loss0), atol=1e-6,
                                   rtol=0)
        for path, g in grads.items():
            np.testing.assert_allclose(g.numpy(), grads0[path].numpy(),
                                       atol=1e-6, rtol=0, err_msg=path)
    with pytest.raises(ValueError, match="remat"):
        _torch_loss_and_grads(cfg, params, batch, "everything")
