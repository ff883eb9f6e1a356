"""Port parity for the VLM prefix: internvl2's smoke config (a decoder with
precomputed patch embeddings ahead of its tokens) against the JAX package.

The JAX params are converted key for key; tokens and patch embeddings come
from seeded NumPy; each JAX function compiles once per module.  Forward,
loss (over the text positions only), prefill over prefix and prompt, decode
from the grown prefill cache, one train step and the server's greedy
tokens (text-only, as the reference serves a VLM) agree with JAX.
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
from repro_torch.launch import train as ttrain
from repro_torch.models import api as tapi
from repro_torch.models import lm as tlm
from repro_torch.optim import adamw as tadamw
from test_torch_serve import _assert_greedy_streams_match

ARCH = "internvl2-2b"
ATOL = 1e-4          # the reference's own bound is 2e-3 (test_models.py)
TOL = dict(atol=2e-3, rtol=2e-3)
B, T, MAX_LEN, N_DECODE = 2, 12, 28, 4


def _f32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32",
                               compute_dtype="float32")


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _close(jax_out, torch_out, atol=ATOL):
    np.testing.assert_allclose(torch_out.detach().numpy(), np.asarray(jax_out),
                               atol=atol, rtol=0)


class Pair:
    """internvl2's smoke config in JAX (jitted once) and in the port."""

    def __init__(self):
        self.jcfg = _f32(jax_get_arch(ARCH).smoke)
        self.tcfg = _f32(tconfig.get_arch(ARCH).smoke)
        self.jp = japi.init_params(jax.random.key(1), self.jcfg)
        self.tp = params_from_jax(_np_tree(self.jp), "cpu")
        cfg = self.jcfg
        self.j_forward = jax.jit(lambda p, b: japi.forward(
            p, cfg, b, mode="train", remat="none")[0])
        self.j_loss = jax.jit(lambda p, b: japi.loss_fn(p, cfg, b,
                                                        remat="none"))
        self.j_prefill = jax.jit(lambda p, b: japi.prefill(p, cfg, b))
        self.j_decode = jax.jit(lambda p, s, t, pos: japi.decode_step(
            p, cfg, s, t, pos))
        rng = np.random.default_rng(0)
        self.npre = cfg.frontend.num_prefix
        self.tokens = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
        self.prefix = rng.normal(size=(B, self.npre, cfg.d_model)
                                 ).astype(np.float32)
        self.more = rng.integers(0, cfg.vocab_size,
                                 (B, N_DECODE)).astype(np.int32)

    def batches(self, prefix=True):
        j = {"tokens": jnp.asarray(self.tokens)}
        t = {"tokens": torch.from_numpy(self.tokens)}
        if prefix:
            j["prefix_embeds"] = jnp.asarray(self.prefix)
            t["prefix_embeds"] = torch.from_numpy(self.prefix)
        return j, t


@pytest.fixture(scope="module")
def pair():
    return Pair()


def test_config_is_a_vlm_with_a_patch_frontend(pair):
    assert pair.tcfg.family == "vlm"
    assert dataclasses.asdict(pair.tcfg.frontend) == \
        dataclasses.asdict(pair.jcfg.frontend)
    full = tconfig.get_arch(ARCH).model
    assert (full.frontend.kind, full.frontend.num_prefix) == ("patch", 1024)
    assert tapi.param_count(full) == japi.param_count(jax_get_arch(ARCH).model)


@pytest.mark.parametrize("prefix", [False, True])
def test_embed_inputs_match_jax(pair, prefix):
    """The prefix goes ahead of the token embeddings, cast to the compute
    dtype; a text-only batch stays text-only."""
    jb, tb = pair.batches(prefix)
    want = jax.jit(lambda p, b: jlm._embed_inputs(p, pair.jcfg, b))(pair.jp,
                                                                     jb)
    got = tlm._embed_inputs(pair.tp, pair.tcfg, tb)
    assert got.shape == (B, T + prefix * pair.npre, pair.tcfg.d_model)
    _close(want, got, atol=0)


@pytest.mark.parametrize("prefix", [False, True])
def test_forward_matches_jax(pair, prefix):
    jb, tb = pair.batches(prefix)
    got, aux = tapi.forward(pair.tp, pair.tcfg, tb)
    assert got.shape == (B, T + prefix * pair.npre, pair.tcfg.vocab_size)
    assert float(aux) == 0.0
    _close(pair.j_forward(pair.jp, jb), got)


@pytest.mark.parametrize("prefix", [False, True])
def test_loss_drops_the_prefix_positions_as_jax_does(pair, prefix):
    jb, tb = pair.batches(prefix)
    jloss, jmet = pair.j_loss(pair.jp, jb)
    loss, met = tapi.loss_fn(pair.tp, pair.tcfg, tb, remat="none")
    np.testing.assert_allclose(float(loss), float(jloss), atol=ATOL, rtol=0)
    for key in ("loss", "aux", "total"):
        np.testing.assert_allclose(float(met[key]), float(jmet[key]),
                                   atol=ATOL, rtol=0)
    # the loss is the text's: the prefix positions' logits are not scored
    logits, _ = tapi.forward(pair.tp, pair.tcfg, tb, remat="none")
    text = logits[:, logits.shape[1] - T:]
    logp = torch.log_softmax(text[:, :-1], dim=-1)
    want = -torch.gather(logp, -1, tb["tokens"][:, 1:, None].long()).mean()
    np.testing.assert_allclose(float(loss), float(want), atol=ATOL, rtol=0)


def test_prefill_matches_jax_and_forward(pair):
    jb, tb = pair.batches()
    jlast, jcache = pair.j_prefill(pair.jp, jb)
    last, cache = tapi.prefill(pair.tp, pair.tcfg, tb)
    _close(jlast, last)
    jleaves = jax.tree_util.tree_leaves_with_path(_np_tree(jcache))
    tleaves = jax.tree_util.tree_leaves_with_path(cache)
    assert [p for p, _ in jleaves] == [p for p, _ in tleaves]
    a = pair.tcfg.attention
    for (_, want), (_, got) in zip(jleaves, tleaves):
        assert got.shape == (pair.tcfg.num_layers, B, a.num_kv_heads,
                             pair.npre + T, a.head_dim)
        _close(want, got)
    full, _ = tapi.forward(pair.tp, pair.tcfg, tb, remat="none")
    torch.testing.assert_close(last[:, 0], full[:, -1], **TOL)


def _grow_jax(state, length):
    """JAX's prefill cache of S positions in one of ``length`` (axis 3 of
    each (layers, B, Hkv, S, hd) leaf), zeros behind it."""
    return jax.tree.map(lambda a: jnp.pad(
        a, [(0, 0)] * 3 + [(0, length - a.shape[3]), (0, 0)]), state)


def test_decode_after_a_prefix_prefill_matches_jax_and_forward(pair):
    """Prefill over prefix and prompt, the cache grown to MAX_LEN, then four
    decode steps: logits and the whole cache agree with JAX at every step,
    and each step's logits with one forward over the whole sequence."""
    jb, tb = pair.batches()
    _, jcache = pair.j_prefill(pair.jp, jb)
    _, cache = tapi.prefill(pair.tp, pair.tcfg, tb)
    jstate = _grow_jax(jcache, MAX_LEN)
    state = tapi.grow_decode_state(pair.tcfg, cache, MAX_LEN)
    jax.tree.map(lambda w, g: _close(w, g), _np_tree(jstate), state)
    start = pair.npre + T
    seen = []
    for i in range(N_DECODE):
        toks = pair.more[:, i]
        pos = np.full((B,), start + i, np.int32)
        jl, jstate = pair.j_decode(pair.jp, jstate, jnp.asarray(toks),
                                   jnp.asarray(pos))
        tl, state2 = tapi.decode_step(pair.tp, pair.tcfg, state,
                                      torch.from_numpy(toks),
                                      torch.from_numpy(pos))
        assert state2 is state                        # written in place
        _close(jl, tl)
        seen.append(tl)
    jax.tree.map(lambda w, g: _close(w, g), _np_tree(jstate), state)
    whole = {"tokens": torch.from_numpy(np.concatenate([pair.tokens,
                                                        pair.more], 1)),
             "prefix_embeds": tb["prefix_embeds"]}
    full, _ = tapi.forward(pair.tp, pair.tcfg, whole, remat="none")
    for i, tl in enumerate(seen):
        torch.testing.assert_close(tl, full[:, start + i], **TOL)


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_input_specs_match_jax(shape):
    """The prefix takes min(num_prefix, S // 2) positions and the tokens
    the rest; decode is text against a cache of S."""
    for get, api, cell in ((jax_get_arch, japi, jconfig.LM_SHAPES),
                           (tconfig.get_arch, tapi, tconfig.LM_SHAPES)):
        specs = api.input_specs(get(ARCH).model, cell[shape])
        got = jax.tree_util.tree_leaves_with_path(
            specs, is_leaf=lambda x: hasattr(x, "shape"))
        if api is japi:
            want = [(p, tuple(s.shape), s.dtype.name) for p, s in got]
        else:
            assert [(p, tuple(s.shape), str(s.dtype).removeprefix("torch."))
                    for p, s in got] == want
    if shape == "train_4k":
        s = tapi.input_specs(tconfig.get_arch(ARCH).model,
                             tconfig.LM_SHAPES[shape])
        assert s["prefix_embeds"].shape[1:] == (1024, 2048)
        assert s["tokens"].shape[1] == 4096 - 1024


def test_model_flops_match_jax():
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        assert tapi.model_flops(tconfig.get_arch(ARCH).model,
                                tconfig.LM_SHAPES[shape]) == \
            japi.model_flops(jax_get_arch(ARCH).model,
                             jconfig.LM_SHAPES[shape])


def _named(tree):
    return dict(tadamw.named_leaves(tree))


def test_train_step_matches_jax(pair):
    """One step from the same params and a batch with a prefix: the
    metrics, the params after it, ``m`` and ``v``; and the gradient (``m``
    is (1 - b1) times it) leaf by leaf to 2e-3 of its largest value."""
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    jopt, topt = jconfig.OptimizerConfig(**kw), tconfig.OptimizerConfig(**kw)
    jb, tb = pair.batches()
    jstep = jax.jit(jsteps.make_train_step(pair.jcfg, jopt, remat="none"))
    jparams, jstate, jmet = jstep(pair.jp, jadamw.init_opt_state(pair.jp,
                                                                  jopt), jb)
    tparams = params_from_jax(_np_tree(pair.jp), "cpu")
    tstep = tsteps.make_train_step(pair.tcfg, topt, remat="none")
    out, tstate, tmet = tstep(tparams, tadamw.init_opt_state(tparams, topt),
                              tb)
    assert out is tparams and set(tmet) == set(jmet)
    for key in jmet:
        np.testing.assert_allclose(float(tmet[key]), float(jmet[key]), **TOL)
    for tree, jtree in ((tparams, jparams), (tstate["m"], jstate["m"]),
                        (tstate["v"], jstate["v"])):
        jnamed = _named(_np_tree(jtree))
        for path, t in _named(tree).items():
            np.testing.assert_allclose(t.numpy(), jnamed[path], **TOL,
                                       err_msg=path)
    jm = _named(_np_tree(jstate["m"]))
    for path, m in _named(tstate["m"]).items():
        scale = np.abs(jm[path]).max()
        assert np.abs(m.numpy() - jm[path]).max() <= 2e-3 * scale, path


@pytest.mark.parametrize("remat", ["dots", "full"])
def test_remat_modes_give_equal_grads(pair, remat):
    _, tb = pair.batches()
    results = {}
    for mode in ("none", remat):
        named = tadamw.named_leaves(pair.tp)
        alias = {p: t.detach().requires_grad_() for p, t in named}
        loss, _ = tapi.loss_fn(tadamw.tree_like(pair.tp, alias), pair.tcfg,
                               tb, remat=mode)
        grads = torch.autograd.grad(loss, [alias[p] for p, _ in named])
        results[mode] = (float(loss.detach()), grads)
    (l0, g0), (l1, g1) = results["none"], results[remat]
    assert abs(l0 - l1) <= 1e-6
    for a, b in zip(g0, g1):
        torch.testing.assert_close(b, a, atol=1e-6, rtol=0)


def test_train_main_runs_the_smoke_config(tmp_path, capsys):
    losses = ttrain.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                          "--steps", "2", "--batch", "2", "--seq", "16",
                          "--ckpt-dir", str(tmp_path), "--log-every", "1"])
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert "arch=internvl2-smoke" in capsys.readouterr().out


def test_model_batch_puts_a_prefix_ahead_of_every_token():
    cfg = tconfig.get_arch(ARCH).smoke
    tokens = torch.zeros((3, 10), dtype=torch.int32)
    batch = ttrain.model_batch(cfg, {"tokens": tokens},
                               torch.Generator().manual_seed(0))
    assert batch["tokens"] is tokens
    assert batch["prefix_embeds"].shape == (3, 5, cfg.d_model)   # seq // 2
    assert batch["prefix_embeds"].std() > 0.5


def test_greedy_tokens_match_the_jax_server():
    """The server serves a VLM text-only, token by token, as the
    reference's: the same greedy tokens, events and slot positions."""
    _assert_greedy_streams_match(_f32(jax_get_arch(ARCH).smoke),
                                 _f32(tconfig.get_arch(ARCH).smoke))
