"""Port parity for the encoder-decoder: seamless-m4t's smoke config
(``repro_torch.models.encdec``) against ``repro.models.encdec``.

The JAX params are converted key for key; frames and tokens come from
seeded NumPy; each JAX function compiles once per module.  Cross K/V and
cross-attention, the encoder, forward, loss, prefill, decode from JAX's
prefill state grown to MAX_LEN, the decode state's spec, input specs, model
FLOPs and one train step agree with JAX; decode reproduces the forward.
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
from repro.models import encdec as jed
from repro.optim import adamw as jadamw
from repro_torch.convert import params_from_jax
from repro_torch.core import config as tconfig
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import api as tapi
from repro_torch.models import encdec as ted
from repro_torch.optim import adamw as tadamw

ARCH = "seamless-m4t-large-v2"
ATOL = 1e-4          # the reference's own bound is 2e-3 (test_models.py)
TOL = dict(atol=2e-3, rtol=2e-3)
B, S_ENC, T, MAX_LEN, N_DECODE = 2, 10, 6, 16, 4


def _f32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32",
                               compute_dtype="float32")


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _close(jax_out, torch_out, atol=ATOL):
    np.testing.assert_allclose(torch_out.detach().numpy(), np.asarray(jax_out),
                               atol=atol, rtol=0)


def _tree_close(jax_tree, torch_tree, atol=ATOL):
    jleaves = jax.tree_util.tree_leaves_with_path(_np_tree(jax_tree))
    tleaves = jax.tree_util.tree_leaves_with_path(torch_tree)
    assert [p for p, _ in jleaves] == [p for p, _ in tleaves]
    for (path, want), (_, got) in zip(jleaves, tleaves):
        assert tuple(got.shape) == want.shape, path
        _close(want, got, atol)


class Pair:
    """seamless's smoke config in JAX (jitted once) and in the port."""

    def __init__(self):
        self.jcfg = _f32(jax_get_arch(ARCH).smoke)
        self.tcfg = _f32(tconfig.get_arch(ARCH).smoke)
        self.jp = japi.init_params(jax.random.key(1), self.jcfg)
        self.tp = params_from_jax(_np_tree(self.jp), "cpu")
        cfg = self.jcfg
        self.j_encode = jax.jit(lambda p, f: jed.encode(p, cfg, f,
                                                        remat="none"))
        self.j_forward = jax.jit(lambda p, b: japi.forward(
            p, cfg, b, mode="train", remat="none")[0])
        self.j_loss = jax.jit(lambda p, b: japi.loss_fn(p, cfg, b,
                                                        remat="none"))
        self.j_prefill = jax.jit(lambda p, b: japi.prefill(p, cfg, b))
        self.j_decode = jax.jit(lambda p, s, t, pos: japi.decode_step(
            p, cfg, s, t, pos))
        rng = np.random.default_rng(0)
        self.frames = rng.normal(size=(B, S_ENC, cfg.d_model)
                                 ).astype(np.float32)
        self.tokens = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
        self.more = rng.integers(0, cfg.vocab_size,
                                 (B, N_DECODE)).astype(np.int32)

    def batches(self, tokens=None):
        tokens = self.tokens if tokens is None else tokens
        return ({"frames": jnp.asarray(self.frames),
                 "tokens": jnp.asarray(tokens)},
                {"frames": torch.from_numpy(self.frames),
                 "tokens": torch.from_numpy(tokens)})


@pytest.fixture(scope="module")
def pair():
    return Pair()


def test_params_convert_key_for_key(pair):
    """encoder and decoder stacked on a layer axis, each decoder block with
    its cross-attention; shapes and dtypes as JAX's, and the port's own
    init builds the same tree."""
    jleaves = jax.tree_util.tree_leaves_with_path(pair.jp)
    tleaves = jax.tree_util.tree_leaves_with_path(pair.tp)
    assert [p for p, _ in jleaves] == [p for p, _ in tleaves]
    for (_, a), (_, b) in zip(jleaves, tleaves):
        assert tuple(a.shape) == tuple(b.shape) and b.dtype == torch.float32
    cross = pair.tp["decoder"]["cross"]
    assert sorted(cross) == ["norm", "wk", "wo", "wq", "wv"]
    assert cross["wq"]["w"].shape[0] == pair.tcfg.num_layers
    assert pair.tp["encoder"]["attn"]["wq"]["w"].shape[0] == \
        pair.tcfg.encoder_layers
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(pair.tcfg, param_dtype=dtype)
        own = tapi.init_params(torch.Generator().manual_seed(0), cfg)
        oleaves = jax.tree_util.tree_leaves_with_path(own)
        assert [p for p, _ in oleaves] == [p for p, _ in tleaves]
        assert [tuple(t.shape) for _, t in oleaves] == \
            [tuple(t.shape) for _, t in tleaves]
        assert {t.dtype for _, t in oleaves} == {getattr(torch, dtype)}
    for get, api in ((jax_get_arch, japi), (tconfig.get_arch, tapi)):
        assert api.param_count(get(ARCH).smoke) == \
            japi.param_count(jax_get_arch(ARCH).smoke)
    assert tapi.param_count(tconfig.get_arch(ARCH).model) == \
        japi.param_count(jax_get_arch(ARCH).model)


def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree)


def test_cross_kv_and_cross_apply_match_jax(pair):
    """No RoPE on the cross path; K and V come out (B, Hkv, S_enc, hd),
    contiguous."""
    jblk = _layer0(pair.jp["decoder"]["cross"])
    tblk = {k: {kk: t[0] for kk, t in v.items()}
            for k, v in pair.tp["decoder"]["cross"].items()}
    rng = np.random.default_rng(3)
    enc = rng.normal(size=(B, S_ENC, pair.tcfg.d_model)).astype(np.float32)
    x = rng.normal(size=(B, T, pair.tcfg.d_model)).astype(np.float32)
    jk, jv = jax.jit(lambda p, e: jed.cross_kv(p, e, pair.jcfg))(
        jblk, jnp.asarray(enc))
    tk, tv = ted.cross_kv(tblk, torch.from_numpy(enc), pair.tcfg)
    assert tk.is_contiguous() and tv.is_contiguous()
    _close(jk, tk)
    _close(jv, tv)
    want = jax.jit(lambda p, x_, k, v: jed._cross_apply(
        p, x_, (k, v), pair.jcfg))(jblk, jnp.asarray(x), jk, jv)
    _close(want, ted._cross_apply(tblk, torch.from_numpy(x), (tk, tv),
                                  pair.tcfg))
    # one query per row through decode_attention, every key visible
    want1 = jax.jit(lambda p, x_, k, v: jed._cross_apply(
        p, x_, (k, v), pair.jcfg))(jblk, jnp.asarray(x[:, :1]), jk, jv)
    kv_len = torch.full((B,), S_ENC, dtype=torch.int32)
    _close(want1, ted._cross_apply(tblk, torch.from_numpy(x[:, :1]),
                                   (tk, tv), pair.tcfg, kv_len))


def test_encode_matches_jax(pair):
    got = ted.encode(pair.tp, pair.tcfg, torch.from_numpy(pair.frames),
                     remat="none")
    assert got.shape == (B, S_ENC, pair.tcfg.d_model)
    _close(pair.j_encode(pair.jp, jnp.asarray(pair.frames)), got)


def test_forward_and_loss_match_jax(pair):
    jb, tb = pair.batches()
    got, aux = tapi.forward(pair.tp, pair.tcfg, tb)
    assert got.shape == (B, T, pair.tcfg.vocab_size) and float(aux) == 0.0
    _close(pair.j_forward(pair.jp, jb), got)
    jloss, jmet = pair.j_loss(pair.jp, jb)
    loss, met = tapi.loss_fn(pair.tp, pair.tcfg, tb)
    np.testing.assert_allclose(float(loss), float(jloss), atol=ATOL, rtol=0)
    for key in ("loss", "aux", "total"):
        np.testing.assert_allclose(float(met[key]), float(jmet[key]),
                                   atol=ATOL, rtol=0)


def test_prefill_matches_jax(pair):
    jb, tb = pair.batches()
    jlast, jstate = pair.j_prefill(pair.jp, jb)
    last, state = tapi.prefill(pair.tp, pair.tcfg, tb)
    assert last.shape == (B, pair.tcfg.vocab_size)
    _close(jlast, last)
    _tree_close(jstate, state)
    a = pair.tcfg.attention
    assert state["self"]["k"].shape == (pair.tcfg.num_layers, B,
                                        a.num_kv_heads, T, a.head_dim)
    assert state["cross_k"].shape == (pair.tcfg.num_layers, B,
                                      a.num_kv_heads, S_ENC, a.head_dim)
    assert state["cross_k"].is_contiguous()


def _grow_jax(state, length):
    """JAX's prefill state with its self cache of S positions in one of
    ``length`` (zeros behind it); the cross cache as it is."""
    pad = lambda a: jnp.pad(a, [(0, 0)] * 3 + [(0, length - a.shape[3]),
                                               (0, 0)])
    return {**state, "self": jax.tree.map(pad, state["self"])}


@pytest.mark.parametrize("per_row", [False, True])
def test_decode_steps_from_the_grown_prefill_state_match_jax(pair, per_row):
    """Four decode steps from JAX's prefill state grown to MAX_LEN (the
    port's from its own, grown by ``grow_decode_state``): logits at every
    step and the whole state after them; the self cache is written in
    place."""
    jb, tb = pair.batches()
    _, jstate = pair.j_prefill(pair.jp, jb)
    _, tstate = tapi.prefill(pair.tp, pair.tcfg, tb)
    jstate = _grow_jax(jstate, MAX_LEN)
    tstate = tapi.grow_decode_state(pair.tcfg, tstate, MAX_LEN)
    _tree_close(jstate, tstate)
    for i in range(N_DECODE):
        toks = pair.more[:, i]
        pos = np.full((B,), T + i, np.int32) if per_row else np.int32(T + i)
        jl, jstate = pair.j_decode(pair.jp, jstate, jnp.asarray(toks),
                                   jnp.asarray(pos))
        tl, out = tapi.decode_step(pair.tp, pair.tcfg, tstate,
                                   torch.from_numpy(toks),
                                   torch.as_tensor(pos))
        assert out is tstate
        _close(jl, tl)
    _tree_close(jstate, tstate)


def test_decode_matches_forward(pair):
    """Prefill of the first token, then token-by-token decode, reproduces
    the full forward's logits (test_models.py's bound, 2e-3)."""
    toks = np.concatenate([pair.tokens, pair.more], axis=1)
    _, tb = pair.batches(toks)
    full, _ = tapi.forward(pair.tp, pair.tcfg, tb, remat="none")
    last, state = tapi.prefill(pair.tp, pair.tcfg,
                               {**tb, "tokens": tb["tokens"][:, :1]})
    torch.testing.assert_close(last, full[:, 0], **TOL)
    state = tapi.grow_decode_state(pair.tcfg, state, toks.shape[1])
    for t in range(1, toks.shape[1]):
        logits, state = tapi.decode_step(
            pair.tp, pair.tcfg, state, tb["tokens"][:, t],
            torch.tensor(t, dtype=torch.int32))
        torch.testing.assert_close(logits, full[:, t], **TOL)


def _spec_list(tree):
    leaves = jax.tree_util.tree_leaves_with_path(
        tree, is_leaf=lambda x: hasattr(x, "shape"))
    return [(p, tuple(s.shape),
             s.dtype.name if hasattr(s.dtype, "name")
             else str(s.dtype).removeprefix("torch.")) for p, s in leaves]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_decode_state_matches_jax(dtype):
    """The cross cache is sized at max_len too, as in the reference."""
    jcfg, tcfg = (dataclasses.replace(get(ARCH).smoke, compute_dtype=dtype)
                  for get in (jax_get_arch, tconfig.get_arch))
    assert _spec_list(tapi.init_decode_state(tcfg, 3, 20)) == \
        _spec_list(japi.init_decode_state(jcfg, 3, 20))
    state = tapi.allocate_decode_state(tcfg, 3, 20, "cpu")
    assert _spec_list(state) == _spec_list(japi.init_decode_state(jcfg, 3, 20))
    assert all(not t.any() for t in jax.tree.leaves(state))


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_input_specs_and_model_flops_match_jax(shape):
    """S // 2 frames and S // 2 tokens, a decode state of S // 2, and the
    FLOPs of N * S / 2 tokens."""
    jcfg, tcfg = jax_get_arch(ARCH).model, tconfig.get_arch(ARCH).model
    jcell, tcell = jconfig.LM_SHAPES[shape], tconfig.LM_SHAPES[shape]
    assert _spec_list(tapi.input_specs(tcfg, tcell)) == \
        _spec_list(japi.input_specs(jcfg, jcell))
    assert tapi.model_flops(tcfg, tcell) == japi.model_flops(jcfg, jcell)


def _named(tree):
    return dict(tadamw.named_leaves(tree))


def test_train_step_matches_jax(pair):
    """One step from the same params and batch: the metrics, the params
    after it, ``m`` and ``v``; and the gradient (``m`` is (1 - b1) times
    it) leaf by leaf to 2e-3 of its largest value."""
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
    assert "arch=seamless-smoke" in capsys.readouterr().out


def test_model_batch_halves_the_sequence():
    cfg = tconfig.get_arch(ARCH).smoke
    tokens = torch.arange(30, dtype=torch.int32).reshape(3, 10)
    batch = ttrain.model_batch(cfg, {"tokens": tokens},
                               torch.Generator().manual_seed(0))
    assert sorted(batch) == ["frames", "tokens"]
    assert batch["frames"].shape == (3, 5, cfg.d_model)
    assert torch.equal(batch["tokens"], tokens[:, :5])


def test_serve_main_refuses_the_enc_dec():
    """The server targets decoder-only models, as the reference's does."""
    with pytest.raises(SystemExit, match="decoder-only"):
        tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu"])
