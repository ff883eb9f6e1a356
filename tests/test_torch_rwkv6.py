"""Port parity for the RWKV-6 model path: repro_torch.models.rwkv6 and the
rwkv6 stack against repro.models.

The JAX params of the rwkv6 smoke config (f32) are converted key for key;
the token shift, the data-dependent lerp, the time mix in train, prefill and
decode mode, the channel mix, ``forward``, ``prefill`` with its whole cache
and ragged ``decode_step`` with its whole state agree with JAX to atol 1e-4
(the reference's own bound is 2e-3, ``tests/test_models.py``).  The sequence
WKV runs through the ``rwkv6_scan`` op's plain version here; the JAX model
runs its chunked twin.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.config import get_arch as jax_get_arch
from repro.models import api as japi
from repro.models import rwkv6 as JR6
from repro_torch.convert import params_from_jax
from repro_torch.core import config as tconfig
from repro_torch.kernels.rwkv6_scan import ops as kops
from repro_torch.models import api as tapi
from repro_torch.models import rwkv6 as TR6
from repro_torch.models.attention import TensorSpec

ARCH = "rwkv6-1.6b"
ATOL = 1e-4
B, T, MAX_LEN = 2, 12, 16

# jitted: eager JAX init of the smoke stack takes twice as long
_init = jax.jit(japi.init_params, static_argnums=1)


def _f32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32",
                               compute_dtype="float32")


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _close(jax_out, torch_out, atol=ATOL):
    np.testing.assert_allclose(torch_out.numpy(), np.asarray(jax_out),
                               atol=atol, rtol=0)


def _tree_close(jax_tree, torch_tree):
    jleaves = jax.tree_util.tree_leaves_with_path(_np_tree(jax_tree))
    tleaves = jax.tree_util.tree_leaves_with_path(torch_tree)
    assert [p for p, _ in jleaves] == [p for p, _ in tleaves]
    for (_, a), (_, b) in zip(jleaves, tleaves):
        assert b.dtype == torch.float32
        _close(a, b)


class Pair:
    """The smoke config's JAX reference (jitted once) and its port twin."""

    def __init__(self):
        self.jcfg = _f32(jax_get_arch(ARCH).smoke)
        self.tcfg = _f32(tconfig.get_arch(ARCH).smoke)
        self.jp = _init(jax.random.key(1), self.jcfg)
        self.tp = params_from_jax(_np_tree(self.jp), "cpu")
        cfg = self.jcfg
        self.j_forward = jax.jit(lambda p, t: japi.forward(
            p, cfg, {"tokens": t}, mode="train", remat="none")[0])
        self.j_prefill = jax.jit(lambda p, t: japi.prefill(
            p, cfg, {"tokens": t}))
        self.j_decode = jax.jit(lambda p, s, t, pos: japi.decode_step(
            p, cfg, s, t, pos))
        self.tokens = np.random.default_rng(0).integers(
            0, cfg.vocab_size, (B, T)).astype(np.int32)
        # layer 0's time-mix and channel-mix params, both frameworks
        sub = lambda p: jax.tree.map(lambda a: a[0],  # noqa: E731
                                     p["stack"]["periods"]["sub0"])
        self.jl = sub(self.jp)
        self.tl = params_from_jax(_np_tree(self.jl), "cpu")
        rng = np.random.default_rng(7)
        D = cfg.d_model
        H, hd = JR6.num_heads_of(cfg), cfg.rwkv.head_dim
        self.x = rng.standard_normal((B, T, D)).astype(np.float32)
        self.x1 = self.x[:, :1]
        self.state = {"shift_t": rng.standard_normal((B, D)),
                      "shift_c": rng.standard_normal((B, D)),
                      "wkv": rng.standard_normal((B, H, hd, hd)) * 0.1}
        self.state = {k: v.astype(np.float32) for k, v in self.state.items()}


@pytest.fixture(scope="module")
def pair():
    return Pair()


def _tstate(pair):
    return {k: torch.from_numpy(v.copy()) for k, v in pair.state.items()}


def test_arch_is_ported_and_config_copied():
    j, t = jax_get_arch(ARCH), tconfig.get_arch(ARCH)
    for jc, tc in ((j.model, t.model), (j.smoke, t.smoke)):
        assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
        assert isinstance(tc.rwkv, tconfig.RWKVConfig)
        assert tc.layer_kinds() == ["rwkv"] * tc.num_layers
    assert (j.shapes, j.skip_shapes, j.source) == \
        (t.shapes, t.skip_shapes, t.source)


@pytest.mark.parametrize("with_prev", [False, True])
@pytest.mark.parametrize("S", [1, T])
def test_token_shift_matches_jax(pair, with_prev, S):
    x = pair.x[:, :S]
    prev = pair.state["shift_t"] if with_prev else None
    want = JR6._token_shift(jnp.asarray(x),
                            None if prev is None else jnp.asarray(prev))
    got = TR6._token_shift(torch.from_numpy(x),
                           None if prev is None else torch.from_numpy(prev))
    _close(want, got, 0.0)


def test_ddlerp_matches_jax(pair):
    xx = np.roll(pair.x, 1, axis=1) - pair.x
    p = pair.jl["rwkv_tm"]
    want = jax.jit(lambda p, x, xx: JR6._ddlerp(p, x, xx, jnp.float32))(
        p, jnp.asarray(pair.x), jnp.asarray(xx))
    got = TR6._ddlerp(pair.tl["rwkv_tm"], torch.from_numpy(pair.x),
                      torch.from_numpy(xx), torch.float32)
    assert list(got) == list(JR6.STREAMS)
    for s in JR6.STREAMS:
        _close(want[s], got[s])


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_time_mix_matches_jax(pair, mode):
    x = pair.x1 if mode == "decode" else pair.x
    jcache = {k: jnp.asarray(pair.state[k]) for k in ("shift_t", "wkv")} \
        if mode == "decode" else None
    tcache = _tstate(pair) if mode == "decode" else None
    cfg = pair.jcfg
    jy, jc = jax.jit(lambda p, x, c: JR6.apply_time_mix(
        p, x, cfg, mode=mode, cache=c))(pair.jl["rwkv_tm"], jnp.asarray(x),
                                         jcache)
    calls = kops.ref.calls
    ty, tc = TR6.apply_time_mix(pair.tl["rwkv_tm"], torch.from_numpy(x),
                                pair.tcfg, mode=mode, cache=tcache)
    # the sequence goes through the scan op (here its plain version); one
    # decode token takes the closed form
    assert kops.ref.calls == calls + (mode != "decode")
    _close(jy, ty)
    if mode == "train":
        assert jc is None and tc is None
        return
    assert set(tc) == set(jc) == {"shift_t", "wkv"}
    for k in jc:
        _close(jc[k], tc[k])
    if mode == "decode":      # written into the cache in place
        assert all(tc[k] is tcache[k] for k in tc)


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_channel_mix_matches_jax(pair, mode):
    x = pair.x1 if mode == "decode" else pair.x
    jcache = {"shift_c": jnp.asarray(pair.state["shift_c"])} \
        if mode == "decode" else None
    tcache = _tstate(pair) if mode == "decode" else None
    cfg = pair.jcfg
    jy, jc = jax.jit(lambda p, x, c: JR6.apply_channel_mix(
        p, x, cfg, mode=mode, cache=c))(pair.jl["rwkv_cm"], jnp.asarray(x),
                                         jcache)
    ty, tc = TR6.apply_channel_mix(pair.tl["rwkv_cm"], torch.from_numpy(x),
                                   pair.tcfg, mode=mode, cache=tcache)
    _close(jy, ty)
    if mode == "train":
        assert jc is None and tc is None
        return
    _close(jc["shift_c"], tc["shift_c"])
    if mode == "decode":
        assert tc["shift_c"] is tcache["shift_c"]


def test_forward_matches_jax(pair):
    want = pair.j_forward(pair.jp, jnp.asarray(pair.tokens))
    calls = kops.ref.calls
    got, aux = tapi.forward(pair.tp, pair.tcfg,
                            {"tokens": torch.from_numpy(pair.tokens)})
    assert kops.ref.calls == calls + pair.tcfg.num_layers
    assert got.shape == (B, T, pair.tcfg.vocab_size) and float(aux) == 0.0
    _close(want, got)


def test_prefill_matches_jax_with_its_whole_cache(pair):
    want, jcache = pair.j_prefill(pair.jp, jnp.asarray(pair.tokens))
    got, tcache = tapi.prefill(pair.tp, pair.tcfg,
                               {"tokens": torch.from_numpy(pair.tokens)})
    _close(want, got)
    _tree_close(jcache, tcache)


def test_ragged_decode_matches_jax_with_its_whole_state(pair):
    """Six decode steps from a random state at per-slot positions: logits
    and the whole state agree with JAX at every step, written in place."""
    rng = np.random.default_rng(4)
    jstate = jax.tree.map(
        lambda s: jnp.asarray(rng.standard_normal(s.shape) * 0.1, s.dtype),
        japi.init_decode_state(pair.jcfg, B, MAX_LEN))
    tstate = params_from_jax(_np_tree(jstate), "cpu")
    pos = np.array([0, 5], np.int32)
    for i in range(6):
        toks = pair.tokens[:, i]
        jl, jstate = pair.j_decode(pair.jp, jstate, jnp.asarray(toks),
                                   jnp.asarray(pos))
        tl, tstate2 = tapi.decode_step(pair.tp, pair.tcfg, tstate,
                                       torch.from_numpy(toks),
                                       torch.from_numpy(pos))
        assert tstate2 is tstate
        _close(jl, tl)
        _tree_close(jstate, tstate)
        pos += 1


def test_decode_state_spec_matches_jax(pair):
    jspec = japi.init_decode_state(pair.jcfg, 3, 20)
    tspec = tapi.init_decode_state(pair.tcfg, 3, 20)
    jleaves = jax.tree_util.tree_leaves_with_path(
        jspec, is_leaf=lambda s: isinstance(s, jax.ShapeDtypeStruct))
    tleaves = jax.tree_util.tree_leaves_with_path(
        tspec, is_leaf=lambda s: isinstance(s, TensorSpec))
    assert [p for p, _ in jleaves] == [p for p, _ in tleaves]
    for (_, j), (_, t) in zip(jleaves, tleaves):
        assert isinstance(t, TensorSpec)
        assert tuple(j.shape) == t.shape and t.dtype == torch.float32
    state = tapi.allocate_decode_state(pair.tcfg, 3, 20, "cpu")
    wkv = state["periods"]["sub0"]["rwkv_tm"]["wkv"]
    assert wkv.shape == (2, 3, 4, 16, 16) and not wkv.any()


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_params_convert_key_for_key_keeping_dtypes(param_dtype):
    """Each leaf keeps its JAX dtype (w0, u and ln_x stay f32 in a bf16
    tree), and the port's own init builds the same tree, dtypes included."""
    cfg = dataclasses.replace(jax_get_arch(ARCH).smoke, param_dtype=param_dtype)
    tcfg = dataclasses.replace(tconfig.get_arch(ARCH).smoke,
                               param_dtype=param_dtype)
    jp = japi.init_params(jax.random.key(0), cfg)
    tp = params_from_jax(_np_tree(jp), "cpu")
    own = tapi.init_params(torch.Generator().manual_seed(0), tcfg)
    jleaves = jax.tree_util.tree_leaves_with_path(jp)
    for tree in (tp, own):
        tleaves = jax.tree_util.tree_leaves_with_path(tree)
        assert [p for p, _ in jleaves] == [p for p, _ in tleaves]
        for (_, a), (_, b) in zip(jleaves, tleaves):
            assert tuple(a.shape) == tuple(b.shape)
            assert str(b.dtype).removeprefix("torch.") == a.dtype.name
    tm = tp["stack"]["periods"]["sub0"]["rwkv_tm"]
    for leaf in (tm["w0"], tm["u"], tm["ln_x"]["scale"], tm["ln_x"]["bias"]):
        assert leaf.dtype == torch.float32
    assert tm["wr"]["w"].dtype == getattr(torch, param_dtype)


def test_other_families_still_raise():
    """Mamba, MoE, MLA with its dense prefix blocks, the convnet, the VLM
    and the enc-dec run now; what still raises: a family the reference does
    not know either (ValueError, as its dispatch raises)."""
    gen = torch.Generator().manual_seed(0)
    cfg = _f32(tconfig.get_arch("qwen1.5-0.5b").smoke)
    bad = dataclasses.replace(cfg, family="retrieval")
    with pytest.raises(ValueError, match="retrieval"):
        tapi.init_params(gen, bad)
    with pytest.raises(ValueError, match="retrieval"):
        tapi.init_decode_state(bad, 1, 4)
    for family in ("encdec", "audio"):
        state = tapi.init_decode_state(
            dataclasses.replace(cfg, family=family), 1, 4)
        assert sorted(state) == ["cross_k", "cross_v", "self"]
