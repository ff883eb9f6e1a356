"""Port parity for the jamba hybrid (Mamba, attention, MoE in one period of
8 layers) against repro.models, and the port's own prefill = decode.

The JAX params of the jamba smoke config (f32: d_model 64, 4 experts top-2,
d_state 8, attention at layer 4, MoE on odd layers) are converted key for
key.  ``forward`` (logits and the MoE aux loss), ``prefill`` with its whole
cache and ragged ``decode_step`` with its whole state agree with JAX to 1e-4
(the reference's own bound is 2e-3, ``tests/test_models.py``), with the
config's capacity factor of 1.25.  Prefill = decode is checked dropless, as
the reference's own consistency tests run MoE (``tests/conftest.py``
``smoke_f32``): a prompt routed as one group may drop tokens that one-token
decode steps never drop.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.config import get_arch as jax_get_arch
from repro.models import api as japi
from repro_torch.convert import params_from_jax
from repro_torch.core import config as tconfig
from repro_torch.kernels.decode_attention import ops as dops
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.ssm_scan import ops as sops
from repro_torch.models import api as tapi
from repro_torch.models import blocks as TB
from repro_torch.models.attention import TensorSpec

ARCH = "jamba-1.5-large-398b"
ATOL = 1e-4
B, T, MAX_LEN = 2, 12, 16

# jitted: eager JAX init of the smoke stack takes several times as long
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
            p, cfg, {"tokens": t}, mode="train", remat="none"))
        self.j_prefill = jax.jit(lambda p, t: japi.prefill(
            p, cfg, {"tokens": t}))
        self.j_decode = jax.jit(lambda p, s, t, pos: japi.decode_step(
            p, cfg, s, t, pos))
        self.tokens = np.random.default_rng(0).integers(
            0, cfg.vocab_size, (B, T)).astype(np.int32)


@pytest.fixture(scope="module")
def pair():
    return Pair()


def _calls():
    return sops.ref.calls, fops.ref.calls, dops.ref.calls


def test_arch_is_ported_and_config_copied():
    from repro_torch.configs import jamba_1_5_large_398b as J

    j, t = jax_get_arch(ARCH), tconfig.get_arch(ARCH)
    for jc, tc in ((j.model, t.model), (j.smoke, t.smoke)):
        assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
        assert tc.layer_kinds() == jc.layer_kinds()
        assert tc.ffn_kinds() == jc.ffn_kinds()
    assert (j.shapes, j.skip_shapes, j.source) == \
        (t.shapes, t.skip_shapes, t.source)
    # CARD: the first five layers at every published width, bf16
    card = J.CARD
    assert dataclasses.replace(card, num_layers=72) == t.model
    assert card.param_dtype == card.compute_dtype == "bfloat16"
    assert TB.block_pattern(card) == ([], [
        ("ssm", "dense"), ("ssm", "moe"), ("ssm", "dense"), ("ssm", "moe"),
        ("attn", "dense")], 1)


def test_forward_matches_jax_with_its_aux(pair):
    want, want_aux = pair.j_forward(pair.jp, jnp.asarray(pair.tokens))
    before = _calls()
    got, aux = tapi.forward(pair.tp, pair.tcfg,
                            {"tokens": torch.from_numpy(pair.tokens)})
    # 7 Mamba layers and 1 attention layer, one op call each
    assert np.subtract(_calls(), before).tolist() == [7, 1, 0]
    assert got.shape == (B, T, pair.tcfg.vocab_size)
    _close(want, got)
    assert float(aux) > 0
    _close(want_aux, aux, 1e-5)


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
        before = _calls()
        tl, tstate2 = tapi.decode_step(pair.tp, pair.tcfg, tstate,
                                       torch.from_numpy(toks),
                                       torch.from_numpy(pos))
        # every decode step runs the scan op in each Mamba layer
        assert np.subtract(_calls(), before).tolist() == [7, 0, 1]
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
        assert tuple(j.shape) == t.shape and t.dtype == torch.float32


def test_prefill_equals_decode_dropless():
    """The port's own consistency at smoke size: prefill of the prompt gives
    the last logits and the whole cache that token-by-token decode gives."""
    cfg = _f32(tconfig.get_arch(ARCH).smoke)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=-1.0))
    params = tapi.init_params(torch.Generator().manual_seed(3), cfg)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, T)))
    last, cache = tapi.prefill(params, cfg, {"tokens": toks})
    state = tapi.allocate_decode_state(cfg, B, T, "cpu")
    for t in range(T):
        logits, state = tapi.decode_step(params, cfg, state, toks[:, t],
                                         torch.full((B,), t, dtype=torch.int32))
    torch.testing.assert_close(last[:, 0], logits, atol=ATOL, rtol=0)
    for a, b in zip(jax.tree_util.tree_leaves(cache),
                    jax.tree_util.tree_leaves(state)):
        torch.testing.assert_close(a, b, atol=ATOL, rtol=0)


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_params_convert_key_for_key_keeping_dtypes(param_dtype):
    """Each leaf keeps its JAX dtype (A_log, D and the router stay f32 in a
    bf16 tree), and the port's own init builds the same tree, dtypes
    included."""
    cfg = dataclasses.replace(jax_get_arch(ARCH).smoke, param_dtype=param_dtype)
    tcfg = dataclasses.replace(tconfig.get_arch(ARCH).smoke,
                               param_dtype=param_dtype)
    # the reference's tree, shapes and dtypes, without compiling its init
    jp = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                      japi.param_shapes(cfg))
    tp = params_from_jax(_np_tree(jp), "cpu")
    own = tapi.init_params(torch.Generator().manual_seed(0), tcfg)
    jleaves = jax.tree_util.tree_leaves_with_path(jp)
    for tree in (tp, own):
        tleaves = jax.tree_util.tree_leaves_with_path(tree)
        assert [p for p, _ in jleaves] == [p for p, _ in tleaves]
        for (_, a), (_, b) in zip(jleaves, tleaves):
            assert tuple(a.shape) == tuple(b.shape)
            assert str(b.dtype).removeprefix("torch.") == a.dtype.name
    periods = tp["stack"]["periods"]
    for leaf in (periods["sub0"]["ssm"]["A_log"], periods["sub0"]["ssm"]["D"],
                 periods["sub1"]["ffn_moe"]["router"]["w"]):
        assert leaf.dtype == torch.float32
    assert periods["sub1"]["ffn_moe"]["w_up"].dtype == getattr(torch, param_dtype)
    # dense layers take d_ff_dense
    assert periods["sub0"]["ffn"]["w_up"]["w"].shape[-1] == cfg.moe.d_ff_dense


def test_init_stack_fills_the_stacked_periods_in_place():
    """Two periods of the smoke config: each is drawn into the stacked
    tensors, and the draws are those of the periods drawn one after the
    other (what stacking copies would give)."""
    cfg = dataclasses.replace(_f32(tconfig.get_arch(ARCH).smoke),
                              num_layers=16)
    stacked = TB.init_stack(torch.Generator().manual_seed(2), cfg)["periods"]
    one = dataclasses.replace(cfg, num_layers=8)
    gen = torch.Generator().manual_seed(2)
    firsts = [TB.init_stack(gen, one)["periods"] for _ in range(2)]
    for got, *want in zip(jax.tree_util.tree_leaves(stacked),
                          *(jax.tree_util.tree_leaves(f) for f in firsts)):
        assert got.shape[0] == 2
        torch.testing.assert_close(got, torch.cat(want), rtol=0, atol=0)
