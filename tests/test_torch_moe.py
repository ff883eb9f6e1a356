"""Port parity for the MoE FFN: repro_torch.models.layers.apply_moe against
repro.models.layers.apply_moe, and the granite-moe smoke model
(("attn", "moe") blocks) against repro.models.

``apply_moe`` is held to JAX on the same converted params and inputs,
output and Switch aux loss, in three cases: with tokens over an expert's
capacity dropped (capacity factor 1.25, a router skewed towards one
expert), dropless (capacity factor -1) and with long rows regrouped into
routing groups (``MOE_GROUP_SIZE`` set small in both packages).  Tolerance
1e-4 in f32 (the reference's own bound is 2e-3, ``tests/test_models.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.config import get_arch as jax_get_arch
from repro.models import api as japi
from repro.models import layers as JL
from repro_torch.convert import params_from_jax
from repro_torch.core import config as tconfig
from repro_torch.models import api as tapi
from repro_torch.models import layers as TL

ARCH = "jamba-1.5-large-398b"
ATOL = 1e-4
G, S = 2, 32


def _f32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32",
                               compute_dtype="float32")


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _close(jax_out, torch_out, atol=ATOL):
    np.testing.assert_allclose(torch_out.numpy(), np.asarray(jax_out),
                               atol=atol, rtol=0)


class Moe:
    """The jamba smoke MoE (4 experts, top-2, d_model 64, d_ff 128) with a
    router skewed towards expert 0, so that capacity 1.25 drops tokens."""

    def __init__(self):
        self.jcfg = _f32(jax_get_arch(ARCH).smoke)
        self.tcfg = _f32(tconfig.get_arch(ARCH).smoke)
        jp = JL.init_moe(jax.random.key(5), self.jcfg, jnp.float32)
        rng = np.random.default_rng(11)
        D = self.jcfg.d_model
        self.x = (rng.standard_normal((G, S, D)) + 0.5).astype(np.float32)
        router = np.array(jp["router"]["w"])
        router[:, 0] += 0.3                    # x's mean favours expert 0
        jp["router"]["w"] = jnp.asarray(router)
        self.jp = jp
        self.tp = params_from_jax(_np_tree(jp), "cpu")

    def jax_moe(self, cf):
        cfg = self.jcfg
        return jax.jit(lambda p, x: JL.apply_moe(
            p, x, cfg, capacity_factor=cf, compute_dtype=jnp.float32))(
                self.jp, jnp.asarray(self.x))

    def torch_moe(self, cf):
        return TL.apply_moe(self.tp, torch.from_numpy(self.x), self.tcfg,
                            capacity_factor=cf, compute_dtype=torch.float32)


@pytest.fixture(scope="module")
def moe():
    return Moe()


def _dropped(moe, groups, cf):
    """(token, choice) pairs over capacity, counted from the router in
    NumPy with the reference's queue order."""
    m = moe.jcfg.moe
    x = moe.x.reshape(groups, -1, moe.x.shape[-1])
    logits = x @ np.asarray(moe.jp["router"]["w"])
    top = np.argsort(-logits, axis=-1)[..., :m.num_experts_per_tok]
    Sg = x.shape[1]
    C = JL.moe_capacity(Sg, m.num_experts, m.num_experts_per_tok, cf)
    counts = np.stack([(top == e).sum(axis=(1, 2))
                       for e in range(m.num_experts)], -1)
    return int(np.maximum(counts - C, 0).sum())


@pytest.mark.parametrize("cf", [1.25, -1.0], ids=["drops", "dropless"])
def test_apply_moe_matches_jax(moe, cf):
    if cf > 0:
        assert _dropped(moe, G, cf) > 0     # the case really drops tokens
    jy, jaux = moe.jax_moe(cf)
    ty, taux = moe.torch_moe(cf)
    assert ty.shape == moe.x.shape and taux.shape == ()
    _close(jy, ty)
    _close(jaux, taux, 1e-6)


def test_apply_moe_regrouped_matches_jax(moe, monkeypatch):
    """Rows longer than MOE_GROUP_SIZE (and divisible by it) route in groups
    of that size: capacity and queues are per group."""
    monkeypatch.setattr(JL, "MOE_GROUP_SIZE", 8)
    monkeypatch.setattr(TL, "MOE_GROUP_SIZE", 8)
    assert _dropped(moe, G * S // 8, 1.25) > 0
    jy, jaux = moe.jax_moe(1.25)
    ty, taux = moe.torch_moe(1.25)
    _close(jy, ty)
    _close(jaux, taux, 1e-6)
    # and it is not the ungrouped function
    monkeypatch.setattr(TL, "MOE_GROUP_SIZE", 4096)
    assert not torch.allclose(moe.torch_moe(1.25)[0], ty, atol=ATOL)


def test_moe_capacity_matches_jax():
    for seq in (1, 2, 12, 256, 4096):
        for e, k in ((4, 2), (16, 2), (32, 8)):
            for cf in (1.0, 1.25, 2.0):
                assert TL.moe_capacity(seq, e, k, cf) == \
                    JL.moe_capacity(seq, e, k, cf)
    assert TL.MOE_GROUP_SIZE == JL.MOE_GROUP_SIZE


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_init_moe_tree_matches_jax(param_dtype):
    """Same keys, shapes and dtypes (the router f32 in a bf16 tree)."""
    cfg = tconfig.get_arch(ARCH).smoke
    dt = getattr(torch, param_dtype)
    jp = JL.init_moe(jax.random.key(0), jax_get_arch(ARCH).smoke,
                     getattr(jnp, param_dtype))
    tp = TL.init_moe(torch.Generator().manual_seed(0), cfg, dt)
    jleaves = jax.tree_util.tree_leaves_with_path(jp)
    tleaves = jax.tree_util.tree_leaves_with_path(tp)
    assert [p for p, _ in jleaves] == [p for p, _ in tleaves]
    for (_, a), (_, b) in zip(jleaves, tleaves):
        assert tuple(a.shape) == tuple(b.shape)
        assert str(b.dtype).removeprefix("torch.") == a.dtype.name
    assert tp["router"]["w"].dtype == torch.float32
    # per-expert draws at the reference's scales
    d, f = cfg.d_model, cfg.moe.d_ff_expert
    for k, scale in (("w_up", d ** -0.5), ("w_down", f ** -0.5)):
        std = tp[k].float().std(dim=(1, 2))
        assert torch.allclose(std, torch.full_like(std, scale), rtol=0.1)
        assert not torch.equal(tp[k][0], tp[k][1])


# ---------------------------------------------------------------------------
# granite-moe smoke: ("attn", "moe") blocks, tied head
# ---------------------------------------------------------------------------

GRANITE = "granite-moe-1b-a400m"
B, T, MAX_LEN = 2, 12, 16


class Granite:
    def __init__(self):
        self.jcfg = _f32(jax_get_arch(GRANITE).smoke)
        self.tcfg = _f32(tconfig.get_arch(GRANITE).smoke)
        self.jp = jax.jit(japi.init_params, static_argnums=1)(
            jax.random.key(1), self.jcfg)
        self.tp = params_from_jax(_np_tree(self.jp), "cpu")
        self.tokens = np.random.default_rng(0).integers(
            0, self.jcfg.vocab_size, (B, T)).astype(np.int32)


@pytest.fixture(scope="module")
def granite():
    return Granite()


def test_granite_forward_and_prefill_match_jax(granite):
    cfg = granite.jcfg
    toks = jnp.asarray(granite.tokens)
    want, want_aux = jax.jit(lambda p, t: japi.forward(
        p, cfg, {"tokens": t}, mode="train", remat="none"))(granite.jp, toks)
    got, aux = tapi.forward(granite.tp, granite.tcfg,
                            {"tokens": torch.from_numpy(granite.tokens)})
    _close(want, got)
    assert float(aux) > 0
    _close(want_aux, aux, 1e-5)
    want, jcache = jax.jit(lambda p, t: japi.prefill(p, cfg, {"tokens": t}))(
        granite.jp, toks)
    got, tcache = tapi.prefill(granite.tp, granite.tcfg,
                               {"tokens": torch.from_numpy(granite.tokens)})
    _close(want, got)
    jax.tree.map(lambda a, b: _close(a, b), _np_tree(jcache), tcache)


def test_granite_ragged_decode_matches_jax(granite):
    cfg = granite.jcfg
    dec = jax.jit(lambda p, s, t, pos: japi.decode_step(p, cfg, s, t, pos))
    jstate = japi.allocate_decode_state(cfg, B, MAX_LEN)
    tstate = tapi.allocate_decode_state(granite.tcfg, B, MAX_LEN, "cpu")
    pos = np.array([0, 5], np.int32)
    for i in range(4):
        toks = granite.tokens[:, i]
        jl, jstate = dec(granite.jp, jstate, jnp.asarray(toks),
                         jnp.asarray(pos))
        tl, tstate = tapi.decode_step(granite.tp, granite.tcfg, tstate,
                                      torch.from_numpy(toks),
                                      torch.from_numpy(pos))
        _close(jl, tl)
        pos += 1
    jax.tree.map(lambda a, b: _close(a, b), _np_tree(jstate), tstate)
