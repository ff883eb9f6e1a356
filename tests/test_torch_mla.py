"""Port parity for deepseek-v2's multi-head latent attention (MLA) and its
dense prefix block against repro.models, and the two kernels' plain
versions on its path.

At smoke size in f32 the same seeded numpy inputs and converted weights go
through the JAX package and the port: ``apply_mla`` in train, prefill (with
its latent cache) and decode (a scalar and a per-slot position), on the
low-rank query route and the ``wq`` route; ``mla_decode``'s plain version
against the reference's absorbed einsums; K2's plain version at hd 24,
hd_v 16 against ``repro.models.layers.attention`` on its full and its
chunked path; and the deepseek smoke model's ``forward``, ``prefill`` and
token-by-token ``decode_step``, with the config's capacity factor.  ATOL is
1e-4; the reference's own bound is 2e-3 (``tests/test_models.py``).
Prefill = decode is the port's own check, dropless (``tests/conftest.py``
``smoke_f32``).
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.config import ShapeConfig as JShape
from repro.core.config import get_arch as jax_get_arch
from repro.models import api as japi
from repro.models import attention as jatt
from repro.models import layers as jlayers
from repro_torch.convert import params_from_jax
from repro_torch.core import config as tconfig
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.mla_decode import ops as mops
from repro_torch.models import api as tapi
from repro_torch.models import attention as tatt
from repro_torch.models import blocks as TB
from repro_torch.models.attention import TensorSpec

ARCH = "deepseek-v2-236b"
ATOL = 1e-4
B, T, MAX_LEN = 2, 12, 16

_init = jax.jit(japi.init_params, static_argnums=1)


def _f32(cfg, q_lora=None):
    cfg = dataclasses.replace(cfg, param_dtype="float32",
                              compute_dtype="float32")
    if q_lora is not None:
        cfg = dataclasses.replace(cfg, attention=dataclasses.replace(
            cfg.attention, q_lora_rank=q_lora))
    return cfg


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


# ---------------------------------------------------------------------------
# The config
# ---------------------------------------------------------------------------


def test_arch_is_ported_and_config_copied():
    from repro_torch.configs import deepseek_v2_236b as D

    j, t = jax_get_arch(ARCH), tconfig.get_arch(ARCH)
    for jc, tc in ((j.model, t.model), (j.smoke, t.smoke)):
        assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
        assert tc.ffn_kinds() == jc.ffn_kinds()
    assert (j.shapes, j.skip_shapes, j.skip_reason, j.source) == \
        (t.shapes, t.skip_shapes, t.skip_reason, t.source)
    # CARD: the first four layers at every published width, bf16: the dense
    # prefix block and three stacked MoE periods
    card = D.CARD
    assert dataclasses.replace(card, num_layers=60) == t.model
    assert card.param_dtype == card.compute_dtype == "bfloat16"
    assert TB.block_pattern(card) == ([("attn", "dense")],
                                      [("attn", "moe")], 3)


def test_param_count_matches_jax():
    """The whole published model's count (236 B) and the served cut's, total
    and active, and the decode step's model FLOPs."""
    from repro_torch.configs.deepseek_v2_236b import CARD

    full = jax_get_arch(ARCH).model
    assert tapi.param_count(tconfig.get_arch(ARCH).model) == \
        japi.param_count(full) == 235_741_434_880
    jcard = dataclasses.replace(full, num_layers=4)
    for active in (False, True):
        assert tapi.param_count(CARD, active_only=active) == \
            japi.param_count(jcard, active_only=active)
    assert tapi.param_count(CARD) == 13_302_912_000
    shape = tconfig.LM_SHAPES["decode_32k"]
    assert tapi.model_flops(CARD, shape) == japi.model_flops(
        jcard, JShape(shape.name, shape.seq_len, shape.global_batch,
                      shape.mode))


@pytest.mark.parametrize("q_lora", [32, 0], ids=["q_lora", "wq"])
def test_params_and_cache_spec_convert_key_for_key(q_lora):
    """The prefix block and the stacked periods, key for key and shape for
    shape, on both query routes; the port's own init builds the same tree;
    the decode state's spec is the reference's."""
    jcfg = _f32(jax_get_arch(ARCH).smoke, q_lora)
    tcfg = _f32(tconfig.get_arch(ARCH).smoke, q_lora)
    jp = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                      japi.param_shapes(jcfg))
    tp = params_from_jax(_np_tree(jp), "cpu")
    own = tapi.init_params(torch.Generator().manual_seed(0), tcfg)
    jleaves = jax.tree_util.tree_leaves_with_path(jp)
    for tree in (tp, own):
        tleaves = jax.tree_util.tree_leaves_with_path(tree)
        assert [p for p, _ in jleaves] == [p for p, _ in tleaves]
        for (_, a), (_, b) in zip(jleaves, tleaves):
            assert tuple(a.shape) == tuple(b.shape)
    attn = own["stack"]["prefix"]["blk0"]["attn"]
    assert ("wq_a" in attn) == bool(q_lora) and ("wq" in attn) != bool(q_lora)
    jspec = japi.init_decode_state(jcfg, 3, 20)
    tspec = tapi.init_decode_state(tcfg, 3, 20)
    jl = jax.tree_util.tree_leaves_with_path(
        jspec, is_leaf=lambda s: isinstance(s, jax.ShapeDtypeStruct))
    tl = jax.tree_util.tree_leaves_with_path(
        tspec, is_leaf=lambda s: isinstance(s, TensorSpec))
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (_, j), (_, t) in zip(jl, tl):
        assert tuple(j.shape) == t.shape and t.dtype == torch.float32


# ---------------------------------------------------------------------------
# apply_mla against the reference
# ---------------------------------------------------------------------------


class Layer:
    """One MLA layer of the smoke config, JAX and port, from one init."""

    def __init__(self, q_lora):
        self.jcfg = _f32(jax_get_arch(ARCH).smoke, q_lora)
        self.tcfg = _f32(tconfig.get_arch(ARCH).smoke, q_lora)
        self.jp = jatt.init_mla(jax.random.key(7), self.jcfg)
        self.tp = params_from_jax(_np_tree(self.jp), "cpu")
        rng = np.random.default_rng(3)
        self.x = rng.standard_normal((B, T, self.jcfg.d_model)).astype(
            np.float32)
        a = self.jcfg.attention
        self.cache = {
            "ckv": rng.standard_normal((B, MAX_LEN, a.kv_lora_rank)).astype(
                np.float32),
            "krope": rng.standard_normal((B, MAX_LEN, a.qk_rope_head_dim))
            .astype(np.float32)}
        cfg = self.jcfg
        self.j_apply = jax.jit(
            lambda p, x, mode: jatt.apply_mla(p, x, cfg, mode=mode),
            static_argnums=2)
        self.j_decode = jax.jit(lambda p, x, c, pos: jatt.apply_mla(
            p, x, cfg, mode="decode", cache=c, pos=pos))


@pytest.fixture(scope="module", params=[32, 0], ids=["q_lora", "wq"])
def layer(request):
    return Layer(request.param)


def test_apply_mla_train_and_prefill_match_jax(layer):
    """Expanded attention through K2 (its plain version here): the output
    in train and prefill, and prefill's latent cache."""
    before = fops.ref.calls
    for mode in ("train", "prefill"):
        want, jcache = layer.j_apply(layer.jp, jnp.asarray(layer.x), mode)
        got, tcache = tatt.apply_mla(layer.tp, torch.from_numpy(layer.x),
                                     layer.tcfg, mode=mode)
        _close(want, got)
        if mode == "train":
            assert jcache is None and tcache is None
        else:
            assert tcache["ckv"].shape == (B, T, 32)
            _tree_close(jcache, tcache)
    assert fops.ref.calls == before + 2


@pytest.mark.parametrize("per_slot", [False, True], ids=["scalar", "per_slot"])
def test_apply_mla_decode_matches_jax(layer, per_slot):
    """Absorbed decode over a random latent cache: every step's output and
    the whole cache (written in place at each row's position) agree with
    the reference's, through mla_decode (its plain version here)."""
    jcache = {k: jnp.asarray(v) for k, v in layer.cache.items()}
    tcache = {k: torch.from_numpy(v.copy()) for k, v in layer.cache.items()}
    pos = np.array([3, 9], np.int32) if per_slot else np.int32(5)
    before = mops.ref.calls
    for t in range(4):
        x = layer.x[:, t:t + 1]
        want, jcache = layer.j_decode(layer.jp, jnp.asarray(x), jcache,
                                      jnp.asarray(pos))
        got, new = tatt.apply_mla(layer.tp, torch.from_numpy(x), layer.tcfg,
                                  mode="decode", cache=tcache,
                                  pos=torch.from_numpy(np.asarray(pos)))
        assert new is tcache
        _close(want, got)
        _tree_close(jcache, tcache)
        pos = pos + 1
    assert mops.ref.calls == before + 4


def test_decode_clamps_a_position_past_the_cache(layer):
    """A position past the cache's end writes the last row (the reference's
    dynamic_update_slice clamps) and attends over the whole cache."""
    jcache = {k: jnp.asarray(v) for k, v in layer.cache.items()}
    tcache = {k: torch.from_numpy(v.copy()) for k, v in layer.cache.items()}
    pos = np.array([MAX_LEN + 3, 2], np.int32)
    x = layer.x[:, :1]
    want, jcache = layer.j_decode(layer.jp, jnp.asarray(x), jcache,
                                  jnp.asarray(pos))
    got, _ = tatt.apply_mla(layer.tp, torch.from_numpy(x), layer.tcfg,
                            mode="decode", cache=tcache,
                            pos=torch.from_numpy(pos))
    _close(want, got)
    _tree_close(jcache, tcache)


# ---------------------------------------------------------------------------
# The kernels' plain versions
# ---------------------------------------------------------------------------


def _absorbed_ref(q_abs, q_rope, ckv, krope, pos, scale, cd):
    """The reference's absorbed einsums (attention.py, apply_mla's decode),
    from q_abs to ctx, in jnp."""
    s = jnp.einsum("bhl,btl->bht", q_abs, ckv,
                   preferred_element_type=jnp.float32)
    s += jnp.einsum("bhr,btr->bht", q_rope, krope,
                    preferred_element_type=jnp.float32)
    s *= scale
    mask = jnp.arange(ckv.shape[1])[None, None, :] <= pos[:, None, None]
    probs = jax.nn.softmax(jnp.where(mask, s, -jnp.inf), axis=-1)
    return jnp.einsum("bht,btl->bhl", probs.astype(cd), ckv,
                      preferred_element_type=jnp.float32).astype(cd)


@pytest.mark.parametrize("dtype,atol", [("float32", ATOL),
                                        ("bfloat16", 2e-2)])
@pytest.mark.parametrize("H,L,R,Tc,pos", [
    (4, 32, 8, 16, [0, 15]),
    (20, 64, 16, 40, [39, 7]),
    (4, 32, 8, 16, [20, 3]),          # past the end: every position
])
def test_mla_decode_plain_version_matches_the_absorbed_einsums(
        dtype, atol, H, L, R, Tc, pos):
    rng = np.random.default_rng(H + Tc)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((2, H, L), (2, H, R), (2, Tc, L), (2, Tc, R))]
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    scale = 1.0 / math.sqrt(24)
    want = _absorbed_ref(*(jnp.asarray(a, jd) for a in arrs),
                         jnp.asarray(pos), scale, jd)
    before = (mops.launches, mops.ref.calls)
    got = mops.mla_decode(
        *(torch.from_numpy(a).to(td) for a in arrs),
        torch.tensor(pos, dtype=torch.int32) + 1, scale)
    assert (mops.launches, mops.ref.calls) == (before[0], before[1] + 1)
    assert got.dtype == td and got.shape == (2, H, L)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=atol, rtol=0)


def test_mla_decode_rejects_what_the_kernel_does_not_take():
    q, qr = torch.zeros(2, 4, 32), torch.zeros(2, 4, 8)
    ckv, kr = torch.zeros(2, 16, 32), torch.zeros(2, 16, 8)
    lens = torch.tensor([3, 16], dtype=torch.int32)
    with pytest.raises(TypeError):
        mops.mla_decode(q, qr, ckv, kr, lens.long(), 0.1)
    with pytest.raises(TypeError):
        mops.mla_decode(q, qr, ckv.double(), kr, lens, 0.1)
    with pytest.raises(ValueError):          # L not a multiple of 8
        mops.mla_decode(torch.zeros(2, 4, 30), qr, torch.zeros(2, 16, 30), kr,
                        lens, 0.1)
    with pytest.raises(ValueError):          # L past the kernel's 512
        mops.mla_decode(torch.zeros(2, 4, 520), qr, torch.zeros(2, 16, 520),
                        kr, lens, 0.1)
    with pytest.raises(ValueError):          # shapes that do not match
        mops.mla_decode(q, qr, torch.zeros(2, 16, 24), kr, lens, 0.1)
    with pytest.raises(ValueError):
        mops.mla_decode(q, qr, ckv.transpose(1, 2).contiguous().transpose(1, 2),
                        kr, lens, 0.1)
    with pytest.raises(ValueError):          # the meta route checks too
        mops.mla_decode(*(t.to("meta") for t in (torch.zeros(2, 4, 30), qr,
                                                 torch.zeros(2, 16, 30), kr,
                                                 lens)), 0.1)


@pytest.mark.parametrize("B,H,T,sm,route,want", [
    (4, 128, 128, 132, "wgmma", 8),         # the served step: 2 tiles a row
    (4, 128, 32768, 132, "wgmma", 66),      # one wave over 2 head chunks
    (1, 128, 32768, 132, "wgmma", 66),
    (1, 4, 16, 132, "cuda_cores", 1),       # one tile
    (4, 128, 32768, 132, "cuda_cores", 17),  # 8 chunks of 16 heads
    (64, 128, 4096, 132, "wgmma", 66),
])
def test_mla_decode_grid_blocks(B, H, T, sm, route, want):
    assert mops.grid_blocks(B, H, T, sm, *mops.ROUTES[route]) == want


@pytest.mark.parametrize("dtype,L,R,want", [
    (torch.bfloat16, 512, 64, "wgmma"),
    (torch.float32, 512, 64, "cuda_cores"),
    (torch.bfloat16, 32, 8, "cuda_cores"),
    (torch.bfloat16, 512, 128, "cuda_cores"),
])
def test_mla_decode_route(dtype, L, R, want):
    assert mops.route(dtype, L, R) == want


# kv_len patterns of phase 2 of chip_smoke.py, cycled over B rows: the
# served step, the profiled 32k cache, the same keys in rows of one length,
# and rows past T, empty or negative
KV_LENS = {"served": [97, 81, 65, 49],
           "main": [4096, 8192, 16384, 32768],
           "balanced": [15360] * 4,
           "edges": [0, 40000, 1, -3, 33, 64]}


def _kv(kind, B):
    pattern = KV_LENS[kind]
    return [pattern[i % len(pattern)] for i in range(B)]


@pytest.mark.parametrize("T", [16, 128, 32768])
@pytest.mark.parametrize("kind", list(KV_LENS))
@pytest.mark.parametrize("B", [1, 4, 64])
def test_mla_decode_split_schedule(B, kind, T):
    kv_len = _kv(kind, B)
    for route, (heads, keys) in mops.ROUTES.items():
        nblocks = mops.grid_blocks(B, 128, T, 132, heads, keys)
        sched = mops.split_schedule(kv_len, T, keys, nblocks)
        assert len(sched) == nblocks
        tiles = [-(-min(max(n, 0), T) // keys) for n in kv_len]
        total = sum(tiles)
        cap = -(-total // nblocks)
        # every valid tile of every row to exactly one block, in row order
        # (the blocks' segments end to end), nothing at or past the row's
        # clamped kv_len
        walked = [(b, t) for segs in sched for b, t0, t1 in segs
                  for t in range(t0, t1)]
        assert walked == [(b, t) for b, n in enumerate(tiles)
                          for t in range(n)]
        assert all(t * keys < min(max(kv_len[b], 0), T) for b, t in walked)
        assert all(sum(t1 - t0 for _, t0, t1 in segs) <= cap
                   for segs in sched)
        assert all(t1 > t0 for segs in sched for _, t0, t1 in segs)
        assert not {b for segs in sched for b, _, _ in segs} & {
            b for b, n in enumerate(kv_len) if n <= 0}
        # a partial's slot block + row is its own
        slots = [s + b for s, segs in enumerate(sched) for b, t0, t1 in segs
                 if (t0, t1) != (0, tiles[b])]
        assert len(slots) == len(set(slots))
        assert all(0 <= x < nblocks + B for x in slots)


def _fold(run, part):
    """mla_merge_kernel's step: partial (m, l, acc) folded into the running
    one, m in log2 units."""
    (m, l, acc), (mk, lk, ak) = run, part
    mn = torch.maximum(m, mk)
    c, w = torch.exp2(m - mn), torch.exp2(mk - mn)
    return mn, l * c + lk * w, acc * c[:, None] + ak * w[:, None]


def _emulate(q_abs, q_rope, ckv, krope, kv_len, scale, keys, nblocks):
    """The kernels' arithmetic in f32 on the CPU: each block's segments
    tile by tile (online softmax, m in log2 units against the running max),
    whole rows written, partials folded in block order as the merge kernels
    do."""
    B, H, L = q_abs.shape
    T = ckv.shape[1]
    k = torch.cat([ckv, krope], -1)
    q = torch.cat([q_abs, q_rope], -1)
    c = scale * 1.4426950408889634
    out = torch.zeros(B, H, L)
    parts = {}
    sched = mops.split_schedule(kv_len.tolist(), T, keys, nblocks)
    tiles = mops.row_tiles(kv_len.tolist(), T, keys)
    for s, segs in enumerate(sched):
        for b, t0, t1 in segs:
            m = torch.full((H,), -1e30)
            l, acc = torch.zeros(H), torch.zeros(H, L)
            n = min(max(int(kv_len[b]), 0), T)
            for t in range(t0, t1):
                lo, hi = t * keys, min(n, t * keys + keys)
                sc = q[b] @ k[b, lo:hi].T
                mn = torch.maximum(m, sc.max(-1).values * c)
                p = torch.exp2(sc * c - mn[:, None])
                corr = torch.exp2(m - mn)
                l = l * corr + p.sum(-1)
                acc = acc * corr[:, None] + p @ ckv[b, lo:hi]
                m = mn
            if (t0, t1) == (0, tiles[b]):
                out[b] = acc / l.clamp_min(1e-30)[:, None]
            else:
                parts.setdefault(b, []).append((m, l, acc))
    for b, ps in parts.items():      # in block order
        run = (torch.full((H,), -1e30), torch.zeros(H), torch.zeros(H, L))
        for part in ps:
            run = _fold(run, part)
        out[b] = run[2] / run[1].clamp_min(1e-30)[:, None]
    return out


@pytest.mark.parametrize("keys,nblocks", [(64, 7), (32, 5), (8, 3), (8, 64)])
@pytest.mark.parametrize("kind,B,T", [
    ("served", 4, 128), ("main", 4, 320), ("balanced", 4, 160),
    ("edges", 6, 48), ("served", 1, 128), ("random", 64, 48)])
def test_mla_decode_split_and_merge_emulated(kind, B, T, keys, nblocks):
    rng = np.random.default_rng(B + T + keys)
    H, L, R = 4, 32, 8
    if kind == "random":
        kv = rng.integers(-2, T + 8, size=B).tolist()
    elif kind == "main":
        kv = [40, 80, 160, 320]
    elif kind == "balanced":
        kv = [150] * 4
    else:
        kv = _kv(kind, B)
    arrs = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((B, H, L), (B, H, R), (B, T, L), (B, T, R))]
    kv_len = torch.tensor(kv, dtype=torch.int32)
    scale = 1.0 / math.sqrt(24)
    got = _emulate(*arrs, kv_len, scale, keys, nblocks)
    want = mops.mla_decode_ref(*arrs, kv_len, scale)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)


def _k2_case(B, H, Sq, Sk, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, H, Sq, 24), (B, H, Sk, 24), (B, H, Sk, 16))]


@pytest.mark.parametrize("Sq,Sk,causal,q_offset", [
    (12, 12, True, 0),                  # the full path
    (5, 40, True, 35),
    (9, 20, False, 0),
    (1040, 1040, True, 0),              # Sq * Sk > 1024^2: the chunked path
    (520, 2100, True, 1580),
])
def test_k2_plain_version_at_hd_24_hd_v_16(Sq, Sk, causal, q_offset):
    q, k, v = _k2_case(1, 2, Sq, Sk, Sq + Sk)
    want = jlayers.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=causal, q_offset=q_offset)
    got = fops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                               causal=causal, q_offset=q_offset)
    assert got.shape == (1, 2, Sq, 16)
    _close(want, got)


@pytest.mark.parametrize("hd,hd_v", [(128, 64), (192, 192), (192, 64),
                                     (200, 128)])
def test_k2_refuses_a_pair_it_has_no_kernel_for(hd, hd_v):
    """The kernel is built for hd_v in hd's 64-wide class up to 128 and for
    MLA's (192, 128) class; other pairs raise on every device, the CPU's
    plain version included, so that no shape runs on one and not the
    other."""
    with pytest.raises(ValueError, match="hd_v <= hd"):
        fops.flash_attention(torch.zeros(1, 2, 4, hd), torch.zeros(1, 2, 4, hd),
                             torch.zeros(1, 2, 4, hd_v))


def test_k2_refuses_grad_at_a_value_width_of_its_own():
    """The backward takes MLA's value width of its own: under grad mode, a
    meta tensor at hd 192, hd_v 128 takes the card's route (forward kernel
    with its lse, then the backward kernel) up to the launch and returns
    dq, dk, dv of q's, k's and v's shapes and dtypes; without grad the same
    call is the plain forward route.  A pair of widths with no kernel is
    refused by the backward's own check, on every device."""
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.zeros(1, 2, 4, 192, device="meta", dtype=dtype,
                        requires_grad=True)
        k = torch.zeros(1, 2, 4, 192, device="meta", dtype=dtype,
                        requires_grad=True)
        v = torch.zeros(1, 2, 4, 128, device="meta", dtype=dtype,
                        requires_grad=True)
        fwd, bwd_calls = fops.launches, fops.bwd.launches
        out = fops.flash_attention(q, k, v)
        assert out.shape == (1, 2, 4, 128) and out.grad_fn is not None
        grads = torch.autograd.grad(out, (q, k, v), torch.zeros_like(out))
        assert [(g.shape, g.dtype, g.device.type) for g in grads] == \
            [(t.shape, dtype, "meta") for t in (q, k, v)]
        assert (fops.launches, fops.bwd.launches) == (fwd, bwd_calls)
        with torch.no_grad():
            assert fops.flash_attention(q, k, v).shape == (1, 2, 4, 128)
    with pytest.raises(ValueError, match="hd_v <= hd"):
        fops.flash_attention(torch.zeros(1, 2, 4, 16), torch.zeros(1, 2, 4, 16),
                             torch.zeros(1, 2, 4, 24))
    # (128, 64): hd_v in another 64-wide class than hd, a pair with no kernel
    q, k = torch.zeros(1, 2, 4, 128), torch.zeros(1, 2, 4, 128)
    v, o = torch.zeros(1, 2, 4, 64), torch.zeros(1, 2, 4, 64)
    lse = torch.zeros(1, 2, 4)
    for device in ("cpu", "meta"):
        with pytest.raises(ValueError, match="one 64-wide class"):
            fops.bwd.flash_attention_bwd(*(t.to(device) for t in (
                q, k, v, o, lse, o)))
    # and the CPU's plain version differentiates at hd_v != hd
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in _k2_case(1, 2, 6, 6, 0))
    fops.flash_attention(q, k, v).sum().backward()
    assert q.grad.shape == q.shape and v.grad.shape == v.shape


# ---------------------------------------------------------------------------
# The deepseek smoke model
# ---------------------------------------------------------------------------


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
    return fops.ref.calls, mops.ref.calls


def test_forward_matches_jax_with_its_aux(pair):
    want, want_aux = pair.j_forward(pair.jp, jnp.asarray(pair.tokens))
    before = _calls()
    got, aux = tapi.forward(pair.tp, pair.tcfg,
                            {"tokens": torch.from_numpy(pair.tokens)})
    # three MLA layers (the prefix block and two periods), K2 once each
    assert np.subtract(_calls(), before).tolist() == [3, 0]
    assert got.shape == (B, T, pair.tcfg.vocab_size)
    _close(want, got)
    assert float(aux) > 0
    _close(want_aux, aux, 1e-5)


def test_prefill_matches_jax_with_its_whole_cache(pair):
    want, jcache = pair.j_prefill(pair.jp, jnp.asarray(pair.tokens))
    got, tcache = tapi.prefill(pair.tp, pair.tcfg,
                               {"tokens": torch.from_numpy(pair.tokens)})
    assert sorted(tcache) == ["periods", "prefix"]
    assert tcache["periods"]["sub0"]["attn"]["ckv"].shape == (2, B, T, 32)
    _close(want, got)
    _tree_close(jcache, tcache)


@pytest.mark.parametrize("per_slot", [False, True], ids=["scalar", "per_slot"])
def test_token_by_token_decode_matches_jax(pair, per_slot):
    """Decode steps from an empty cache at a scalar or per-slot position:
    the logits and the whole state (prefix and periods, written in place)
    agree with JAX at every step."""
    jstate = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                          japi.init_decode_state(pair.jcfg, B, MAX_LEN))
    tstate = tapi.allocate_decode_state(pair.tcfg, B, MAX_LEN, "cpu")
    pos = np.array([0, 4], np.int32) if per_slot else np.int32(0)
    for t in range(6):
        toks = pair.tokens[:, t]
        jl, jstate = pair.j_decode(pair.jp, jstate, jnp.asarray(toks),
                                   jnp.asarray(pos))
        before = _calls()
        tl, tstate2 = tapi.decode_step(pair.tp, pair.tcfg, tstate,
                                       torch.from_numpy(toks),
                                       torch.from_numpy(np.asarray(pos)))
        # every decode step runs mla_decode in each of the 3 layers
        assert np.subtract(_calls(), before).tolist() == [0, 3]
        assert tstate2 is tstate
        _close(jl, tl)
        _tree_close(jstate, tstate)
        pos = pos + 1


def test_prefill_equals_decode_dropless():
    """The port's own consistency at smoke size: prefill of the prompt gives
    the last logits and the whole latent cache that token-by-token decode
    gives, dropless."""
    cfg = _f32(tconfig.get_arch(ARCH).smoke)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=-1.0))
    params = tapi.init_params(torch.Generator().manual_seed(3), cfg)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, T)))
    full, _ = tapi.forward(params, cfg, {"tokens": toks})
    last, cache = tapi.prefill(params, cfg, {"tokens": toks})
    torch.testing.assert_close(last[:, 0], full[:, -1], atol=ATOL, rtol=0)
    state = tapi.allocate_decode_state(cfg, B, T, "cpu")
    for t in range(T):
        logits, state = tapi.decode_step(params, cfg, state, toks[:, t],
                                         torch.full((B,), t, dtype=torch.int32))
        torch.testing.assert_close(logits, full[:, t], atol=ATOL, rtol=0)
    for a, b in zip(jax.tree_util.tree_leaves(cache),
                    jax.tree_util.tree_leaves(state)):
        torch.testing.assert_close(a, b, atol=ATOL, rtol=0)


def test_input_specs_of_the_decode_cell():
    """decode_32k's inputs: one token a row and the latent cache of every
    layer (the prefix block's and the periods' stacked), as the reference
    lays them out."""
    from repro_torch.configs.deepseek_v2_236b import CARD

    specs = tapi.input_specs(CARD, tconfig.LM_SHAPES["decode_32k"])
    assert specs["tokens"].shape == (128,)
    state = specs["state"]
    assert state["prefix"]["blk0"]["attn"]["ckv"] == TensorSpec(
        (128, 32768, 512), torch.bfloat16)
    assert state["periods"]["sub0"]["attn"]["krope"] == TensorSpec(
        (3, 128, 32768, 64), torch.bfloat16)


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def test_train_card_param_count_matches_jax():
    """deepseek's TRAIN_CARD (layer 0, MLA and the dense FFN, at every
    published width) counts what the JAX package counts for the same cut:
    1,386,562,560, of which the embedding and the untied head 1.049 B, the
    dense SwiGLU FFN 189 M and MLA (with its norms) the rest, 149 M."""
    from repro_torch.configs.deepseek_v2_236b import TRAIN_CARD
    jcfg = dataclasses.replace(jax_get_arch(ARCH).model, num_layers=1)
    n = tapi.param_count(TRAIN_CARD)
    assert n == japi.param_count(jcfg) == 1_386_562_560
    d, v, f = TRAIN_CARD.d_model, TRAIN_CARD.vocab_size, \
        TRAIN_CARD.moe.d_ff_dense
    assert 2 * v * d == 1_048_576_000 and 3 * d * f == 188_743_680
    assert 149e6 < n - 2 * v * d - 3 * d * f < 150e6
    assert TRAIN_CARD.ffn_kinds() == ["dense"]
    assert TRAIN_CARD.attention == tconfig.get_arch(ARCH).model.attention


def test_train_main_runs_the_smoke_config(tmp_path, capsys):
    """``launch/train.py`` trains the MLA smoke model on the CPU (the plain
    attention and its autograd at hd 24, hd_v 16), two steps."""
    from repro_torch.launch import train as ttrain
    losses = ttrain.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                          "--steps", "2", "--batch", "2", "--seq", "16",
                          "--ckpt-dir", str(tmp_path), "--log-every", "1"])
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert "arch=deepseek-v2-smoke" in capsys.readouterr().out
    assert (tmp_path / "step_000000002").is_dir()


def test_a_stack_cut_to_its_prefix_block_runs():
    """A stack cut to its dense prefix layer (as ``TRAIN_CARD`` is) has an
    empty period, which the port runs (the reference's scan over it
    refuses: no values to scan over).  Its logits equal the reference's
    two-layer smoke model whose MoE layer adds nothing to the residual
    stream (its attention's and experts' output projections zeroed) at
    ``ATOL``; it trains and prefills."""
    jcfg = dataclasses.replace(_f32(jax_get_arch(ARCH).smoke), num_layers=2)
    tcfg = dataclasses.replace(_f32(tconfig.get_arch(ARCH).smoke),
                               num_layers=1)
    jp = jax.tree.map(np.array, _init(jax.random.key(3), jcfg))  # writable
    per = jp["stack"]["periods"]["sub0"]
    for leaf in (per["attn"]["wo"]["w"], per["ffn_moe"]["w_down"],
                 per["ffn_moe"]["shared"]["w_down"]["w"]):
        leaf[...] = 0.0
    tree = {**jp, "stack": {"prefix": jp["stack"]["prefix"]}}
    tp = params_from_jax(tree, "cpu")
    tp["stack"]["periods"] = {}
    assert jax.tree_util.tree_structure(tp) == jax.tree_util.tree_structure(
        tapi.init_params(torch.Generator().manual_seed(0), tcfg))
    tokens = np.random.default_rng(4).integers(
        0, tcfg.vocab_size, (B, T)).astype(np.int32)
    want, _ = japi.forward(jp, jcfg, {"tokens": tokens}, mode="train",
                           remat="none")
    got, _ = tapi.forward(tp, tcfg, {"tokens": torch.from_numpy(tokens)},
                          remat="none")
    _close(want, got)
    loss, _ = tapi.loss_fn(tp, tcfg, {"tokens": torch.from_numpy(tokens)})
    assert torch.isfinite(loss)
    logits, cache = tapi.prefill(tp, tcfg, {"tokens": torch.from_numpy(tokens)})
    assert cache["periods"] == {} and set(cache) == {"prefix", "periods"}
    _close(np.asarray(want)[:, -1:], logits)
