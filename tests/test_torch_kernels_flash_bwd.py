"""The flash-attention backward's plain version, the grad guard of the
forward-only kernels, and the server's admission check.

``attention_bwd_ref`` (the yardstick of ``csrc/flash_attention_bwd.cu`` on
the card) is held against autograd over the port's ``attention_ref`` and
against ``jax.vjp`` of the JAX ``ref.py``, at ``tests/test_kernels.py``'s
shapes and tolerance (f32: 3e-5 atol + 1e-2 rtol).  The Pallas kernel is
forward-only, so there is no TPU backward to compare with.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import attention_ref as jax_fref
from repro.models import layers as jax_layers
from repro_torch.core.config import get_arch
from repro_torch.kernels._grad import refuse_grad
from repro_torch.kernels.decode_attention import ops as dops
from repro_torch.kernels.flash_attention import bwd, ops as fops, ref as fref
from repro_torch.kernels.rwkv6_scan import ops as kops
from repro_torch.kernels.ssm_scan import ops as sops
from repro_torch.launch import serve as tserve
from repro_torch.models import api as tapi

TOL = dict(atol=3e-5, rtol=1e-2)

# tests/test_kernels.py's flash shapes (B, Hq, Hkv, Sq, Sk, hd, causal) with
# its q_offset (Sk - Sq when causal), one q_offset of the port's own, and
# two value widths of their own, hd given as (hd, hd_v): the deepseek
# smoke's (24, 16) with a query offset, and MLA's (192, 128)
BWD_CASES = [
    (2, 4, 2, 128, 128, 64, True, 0),
    (1, 8, 8, 257, 257, 64, True, 0),
    (2, 4, 1, 64, 320, 128, False, 0),
    (1, 2, 2, 1, 200, 64, False, 0),
    (1, 16, 4, 96, 96, 128, True, 0),
    (1, 4, 2, 40, 104, 32, True, 64),   # q_offset, Sq < Sk
    (1, 2, 1, 1, 50, 16, True, 49),     # one query at the end of its keys
    (2, 4, 4, 40, 70, (24, 16), True, 30),
    (1, 2, 2, 64, 64, (192, 128), True, 0),
]


def case_id(value):
    """A (hd, hd_v) pair's id, e.g. "24x16"; the others keep pytest's."""
    return f"{value[0]}x{value[1]}" if isinstance(value, tuple) else None


def widths(hd):
    """(hd, hd_v) of a case's hd entry."""
    return hd if isinstance(hd, tuple) else (hd, hd)


def _inputs(B, Hq, Hkv, Sq, Sk, hd, seed=0):
    rng = np.random.default_rng(seed)
    hd, hd_v = widths(hd)
    shapes = [(B, Hq, Sq, hd), (B, Hkv, Sk, hd), (B, Hkv, Sk, hd_v),
              (B, Hq, Sq, hd_v)]
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _autograd(q, k, v, do, causal, off):
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = fref.attention_ref(*ts, causal=causal, q_offset=off)
    grads = torch.autograd.grad(out, ts, torch.from_numpy(do))
    return out.detach(), grads


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,hd,causal,off", BWD_CASES,
                         ids=case_id)
def test_bwd_ref_matches_autograd_and_jax(B, Hq, Hkv, Sq, Sk, hd, causal, off):
    """The plain backward against autograd over the plain forward and
    against ``jax.vjp`` of the JAX kernel's oracle (one width) or, where V
    has a width of its own, which that oracle does not take, of the JAX
    model's ``layers.attention`` (as MLA's expanded branch calls it) at
    2e-3."""
    q, k, v, do = _inputs(B, Hq, Hkv, Sq, Sk, hd)
    out, want = _autograd(q, k, v, do, causal, off)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    lse = fref.attention_lse_ref(tq, tk, causal=causal, q_offset=off)
    got = fref.attention_bwd_ref(tq, tk, tv, out, lse, tdo, causal=causal,
                                 q_offset=off)
    jfn, jtol = (jax_fref, TOL) if not isinstance(hd, tuple) else \
        (jax_layers.attention, dict(atol=2e-3, rtol=2e-3))
    _, vjp = jax.vjp(lambda a, b, c: jfn(a, b, c, causal=causal,
                                         q_offset=off), q, k, v)
    for g, w, j in zip(got, want, vjp(jnp.asarray(do))):
        assert g.shape == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(j), **jtol)


def test_lse_ref_is_the_rows_logsumexp():
    q, k, _, _ = _inputs(1, 4, 2, 40, 104, 32)
    tq, tk = torch.from_numpy(q), torch.from_numpy(k)
    lse = fref.attention_lse_ref(tq, tk, causal=True, q_offset=64)
    s = torch.einsum("hqd,hkd->hqk", tq[0], tk[0].repeat_interleave(2, 0))
    s = s / math.sqrt(32)
    vis = torch.arange(104)[None, :] <= (64 + torch.arange(40))[:, None]
    want = torch.logsumexp(s.masked_fill(~vis, -math.inf), -1)
    np.testing.assert_allclose(lse[0].numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-6)


def test_rows_without_a_visible_key_get_zero_gradient():
    """A causal query before every key (q_offset < 0) has lse = +inf, output
    0 and gradient 0; the rows that do see keys are unaffected."""
    q, k, v, do = _inputs(1, 2, 2, 8, 8, 16, seed=3)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    lse = fref.attention_lse_ref(tq, tk, causal=True, q_offset=-3)
    assert torch.isinf(lse[..., :3]).all() and (lse[..., :3] > 0).all()
    assert torch.isfinite(lse[..., 3:]).all()
    out, want = _autograd(q, k, v, do, True, -3)
    dq, dk, dv = fref.attention_bwd_ref(tq, tk, tv, out, lse, tdo,
                                        causal=True, q_offset=-3)
    assert torch.isfinite(dq).all() and (dq[..., :3, :] == 0).all()
    for g, w in zip((dq, dk, dv), want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_function_matches_autograd_over_the_plain_version(dtype):
    """``FlashAttention`` (the card's autograd path) run on CPU tensors,
    where its forward and backward take the plain versions: the same
    gradients as autograd over ``attention_ref``, in the inputs' dtype."""
    q, k, v, do = _inputs(2, 4, 2, 40, 40, 16, seed=1)
    ts = [torch.from_numpy(x).to(dtype).requires_grad_() for x in (q, k, v)]
    out = fops.FlashAttention.apply(*ts, True, 0)
    got = torch.autograd.grad(out, ts, torch.from_numpy(do).to(dtype))
    ref_out = fref.attention_ref(*ts, causal=True, q_offset=0)
    want = torch.autograd.grad(ref_out, ts, torch.from_numpy(do).to(dtype))
    assert out.grad_fn is not None and torch.equal(out, ref_out)
    tol = TOL if dtype == torch.float32 else dict(atol=3e-2, rtol=1e-2)
    for g, w in zip(got, want):
        assert g.dtype == dtype
        np.testing.assert_allclose(g.float().numpy(), w.float().numpy(), **tol)


def test_forward_with_lse_is_the_plain_pair():
    """``flash_attention_fwd`` (the forward with its row log-sum-exps, as
    ``FlashAttention.forward`` launches it) gives the plain output and row
    log-sum-exps on CPU tensors, and checks its inputs."""
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(1, 4, 2, 20, 52, 16))
    out, lse = fops.flash_attention_fwd(q, k, v, q_offset=32)
    assert torch.equal(out, fref.attention_ref(q, k, v, q_offset=32))
    assert torch.equal(lse, fref.attention_lse_ref(q, k, q_offset=32))
    assert lse.dtype == torch.float32 and lse.shape == (1, 4, 20)
    with pytest.raises(ValueError, match="contiguous"):
        fops.flash_attention_fwd(q.transpose(2, 3).contiguous().transpose(2, 3),
                                 k, v)


def test_cpu_flash_attention_is_differentiable():
    q, k, v, _ = _inputs(1, 2, 2, 8, 8, 16)
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = fops.flash_attention(*ts, causal=True)
    assert out.grad_fn is not None


def test_bwd_wrapper_checks_its_inputs():
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(1, 4, 2, 8, 8, 16))
    lse = fref.attention_lse_ref(q, k)
    good = (q, k, v, q.clone(), lse, do)
    dq, dk, dv = bwd.flash_attention_bwd(*good)
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)
    bad = [
        (q, k, v, q, lse[..., :4], do),                    # lse shape
        (q, k, v, q, lse.double(), do),                    # lse dtype
        (q, k, v, q, lse, do[..., :8]),                    # do shape
        (q, k.to(torch.bfloat16), v, q, lse, do),          # mixed dtypes
        (q, k, v, q, lse, do.transpose(2, 3).contiguous().transpose(2, 3)),
    ]
    for args in bad:
        with pytest.raises((ValueError, TypeError)):
            bwd.flash_attention_bwd(*args)
    with pytest.raises(ValueError, match="does not match"):
        bwd.flash_attention_bwd(q, k[:, :1].repeat(1, 3, 1, 1).contiguous(),
                                v[:, :1].repeat(1, 3, 1, 1).contiguous(), q,
                                lse, do)


@pytest.mark.parametrize("dtype,hd,want", [
    (torch.bfloat16, 64, "tensor_cores"), (torch.bfloat16, 128, "tensor_cores"),
    (torch.bfloat16, 16, "tensor_cores"), (torch.bfloat16, 36, "cuda_cores"),
    (torch.float32, 64, "tensor_cores"), (torch.float32, 32, "tensor_cores"),
    (torch.float32, 36, "tensor_cores"), (torch.float32, 30, "cuda_cores"),
    (torch.float32, 128, "cuda_cores"), (torch.float32, 68, "cuda_cores"),
])
def test_route_by_dtype_and_head_dim(dtype, hd, want):
    """bf16 rows that TMA can describe (hd % 8 == 0) go to wgmma, f32 rows
    of whole 16-byte pieces (hd % 4 == 0) up to hd 64 to 3xTF32, the rest
    to the CUDA cores."""
    assert bwd.route(dtype, hd) == want


@pytest.mark.parametrize("dtype,hd,hd_v,want", [
    (torch.bfloat16, 192, 128, "tensor_cores"),   # MLA
    (torch.bfloat16, 24, 16, "tensor_cores"),     # the deepseek smoke's
    (torch.bfloat16, 136, 100, "cuda_cores"),     # hd_v rows TMA cannot take
    (torch.bfloat16, 36, 32, "cuda_cores"),
    (torch.float32, 24, 16, "tensor_cores"),
    (torch.float32, 64, 36, "tensor_cores"),
    (torch.float32, 192, 128, "cuda_cores"),      # above 64
    (torch.float32, 24, 18, "cuda_cores"),        # hd_v not whole 16 bytes
])
def test_route_by_dtype_and_both_widths(dtype, hd, hd_v, want):
    """Both widths must suit a route: bf16 on wgmma where both are
    multiples of 8, f32 on 3xTF32 where both are multiples of 4 up to 64."""
    assert bwd.route(dtype, hd, hd_v) == want


def test_scratch_bytes_at_a_value_width_of_its_own():
    """Split scratch at MLA's (192, 128), B 1, 2 heads, S 300, 132 SMs: the
    dK/dV and dQ walks split 5 ways each; a dK/dV split takes a (64, 192)
    dK and a (64, 128) dV slot, a dQ split a (64, 192) slot.  The smoke's
    (24, 16) over 70 keys at offset 30 splits the dQ walk 2 ways, (64, 64)
    slots; nothing unsplit takes room."""
    def m(*shape, dtype=torch.bfloat16):
        return torch.empty(shape, dtype=dtype, device="meta")

    q, k = m(1, 2, 300, 192), m(1, 2, 300, 192)
    assert bwd.splits(1, 2, 2, 300, 300, True, 0, 132) == (5, 5)
    assert bwd.scratch_bytes(q, k, 132, hd_v=128) == \
        4 * 64 * (2 * 5 * 5 * (192 + 128) + 2 * 5 * 5 * 192)
    assert bwd.scratch_bytes(q, k, 132, hd_v=128, via="cuda_cores") == 0
    # f32 at hd 192 takes the CUDA cores, which never split
    assert bwd.scratch_bytes(m(1, 2, 300, 192, dtype=torch.float32),
                             m(1, 2, 300, 192, dtype=torch.float32), 132,
                             hd_v=128) == 0
    q, k = m(2, 4, 40, 24, dtype=torch.float32), m(2, 4, 70, 24,
                                                   dtype=torch.float32)
    assert bwd.splits(2, 4, 4, 40, 70, True, 30, 132) == (1, 2)
    assert bwd.scratch_bytes(q, k, 132, q_offset=30, hd_v=16) == \
        4 * 64 * 2 * 4 * 1 * 2 * 64
    assert bwd.scratch_bytes(m(2, 128, 512, 192), m(2, 128, 512, 192), 132,
                             hd_v=128) == 0


@pytest.mark.parametrize("shape,want", [
    ((4, 16, 16, 512, 512, True, 0), (1, 1)),     # qwen's training step
    ((2, 32, 16, 512, 512, True, 0), (1, 1)),     # 256 dK/dV blocks: whole
    ((1, 64, 8, 512, 512, True, 0), (5, 1)),      # jamba's GQA 64/8
    ((2, 16, 16, 128, 512, True, 384), (1, 5)),   # few queries, many keys
    ((2, 4, 1, 64, 320, False, 0), (4, 5)),       # at most the walk's tiles
    ((1, 16, 4, 96, 96, True, 0), (8, 2)),        # at most MAX_SPLITS
    ((1, 2, 1, 1, 50, True, 49), (2, 1)),
    # MLA's shapes (the split depends on no width): TRAIN_CARD's step, 64
    # queries over 300 keys (128 dQ blocks), and 2 heads over 300
    ((2, 128, 128, 512, 512, True, 0), (1, 1)),
    ((1, 128, 128, 64, 300, True, 236), (1, 3)),
    ((1, 2, 2, 300, 300, True, 0), (5, 5)),
])
def test_splits_only_where_a_grid_leaves_sms_idle(shape, want):
    assert bwd.splits(*shape, sm_count=132) == want


@pytest.mark.parametrize("shape", [
    (1, 1, 1, 1, 1, True, 0), (1, 1, 1, 64, 64, True, -100),
    (3, 12, 4, 300, 700, False, 0), (1, 128, 1, 4096, 4096, True, 0),
    (1, 4, 4, 10, 5000, True, 4990),
])
def test_splits_are_whole_and_bounded(shape):
    B, Hq, Hkv, Sq, Sk, causal, off = shape
    for sm in (1, 16, 132):
        n_kv, n_q = bwd.splits(*shape, sm_count=sm)
        for n, blocks in ((n_kv, B * Hkv * -(-Sk // 64)),
                          (n_q, B * Hq * -(-Sq // 64))):
            assert 1 <= n <= bwd.MAX_SPLITS
            assert n == 1 or blocks < sm


def test_bwd_route_choice_is_checked_before_the_device():
    """``via`` picks a route that applies or raises, on any device; on CPU
    tensors every route gives the plain version."""
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(1, 4, 2, 8, 8, 30))
    lse = fref.attention_lse_ref(q, k)
    args = (q, k, v, fref.attention_ref(q, k, v), lse, do)
    want = fref.attention_bwd_ref(*args)
    for via in (None, "cuda_cores"):
        for g, w in zip(bwd.flash_attention_bwd(*args, via=via), want):
            assert torch.equal(g, w)
    for via in ("tensor_cores", "simt"):
        with pytest.raises(ValueError, match="no route"):
            bwd.flash_attention_bwd(*args, via=via)


# ---------------------------------------------------------------------------
# The grad guard of the forward-only kernels
# ---------------------------------------------------------------------------


def test_refuse_grad_raises_only_under_grad_with_an_input_that_requires_it():
    x = torch.zeros(3, requires_grad=True)
    y = torch.zeros(3)
    with pytest.raises(RuntimeError, match="ssm_scan: the backward of this "
                       "CUDA kernel is not ported yet"):
        refuse_grad("ssm_scan", y, x)
    refuse_grad("ssm_scan", y, y)                  # nothing requires grad
    refuse_grad("ssm_scan", y, None, 3)            # non-tensors are ignored
    with torch.no_grad():
        refuse_grad("ssm_scan", x)                 # grad mode is off
    with torch.inference_mode():
        refuse_grad("ssm_scan", x)


def test_cpu_plain_versions_stay_differentiable():
    """The guard sits on the CUDA path only: on CPU tensors K1, K3 and K4
    give their plain versions, with a gradient."""
    g = torch.Generator().manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=g).requires_grad_()

    out = dops.decode_attention(rnd(2, 4, 16), rnd(2, 2, 8, 16),
                                rnd(2, 2, 8, 16),
                                torch.tensor([3, 8], dtype=torch.int32))
    y, h = sops.ssm_scan(rnd(1, 5, 8), torch.rand(1, 5, 8, generator=g),
                         rnd(8, 8), rnd(1, 5, 8), rnd(1, 5, 8), rnd(8),
                         torch.zeros(1, 8, 8))
    o, s = kops.rwkv6_scan(rnd(2, 5, 8), rnd(2, 5, 8), rnd(2, 5, 8),
                           -torch.rand(2, 5, 8, generator=g) - 0.1, rnd(2, 8),
                           torch.zeros(2, 8, 8))
    for t in (out, y, h, o, s):
        assert t.grad_fn is not None


# ---------------------------------------------------------------------------
# Admission of a prompt that does not fit a slot
# ---------------------------------------------------------------------------


def _jamba_smoke():
    cfg = get_arch("jamba-1.5-large-398b").smoke
    return dataclasses.replace(cfg, param_dtype="float32",
                               compute_dtype="float32")


def test_prefill_admission_rejects_a_prompt_of_max_len_before_taking_a_slot():
    cfg = _jamba_smoke()
    server = tserve.BatchedServer(cfg, 2, 16, device="cpu")
    server.load(tapi.init_params(torch.Generator().manual_seed(0), cfg))
    for n in (20, 16):
        with pytest.raises(ValueError, match="does not fit a slot"):
            server.admit(tserve.Request(0, np.arange(n) % cfg.vocab_size, 4))
        assert server.slot_req == [None, None]
        assert server.slot_pos.tolist() == [0, 0]
    req = tserve.Request(1, np.arange(15) % cfg.vocab_size, 1)
    assert server.admit(req) and server.slot_req[0] is req
    server.step()
    assert req.done and len(req.out) == 1
