"""Flash-attention forward op: the Hopper kernel for CUDA tensors, the plain
version for CPU tensors.

A CUDA tensor launches ``csrc/flash_attention.cu`` or raises; nothing routes
it to the plain version.  There, bf16 with head dims that are multiples of 8
runs on the tensor cores (wgmma, K/V by TMA); f32, and bf16 of other head
dims, on the CUDA cores, register-tiled.  Q and K are ``hd`` wide (up to
192), V and the output ``hd_v`` wide: ``hd_v <= hd``, both in one 64-wide
class up to 128, or ``hd`` in (128, 192] with ``hd_v`` in (64, 128] (MLA's
expanded attention: 192 and 128); the scale is ``1 / sqrt(hd)``.

Under grad mode, with an input that requires grad, a CUDA call is a
``torch.autograd.Function``: its forward also writes each query row's
log-sum-exp, and its backward launches ``csrc/flash_attention_bwd.cu``
(:mod:`.bwd`), which takes every pair of widths the forward takes (MLA's
192 and 128 included).  Outside grad mode no log-sum-exp is written, so
serving runs the kernel exactly as before.  CPU tensors get
:func:`attention_ref`, which autograd differentiates.  A ``meta`` tensor
takes the CUDA route up to the launch and reports the kernel's :func:`cost`
to ``core.cost.analysis`` instead (a dry run); a CUDA call reports it too.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.core.cost.analysis import note, tensor_bytes
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import bwd, ref
from repro_torch.kernels.flash_attention.ref import (attention_lse_ref,
                                                     attention_ref)

# kernel launches, counted where the kernel is launched and nowhere else
launches = 0

MAX_HEAD_DIM = 192
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 5 + [_I] * 10 + [_P]


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 \
            or v.shape[:3] != k.shape[:3]:
        raise ValueError("flash_attention: want q (B, Hq, Sq, hd), k (B, Hkv, "
                         f"Sk, hd) and v (B, Hkv, Sk, hd_v); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Hq, _, hd = q.shape
    _, Hkv, _, hd_k = k.shape
    if k.shape[0] != B or hd_k != hd or Hq % Hkv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not "
                         f"match k {tuple(k.shape)}")
    ref.check_widths("flash_attention", hd, v.shape[3])
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention: q, k, v must share one dtype of "
                        f"{list(_DTYPES)}; got {q.dtype}, {k.dtype}, {v.dtype}")
    devices = {t.device for t in (q, k, v)}
    if len(devices) != 1:
        raise ValueError(f"flash_attention: tensors on {devices}")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("flash_attention: tensors must be contiguous")


def cost(q, k, v, with_lse: bool = False, pairs: int = None) -> tuple:
    """(FLOPs, bytes) of one forward call: the two products, q k^T and p v,
    over ``pairs`` (query, key) pairs a head, 2 B Hq pairs (hd + hd_v); q,
    k, v read once, the output (and each row's log-sum-exp, f32) written
    once.  ``pairs`` defaults to every pair, Sq Sk: causal masking is not
    subtracted, as the reference's XLA attention counts it; a caller that
    wants the visible pairs alone passes their number."""
    B, Hq, Sq, hd = q.shape
    Sk, hd_v = k.shape[2], v.shape[3]
    pairs = Sq * Sk if pairs is None else pairs
    out = B * Hq * Sq * hd_v * q.element_size()
    return (2 * B * Hq * pairs * (hd + hd_v),
            sum(tensor_bytes(t) for t in (q, k, v)) + out
            + (B * Hq * Sq * 4 if with_lse else 0))


def _launch(q, k, v, causal: bool, q_offset: int, with_lse: bool
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    global launches
    if q.device.type == "cpu":
        lse = attention_lse_ref(q, k, causal=causal, q_offset=q_offset) \
            if with_lse else None
        return attention_ref(q, k, v, causal=causal, q_offset=q_offset), lse
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    B, Hq, Sq, hd = q.shape
    _, Hkv, Sk, _ = k.shape
    hd_v = v.shape[3]
    out = q.new_empty((B, Hq, Sq, hd_v))
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device) \
        if with_lse else None
    note("flash_attention", cost, q, k, v, with_lse)
    if q.device.type == "meta":
        return out, lse
    fn = _build.function("flash_attention", _ARGTYPES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             None if lse is None else lse.data_ptr(), B, Hq, Hkv, Sq, Sk, hd,
             hd_v, int(causal), int(q_offset), _DTYPES[q.dtype], stream)
    _build.check("flash_attention", err)
    launches += 1
    return out, lse


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, q_offset: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse): the forward and each query row's log-sum-exp (B, Hq, Sq)
    f32, as :class:`FlashAttention` keeps them for the backward; the kernel
    for CUDA tensors, the plain versions for CPU tensors.  No autograd."""
    _check(q, k, v)
    return _launch(q, k, v, causal, q_offset, with_lse=True)


class FlashAttention(torch.autograd.Function):
    """The forward kernel, keeping the row log-sum-exps, and the backward
    kernel for its gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, q_offset: int):
        out, lse = _launch(q, k, v, causal, q_offset, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.q_offset = causal, q_offset
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = bwd.flash_attention_bwd(
            q, k, v, out, lse, dout.contiguous(), causal=ctx.causal,
            q_offset=ctx.q_offset)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """Softmax attention forward; query i sits at position q_offset + i.

    q: (B, Hq, Sq, hd); k: (B, Hkv, Sk, hd); v: (B, Hkv, Sk, hd_v), hd_v <=
    hd <= 192 as the module says, Hq % Hkv == 0 (query head h reads KV head
    h // group); scale 1 / sqrt(hd).  Returns (B, Hq, Sq, hd_v) in q.dtype, with a ``grad_fn``
    when grad mode is on and an input requires grad.
    """
    _check(q, k, v)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, q_offset=q_offset)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal, int(q_offset))
    return _launch(q, k, v, causal, q_offset, with_lse=False)[0]


__all__ = ["flash_attention", "flash_attention_fwd", "FlashAttention",
           "attention_ref", "bwd", "cost", "ref"]
