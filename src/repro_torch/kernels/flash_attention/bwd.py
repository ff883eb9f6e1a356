"""Flash-attention backward op: the Hopper kernel for CUDA tensors, the
plain version for CPU tensors.

A CUDA tensor launches ``csrc/flash_attention_bwd.cu`` or raises; nothing
routes it to the plain version.  The TPU package has no backward kernel to
carry over (the Pallas kernel is forward-only; the JAX model differentiates
its XLA attention), so this is a new kernel, held against
:func:`ref.attention_bwd_ref` and autograd over :func:`ref.attention_ref`.
A call is three launches on one stream: the row dot products D = rowsum(dO
* O), then dK and dV per KV block over the query heads of its group, then
dQ per query block (no atomics: the result does not depend on block
order); ``launches`` counts calls.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ref
from repro_torch.kernels.flash_attention.ref import attention_bwd_ref

# kernel launches (one per call), counted where the kernel is launched and
# nowhere else
launches = 0

MAX_HEAD_DIM = 128
MAX_HEADS = 65535                 # B * Hq is the grid's y extent
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 10 + [_I] * 9 + [_P]


def _check(q, k, v, o, lse, do) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape \
            or o.shape != q.shape or do.shape != q.shape:
        raise ValueError("flash_attention_bwd: want q, o, do (B, Hq, Sq, hd) "
                         "and k, v (B, Hkv, Sk, hd); got "
                         f"{[tuple(t.shape) for t in (q, k, v, o, do)]}")
    B, Hq, Sq, hd = q.shape
    _, Hkv, _, hd_k = k.shape
    if k.shape[0] != B or hd_k != hd or Hq % Hkv:
        raise ValueError(f"flash_attention_bwd: q {tuple(q.shape)} does not "
                         f"match k {tuple(k.shape)}")
    if hd > MAX_HEAD_DIM or B * Hq > MAX_HEADS:
        raise ValueError(f"flash_attention_bwd: want head_dim <= "
                         f"{MAX_HEAD_DIM} and B * Hq <= {MAX_HEADS}; got "
                         f"{tuple(q.shape)}")
    if tuple(lse.shape) != (B, Hq, Sq) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd: want lse ({B}, {Hq}, {Sq}) "
                         f"float32; got {lse.dtype} {tuple(lse.shape)}")
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in (k, v, o, do)):
        raise TypeError("flash_attention_bwd: q, k, v, o, do must share one "
                        f"dtype of {list(_DTYPES)}; got "
                        f"{[t.dtype for t in (q, k, v, o, do)]}")
    devices = {t.device for t in (q, k, v, o, lse, do)}
    if len(devices) != 1:
        raise ValueError(f"flash_attention_bwd: tensors on {devices}")
    if not all(t.is_contiguous() for t in (q, k, v, o, lse, do)):
        raise ValueError("flash_attention_bwd: tensors must be contiguous")


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        *, causal: bool = True, q_offset: int = 0):
    """Gradients (dq, dk, dv) of ``flash_attention(q, k, v)`` for the output
    gradient ``do``, from the forward's output ``o`` and its row log-sum-
    exps ``lse`` (B, Hq, Sq) f32 (+inf on a row with no visible key).
    Accumulates in f32; returns each gradient in its input's dtype."""
    global launches
    _check(q, k, v, o, lse, do)
    if q.device.type == "cpu":
        return attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                 q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: no kernel for {q.device}")
    B, Hq, Sq, hd = q.shape
    _, Hkv, Sk, _ = k.shape
    fn = _build.function("flash_attention_bwd", _ARGTYPES)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
             dk.data_ptr(), dv.data_ptr(), B, Hq, Hkv, Sq, Sk, hd, int(causal),
             int(q_offset), _DTYPES[q.dtype], stream)
    _build.check("flash_attention_bwd", err)
    launches += 1
    return dq, dk, dv


__all__ = ["flash_attention_bwd", "attention_bwd_ref", "ref"]
