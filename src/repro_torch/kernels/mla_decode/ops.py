"""Absorbed MLA decode op: the Hopper kernel for CUDA tensors, the plain
version for CPU tensors.

A CUDA tensor launches ``csrc/mla_decode.cu`` or raises; nothing routes it
to the plain version.  The kernel holds 16 query heads a block and splits
the KV axis over ``_num_splits`` blocks per (row, head chunk), each row's
valid keys shared out over them on the device; the last of them to finish
merges their partial states, so a call is one launch.  It has no TPU
counterpart: the reference computes this function in XLA einsums.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, counters, sm_count
from repro_torch.kernels._grad import refuse_grad
from repro_torch.kernels.mla_decode import ref
from repro_torch.kernels.mla_decode.ref import mla_decode_ref

# kernel launches (one per call), counted where the kernel is launched and
# nowhere else
launches = 0

HEADS = 16              # query heads a block holds (csrc/mla_decode.cu)
KEYS = 32               # keys a tile
MAX_LATENT = 512        # L at most: two output columns a thread of 256
WAVES = 2               # blocks per SM that _num_splits aims at
MAX_SPLITS = 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 8 + [_I] * 6 + [ctypes.c_float, _I, _P]


def _num_splits(B: int, H: int, T: int, sm_count: int) -> int:
    """Blocks the KV axis of a (row, head chunk) is split over: about
    ``WAVES`` blocks per SM, at most one per tile of the cache and at most
    ``MAX_SPLITS``."""
    blocks = B * -(-H // HEADS)
    return max(1, min(-(-T // KEYS), MAX_SPLITS,
                      -(-WAVES * sm_count // blocks)))


def _check(q_abs, q_rope, ckv, krope, kv_len) -> None:
    if q_abs.dim() != 3 or q_rope.dim() != 3 or ckv.dim() != 3 \
            or krope.dim() != 3:
        raise ValueError("mla_decode: want q_abs (B, H, L), q_rope (B, H, R), "
                         "ckv (B, T, L) and krope (B, T, R); got "
                         f"{tuple(q_abs.shape)}, {tuple(q_rope.shape)}, "
                         f"{tuple(ckv.shape)}, {tuple(krope.shape)}")
    B, H, L = q_abs.shape
    _, T, R = krope.shape
    if q_rope.shape[:2] != (B, H) or ckv.shape != (B, T, L) \
            or krope.shape[0] != B or q_rope.shape[2] != R:
        raise ValueError("mla_decode: shapes do not match: "
                         f"{tuple(q_abs.shape)}, {tuple(q_rope.shape)}, "
                         f"{tuple(ckv.shape)}, {tuple(krope.shape)}")
    if L % 8 or R % 8 or not 0 < L <= MAX_LATENT or R <= 0:
        raise ValueError("mla_decode: want L <= "
                         f"{MAX_LATENT} and R multiples of 8; got L {L}, R {R}")
    tensors = (q_abs, q_rope, ckv, krope)
    if q_abs.dtype not in _DTYPES or any(t.dtype != q_abs.dtype
                                         for t in tensors):
        raise TypeError("mla_decode: q_abs, q_rope, ckv, krope must share one "
                        f"dtype of {list(_DTYPES)}; got "
                        f"{[t.dtype for t in tensors]}")
    if kv_len.dtype != torch.int32 or tuple(kv_len.shape) != (B,):
        raise TypeError("mla_decode: kv_len must be int32 of shape "
                        f"({B},); got {kv_len.dtype} {tuple(kv_len.shape)}")
    devices = {t.device for t in tensors + (kv_len,)}
    if len(devices) != 1:
        raise ValueError(f"mla_decode: tensors on {devices}")
    if not all(t.is_contiguous() for t in tensors + (kv_len,)):
        raise ValueError("mla_decode: tensors must be contiguous")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("mla_decode: tensors must start on 16 bytes (the "
                         "kernel copies rows 16 bytes at a time)")


def mla_decode(q_abs: torch.Tensor, q_rope: torch.Tensor, ckv: torch.Tensor,
               krope: torch.Tensor, kv_len: torch.Tensor,
               scale: float) -> torch.Tensor:
    """ctx = softmax((q_abs ckv^T + q_rope krope^T) * scale) ckv over the
    positions t < kv_len[b] of each row.

    q_abs: (B, H, L); q_rope: (B, H, R); ckv: (B, T, L); krope: (B, T, R),
    one dtype; kv_len: (B,) int32; on one device.  Returns ctx (B, H, L) in
    q_abs.dtype; a row with kv_len <= 0 gives 0.
    """
    global launches
    _check(q_abs, q_rope, ckv, krope, kv_len)
    if q_abs.device.type == "cpu":
        return mla_decode_ref(q_abs, q_rope, ckv, krope, kv_len, scale)
    if q_abs.device.type != "cuda":
        raise ValueError(f"mla_decode: no kernel for {q_abs.device}")
    refuse_grad("mla_decode", q_abs, q_rope, ckv, krope)
    B, H, L = q_abs.shape
    T, R = krope.shape[1:]
    nsplit = _num_splits(B, H, T, sm_count(q_abs.device))
    fn = _build.function("mla_decode", _ARGTYPES)
    out = torch.empty_like(q_abs)
    ws = cnt = None
    if nsplit > 1:   # each split's (m, l) and f32 acc, and the counters
        ws = torch.empty(B * H * nsplit * (L + 2), dtype=torch.float32,
                         device=q_abs.device)
        cnt = counters("mla_decode", q_abs.device, B * -(-H // HEADS))
    stream = torch.cuda.current_stream(q_abs.device).cuda_stream
    err = fn(q_abs.data_ptr(), q_rope.data_ptr(), ckv.data_ptr(),
             krope.data_ptr(), kv_len.data_ptr(), out.data_ptr(),
             ws if ws is None else ws.data_ptr(),
             cnt if cnt is None else cnt.data_ptr(), B, H, T, L, R, nsplit,
             float(scale), _DTYPES[q_abs.dtype], stream)
    _build.check("mla_decode", err)
    launches += 1
    return out


__all__ = ["mla_decode", "mla_decode_ref", "ref"]
