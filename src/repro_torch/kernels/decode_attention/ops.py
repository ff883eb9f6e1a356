"""Flash-decode op: the Hopper kernel for CUDA tensors, the plain version
for CPU tensors.

A CUDA tensor launches ``csrc/decode_attention.cu`` or raises; nothing
routes it to the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import ref
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

# kernel launches, counted where the kernel is launched and nowhere else
launches = 0

GROUPS = (1, 2, 4, 8)   # query heads per KV head the kernel is built for
MAX_HEAD_DIM = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]


def _check(q, k, v, kv_len) -> None:
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("decode_attention: want q (B, Hq, hd) and k, v "
                         f"(B, Hkv, S, hd); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Hq, hd = q.shape
    _, Hkv, _, hd_k = k.shape
    if k.shape[0] != B or hd_k != hd or Hq % Hkv:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} does not "
                         f"match k {tuple(k.shape)}")
    if Hq // Hkv not in GROUPS or hd > MAX_HEAD_DIM:
        raise ValueError(f"decode_attention: group {Hq // Hkv} (of {GROUPS}) "
                         f"or head_dim {hd} (<= {MAX_HEAD_DIM}) unsupported")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("decode_attention: q, k, v must share one dtype of "
                        f"{list(_DTYPES)}; got {q.dtype}, {k.dtype}, {v.dtype}")
    if kv_len.dtype != torch.int32 or tuple(kv_len.shape) != (B,):
        raise TypeError("decode_attention: kv_len must be int32 of shape "
                        f"({B},); got {kv_len.dtype} {tuple(kv_len.shape)}")
    devices = {t.device for t in (q, k, v, kv_len)}
    if len(devices) != 1:
        raise ValueError(f"decode_attention: tensors on {devices}")
    if not all(t.is_contiguous() for t in (q, k, v, kv_len)):
        raise ValueError("decode_attention: tensors must be contiguous")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(hd)) v over positions < kv_len[b].

    q: (B, Hq, hd); k, v: (B, Hkv, S, hd); kv_len: (B,) int32, on the same
    device.  Returns (B, Hq, hd) in q.dtype; a row with kv_len <= 0 gives 0.
    """
    global launches
    _check(q, k, v, kv_len)
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for {q.device}")
    B, Hq, hd = q.shape
    _, Hkv, S, _ = k.shape
    fn = _build.function("decode_attention", _ARGTYPES)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
             out.data_ptr(), B, Hq, Hkv, S, hd, _DTYPES[q.dtype], stream)
    _build.check("decode_attention", err)
    launches += 1
    return out


__all__ = ["decode_attention", "decode_attention_ref", "ref"]
