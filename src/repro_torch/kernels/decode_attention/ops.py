"""Flash-decode op: the Hopper kernel for CUDA tensors, the plain version
for CPU tensors.

A CUDA tensor launches ``csrc/decode_attention.cu`` or raises; nothing
routes it to the plain version.  The kernel splits the KV axis over
``_num_splits`` blocks per (row, KV head); when there is more than one, the
last of them to finish merges their partial states, so a call is one launch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, counters, sm_count
from repro_torch.kernels._grad import refuse_grad
from repro_torch.kernels.decode_attention import ref
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

# kernel launches (one per call), counted where the kernel is launched and
# nowhere else
launches = 0

MAX_HEAD_DIM = 128
WAVES = 2               # blocks per SM that _num_splits aims at
MHA_TILES = 4           # key tiles a group-1 block takes before a split
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P]


def _key_tile(group: int, hd: int, dtype: torch.dtype) -> int:
    """Keys a block of the kernel takes per tile.  bf16 with a group of 5 or
    more and hd 64 or 128 runs on the tensor cores, 16 keys for each of 4
    warps.  Otherwise 8 warps of 32 lanes share a tile, by heads as far as
    the group (padded to 1, 2, 4, 8 or 16) goes and by keys for the rest,
    as far as a tile of K and V fits shared memory."""
    if dtype == torch.bfloat16 and group >= 5 and hd in (64, 128):
        return 64
    padded = 1 if group == 1 else 2 if group == 2 else 4 if group <= 4 else 8
    tile = 32 * 8 // padded
    elem = 2 if dtype == torch.bfloat16 else 4
    width = 32 if hd <= 32 else 64 if hd <= 64 else 128
    row_bytes = (width + 16 // elem) * elem
    return 128 if tile > 128 and row_bytes > 280 else tile


def _num_splits(B: int, Hkv: int, group: int, S: int, sm_count: int,
                tile: int) -> int:
    """Chunks of the KV axis per (row, KV head), each a whole number of key
    tiles: enough blocks for about ``WAVES`` blocks per SM where the tiles
    allow.  With one query per KV head (group 1) a block streams up to
    ``MHA_TILES`` tiles of up to 256 keys itself: below that a split's merge
    costs more than the split saves (measured on an H100, ``PERF.md``)."""
    tiles = -(-S // tile)
    if group == 1:
        return -(-tiles // MHA_TILES)
    blocks = B * Hkv * -(-group // 16)
    want = min(tiles, max(1, -(-WAVES * sm_count // blocks)))
    per = -(-tiles // want)            # tiles per chunk
    return -(-tiles // per)


def _chunk(S: int, tile: int, nsplit: int) -> int:
    """Keys per chunk: the kernel's tiles shared out over ``nsplit``."""
    tiles = -(-S // tile)
    return -(-tiles // nsplit) * tile


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
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"decode_attention: head_dim {hd} > {MAX_HEAD_DIM}")
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
    refuse_grad("decode_attention", q, k, v)
    B, Hq, hd = q.shape
    _, Hkv, S, _ = k.shape
    group = Hq // Hkv
    tile = _key_tile(group, hd, q.dtype)
    nsplit = _num_splits(B, Hkv, group, S, sm_count(q.device), tile)
    fn = _build.function("decode_attention", _ARGTYPES)
    out = torch.empty_like(q)
    ws = cnt = None
    if nsplit > 1:   # each split's (m, l) and f32 acc, and the counters
        ws = torch.empty(B * Hq * nsplit * (hd + 2), dtype=torch.float32,
                         device=q.device)
        # one per (row, KV head, chunk of 16 query heads)
        cnt = counters("decode_attention", q.device, B * Hkv * -(-group // 16))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
             out.data_ptr(), ws if ws is None else ws.data_ptr(),
             cnt if cnt is None else cnt.data_ptr(), B, Hq, Hkv, S, hd, nsplit,
             _chunk(S, tile, nsplit), _DTYPES[q.dtype], stream)
    _build.check("decode_attention", err)
    launches += 1
    return out


__all__ = ["decode_attention", "decode_attention_ref", "ref"]
