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
order); ``launches`` counts calls.  Where those grids would leave SMs idle
(few KV heads under GQA, few queries over many keys), the tensor-core route
splits each block's walk over several blocks (:func:`splits`); the last of
them to finish adds their partial sums in a fixed order, so the result
stays the same from run to run.

The route, by dtype and head_dim (:func:`route`):

* bfloat16, head_dim a multiple of 8: the tensor cores, ``wgmma`` (inputs
  by TMA; P and dS rounded to bf16 for the dV, dK and dQ products);
* float32, head_dim a multiple of 4 up to 64: the tensor cores in 3xTF32
  (``mma.sync``; each operand split into two TF32 parts, three products);
* any other head_dim (up to 128): the CUDA cores, in f32 (at hd 128 in f32
  they beat 3xTF32 on an H100, ``PERF.md``).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build, counters, sm_count
from repro_torch.kernels.flash_attention import ref
from repro_torch.kernels.flash_attention.ref import attention_bwd_ref

# kernel launches (one per call), counted where the kernel is launched and
# nowhere else
launches = 0

MAX_HEAD_DIM = 128
MAX_HEADS = 65535                 # as the forward, whose lse it reads
TILE = 64                         # queries or keys a block takes at a time
WAVES = 2                         # blocks per SM that a split aims at
MAX_SPLITS = 8
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 10 + [_I] * 12 + [_P] * 3
ROUTES = ("tensor_cores", "cuda_cores")


def route(dtype: torch.dtype, head_dim: int) -> str:
    """The products' route of a CUDA call: "tensor_cores" (wgmma for bf16
    with head_dim % 8 == 0, 3xTF32 for f32 with head_dim % 4 == 0 up to
    64), else "cuda_cores"."""
    if dtype == torch.bfloat16:
        tc = head_dim % 8 == 0
    else:
        tc = head_dim % 4 == 0 and head_dim <= 64
    return ROUTES[0] if tc else ROUTES[1]


def _tiles(n: int) -> int:
    return -(-n // TILE)


def splits(B: int, Hq: int, Hkv: int, Sq: int, Sk: int, causal: bool,
           q_offset: int, sm_count: int) -> Tuple[int, int]:
    """Blocks the walk of each dK/dV tile and of each dQ tile is split over
    on the tensor-core route.  A grid with a block for every SM walks whole
    (splitting 256 dK/dV blocks in two measured slower on an H100,
    ``PERF.md``); a smaller one splits for about ``WAVES`` blocks per SM, at
    most ``MAX_SPLITS`` ways and at most as many as the longest walk has
    tiles (key block 0's query tiles over the group; the last query tile's
    key tiles)."""
    nq, nk = _tiles(Sq), _tiles(Sk)
    first = max(0, -q_offset) // TILE if causal else 0
    kv_items = Hq // Hkv * max(0, nq - first)
    k_end = min(Sk, q_offset + Sq) if causal else Sk
    q_items = _tiles(max(0, k_end))

    def split(blocks, items):
        if blocks >= sm_count or items <= 1:
            return 1
        return min(MAX_SPLITS, items, -(-WAVES * sm_count // blocks))

    return split(B * Hkv * nk, kv_items), split(B * Hq * nq, q_items)


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
                        *, causal: bool = True, q_offset: int = 0,
                        via: str | None = None):
    """Gradients (dq, dk, dv) of ``flash_attention(q, k, v)`` for the output
    gradient ``do``, from the forward's output ``o`` and its row log-sum-
    exps ``lse`` (B, Hq, Sq) f32 (+inf on a row with no visible key).
    Accumulates in f32; returns each gradient in its input's dtype.  On the
    card the products take :func:`route`'s route, or ``via`` ("cuda_cores"
    takes any head_dim; "tensor_cores" raises where the route does not
    apply), which ``chip_smoke.py`` uses to time the two side by side."""
    global launches
    _check(q, k, v, o, lse, do)
    hd = q.shape[-1]
    via = via or route(q.dtype, hd)
    if via not in ROUTES or (via == ROUTES[0] and route(q.dtype, hd) != via):
        raise ValueError(f"flash_attention_bwd: no route {via!r} for "
                         f"{q.dtype} head_dim {hd}")
    if q.device.type == "cpu":
        return attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                 q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: no kernel for {q.device}")
    B, Hq, Sq, _ = q.shape
    _, Hkv, Sk, _ = k.shape
    fn = _build.function("flash_attention_bwd", _ARGTYPES)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    n_kv, n_q = (1, 1) if via == ROUTES[1] else splits(
        B, Hq, Hkv, Sq, Sk, causal, q_offset, sm_count(q.device))
    part = cnt = None
    if n_kv > 1 or n_q > 1:   # each split's partial sums, and the counters
        kv_tiles, q_tiles = B * Hkv * _tiles(Sk), B * Hq * _tiles(Sq)
        slots = (2 * kv_tiles * n_kv if n_kv > 1 else 0) \
            + (q_tiles * n_q if n_q > 1 else 0)
        part = torch.empty(slots * TILE * (64 if hd <= 64 else 128),
                           dtype=torch.float32, device=q.device)
        # one per dK/dV tile, then one per dQ tile
        cnt = counters("flash_attention_bwd", q.device, kv_tiles + q_tiles)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
             dk.data_ptr(), dv.data_ptr(), B, Hq, Hkv, Sq, Sk, hd, int(causal),
             int(q_offset), _DTYPES[q.dtype], int(via == ROUTES[0]), n_kv, n_q,
             None if part is None else part.data_ptr(),
             None if cnt is None else cnt.data_ptr(), stream)
    _build.check("flash_attention_bwd", err)
    launches += 1
    return dq, dk, dv


__all__ = ["flash_attention_bwd", "route", "splits", "attention_bwd_ref",
           "ref"]
