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

q and k are ``hd`` wide, v, o and do ``hd_v`` wide, in the forward's pairs
(:data:`ref.PAIRS`: ``hd_v <= hd``, both in one 64-wide class up to 128, or
MLA's ``hd`` in (128, 192] with ``hd_v`` in (64, 128]); the scale is
``1 / sqrt(hd)``.  The route, by dtype and widths (:func:`route`):

* bfloat16, hd and hd_v multiples of 8: the tensor cores, ``wgmma``
  (inputs by TMA; P and dS rounded to bf16 for the dV, dK and dQ products;
  at hd 192 the dK/dV block is two warpgroups, one for S, P and dV, one
  for dP, dS and dK, with P handed over in shared memory);
* float32, hd and hd_v multiples of 4 up to 64: the tensor cores in 3xTF32
  (``mma.sync``; each operand split into two TF32 parts, three products);
* any other widths (hd up to 192): the CUDA cores, in f32 (at hd 128 in f32
  they beat 3xTF32 on an H100, ``PERF.md``).

A ``meta`` tensor takes the CUDA route up to the launch and reports the
kernel's :func:`cost` to ``core.cost.analysis`` instead (a dry run); a CUDA
call reports it too.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.core.cost.analysis import note, tensor_bytes
from repro_torch.kernels import _build, counters, sm_count
from repro_torch.kernels.flash_attention import ref
from repro_torch.kernels.flash_attention.ref import attention_bwd_ref

# kernel launches (one per call), counted where the kernel is launched and
# nowhere else
launches = 0

MAX_HEAD_DIM = 192
MAX_HEADS = 65535                 # as the forward, whose lse it reads
TILE = 64                         # queries or keys a block takes at a time
WAVES = 2                         # blocks per SM that a split aims at
MAX_SPLITS = 8
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 10 + [_I] * 13 + [_P] * 3
ROUTES = ("tensor_cores", "cuda_cores")


def route(dtype: torch.dtype, head_dim: int, hd_v: int | None = None) -> str:
    """The products' route of a CUDA call: "tensor_cores" (wgmma for bf16
    with head_dim and hd_v multiples of 8, 3xTF32 for f32 with both
    multiples of 4 up to 64), else "cuda_cores".  ``hd_v`` defaults to
    ``head_dim``."""
    widths = (head_dim, head_dim if hd_v is None else hd_v)
    if dtype == torch.bfloat16:
        tc = all(d % 8 == 0 for d in widths)
    else:
        tc = all(d % 4 == 0 and d <= 64 for d in widths)
    return ROUTES[0] if tc else ROUTES[1]


def _width_class(d: int) -> int:
    """A width rounded up to the kernels' classes: 64, 128 or 192."""
    return 64 if d <= 64 else 128 if d <= 128 else 192


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


def cost(q, k, v, o, lse, do, pairs: int = None) -> tuple:
    """(FLOPs, bytes) of one call: every product it computes, over ``pairs``
    (query, key) pairs a head (by default every pair, Sq Sk, as for the
    forward's :func:`ops.cost`): the dK/dV pass recomputes S = q k^T (hd)
    and dP = do v^T (hd_v) and takes dK (hd) and dV (hd_v), the dQ pass
    recomputes S and dP again and takes dQ (hd), seven products, 2 B Hq
    pairs (4 hd + 3 hd_v) FLOPs; q, k, v, o, lse, do read once and dq, dk,
    dv written once."""
    B, Hq, Sq, hd = q.shape
    hd_v = v.shape[3]
    pairs = Sq * k.shape[2] if pairs is None else pairs
    ins = (q, k, v, o, lse, do)
    return (2 * B * Hq * pairs * (4 * hd + 3 * hd_v),
            sum(tensor_bytes(t) for t in ins)
            + sum(tensor_bytes(t) for t in (q, k, v)))


def scratch_bytes(q, k, sms: int, *, causal: bool = True, q_offset: int = 0,
                  via: str | None = None, hd_v: int | None = None) -> int:
    """Bytes of split scratch one call allocates on a card of ``sms`` SMs,
    besides its outputs and D: the splits' f32 partial sums, a (64, HD) dK
    and a (64, HDV) dV slot for each split of a dK/dV tile and a (64, HD)
    dQ slot for each split of a dQ tile (HD, HDV: hd and hd_v rounded up to
    64, 128 or 192), none unsplit.  ``hd_v`` defaults to ``hd``.  It
    depends on the SM count, which a dry run cannot read, so :func:`cost`'s
    counter leaves it out of the step's peak."""
    B, Hq, Sq, hd = q.shape
    _, Hkv, Sk, _ = k.shape
    hd_v = hd if hd_v is None else hd_v
    if (via or route(q.dtype, hd, hd_v)) == ROUTES[1]:
        return 0
    n_kv, n_q = splits(B, Hq, Hkv, Sq, Sk, causal, q_offset, sms)
    HD, HDV = _width_class(hd), _width_class(hd_v)
    floats = (B * Hkv * _tiles(Sk) * n_kv * (HD + HDV) if n_kv > 1 else 0) \
        + (B * Hq * _tiles(Sq) * n_q * HD if n_q > 1 else 0)
    return 4 * floats * TILE


def _check(q, k, v, o, lse, do) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 \
            or v.shape[:3] != k.shape[:3] or o.shape[:3] != q.shape[:3] \
            or o.shape != do.shape or o.shape[3] != v.shape[3]:
        raise ValueError("flash_attention_bwd: want q (B, Hq, Sq, hd), k (B, "
                         "Hkv, Sk, hd), v (B, Hkv, Sk, hd_v) and o, do (B, Hq, "
                         "Sq, hd_v); got "
                         f"{[tuple(t.shape) for t in (q, k, v, o, do)]}")
    B, Hq, Sq, hd = q.shape
    _, Hkv, _, hd_k = k.shape
    hd_v = v.shape[3]
    if k.shape[0] != B or hd_k != hd or Hq % Hkv:
        raise ValueError(f"flash_attention_bwd: q {tuple(q.shape)} does not "
                         f"match k {tuple(k.shape)}")
    ref.check_widths("flash_attention_bwd", hd, hd_v)
    if B * Hq > MAX_HEADS:
        raise ValueError(f"flash_attention_bwd: want B * Hq <= {MAX_HEADS}; "
                         f"got {tuple(q.shape)}")
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
    takes any widths; "tensor_cores" raises where the route does not
    apply), which ``chip_smoke.py`` uses to time the two side by side."""
    global launches
    _check(q, k, v, o, lse, do)
    hd, hd_v = q.shape[-1], v.shape[-1]
    via = via or route(q.dtype, hd, hd_v)
    if via not in ROUTES or (via == ROUTES[0]
                             and route(q.dtype, hd, hd_v) != via):
        raise ValueError(f"flash_attention_bwd: no route {via!r} for "
                         f"{q.dtype} head_dim {hd}, hd_v {hd_v}")
    if q.device.type == "cpu":
        return attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                 q_offset=q_offset)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention_bwd: no kernel for {q.device}")
    B, Hq, Sq, _ = q.shape
    _, Hkv, Sk, _ = k.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    note("flash_attention_bwd", cost, q, k, v, o, lse, do)
    if q.device.type == "meta":
        return dq, dk, dv
    fn = _build.function("flash_attention_bwd", _ARGTYPES)
    sms = sm_count(q.device)
    n_kv, n_q = (1, 1) if via == ROUTES[1] else splits(
        B, Hq, Hkv, Sq, Sk, causal, q_offset, sms)
    part = cnt = None
    if n_kv > 1 or n_q > 1:   # each split's partial sums, and the counters
        part = torch.empty(scratch_bytes(q, k, sms, causal=causal,
                                         q_offset=q_offset, via=via,
                                         hd_v=hd_v) // 4,
                           dtype=torch.float32, device=q.device)
        # one per dK/dV tile, then one per dQ tile
        cnt = counters("flash_attention_bwd", q.device,
                       B * Hkv * _tiles(Sk) + B * Hq * _tiles(Sq))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
             dk.data_ptr(), dv.data_ptr(), B, Hq, Hkv, Sq, Sk, hd, hd_v,
             int(causal),
             int(q_offset), _DTYPES[q.dtype], int(via == ROUTES[0]), n_kv, n_q,
             None if part is None else part.data_ptr(),
             None if cnt is None else cnt.data_ptr(), stream)
    _build.check("flash_attention_bwd", err)
    launches += 1
    return dq, dk, dv


__all__ = ["flash_attention_bwd", "route", "splits", "attention_bwd_ref",
           "cost", "scratch_bytes", "ref"]
