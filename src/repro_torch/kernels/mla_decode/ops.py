"""Absorbed MLA decode op: the Hopper kernel for CUDA tensors, the plain
version for CPU tensors.

A CUDA tensor launches ``csrc/mla_decode.cu`` or raises; nothing routes it
to the plain version.  ``route`` picks the kernel by dtype and width (bf16
at L 512, R 64 on the tensor cores, 64 heads a block; the rest on the CUDA
cores, 16 heads a block).  Both split the batch's valid key tiles evenly
over ``grid_blocks`` blocks per head chunk, on the device
(``split_schedule`` is that arithmetic in Python), and a second launch
merges the partial states of every row that more than one block touched,
in block order.  It has no TPU counterpart: the reference computes this
function in XLA einsums.  A ``meta`` tensor takes the CUDA route up to the
launch and reports the kernel's :func:`cost` to ``core.cost.analysis``
instead (a dry run); a CUDA call reports it too.
"""
from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from repro_torch.core.cost.analysis import note, tensor_bytes
from repro_torch.kernels import _build, sm_count
from repro_torch.kernels._grad import refuse_grad
from repro_torch.kernels.mla_decode import ref
from repro_torch.kernels.mla_decode.ref import mla_decode_ref

# calls that launched the kernels (one per call: the split kernel and the
# merge), counted where they are launched and nowhere else
launches = 0

MAX_LATENT = 512        # L at most: two output columns a thread of 256
# route -> (query heads a block, keys a tile) (csrc/mla_decode.cu)
ROUTES = {"wgmma": (64, 64), "cuda_cores": (16, 32)}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 7 + [_I] * 6 + [ctypes.c_float, _I, _P]


def route(dtype: torch.dtype, L: int, R: int) -> str:
    """The kernel a CUDA call runs: ``"wgmma"`` (tensor cores) for bf16 at
    DeepSeek's latent widths (L 512, R 64), else ``"cuda_cores"`` (f32
    products, any L <= 512 and R that ``_check`` admits)."""
    return ("wgmma" if dtype == torch.bfloat16 and (L, R) == (512, 64)
            else "cuda_cores")


def grid_blocks(B: int, H: int, T: int, sm_count: int, heads: int,
                keys: int) -> int:
    """Blocks per head chunk: one wave over the SMs (a block fills an SM's
    shared memory), at most one per tile the cache can hold.  Read from the
    shapes alone, so that the wrapper never waits for ``kv_len``."""
    chunks = -(-H // heads)
    return max(1, min(-(-sm_count // chunks), B * -(-T // keys)))


def row_tiles(kv_len: Sequence[int], T: int, keys: int) -> List[int]:
    """Key tiles of each row: its valid keys (``kv_len`` clamped to [0, T])
    in tiles of ``keys``."""
    return [-(-min(max(int(n), 0), T) // keys) for n in kv_len]


def split_schedule(kv_len: Sequence[int], T: int, keys: int,
                   nblocks: int) -> List[List[Tuple[int, int, int]]]:
    """What each block of a head chunk works on, as the kernels compute it.

    The rows' tiles are laid end to end (row 0's first); block ``s`` takes
    the ``per = ceil(total / nblocks)`` tiles from ``s * per`` on, so no
    block has more than ``per``.  Returns, per block, its segments ``(row,
    first tile, end tile)`` in row order.  A segment that is its row's
    every tile writes the output itself; otherwise it writes a partial
    (m, l, acc) to slot ``block + row`` (distinct for every (block, row)
    pair) and the merge adds a row's partials in block order.
    """
    tiles = row_tiles(kv_len, T, keys)
    total = sum(tiles)
    per = -(-total // nblocks)
    out: List[List[Tuple[int, int, int]]] = [[] for _ in range(nblocks)]
    off = 0
    for b, n in enumerate(tiles):
        if n:
            for s in range(off // per, (off + n - 1) // per + 1):
                lo, hi = max(off, s * per), min(off + n, (s + 1) * per)
                out[s].append((b, lo - off, hi - off))
        off += n
    return out


def cost(q_abs, q_rope, ckv, krope, kv_len, keys: int = None) -> tuple:
    """(FLOPs, bytes) of one call: the products q_abs ckv^T, q_rope krope^T
    and p ckv over ``keys`` cache positions summed over the rows, 2 H keys
    (2 L + R); the queries, kv_len and those positions of ckv and krope
    read once, the context written once.  ``keys`` defaults to the whole
    cache, B T, as the reference's einsums count it (a dry run cannot read
    ``kv_len``)."""
    B, H, L = q_abs.shape
    T, R = krope.shape[1:]
    keys = B * T if keys is None else keys
    return (2 * H * keys * (2 * L + R),
            2 * tensor_bytes(q_abs) + tensor_bytes(q_rope)
            + tensor_bytes(kv_len) + keys * (L + R) * ckv.element_size())


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


def scratch_bytes(q_abs, krope, sms: int) -> int:
    """Bytes of split scratch one call allocates on a card of ``sms`` SMs,
    besides its output: each (head chunk, slot)'s (m, l) and f32 acc for
    the chunk's heads, a slot per block and per row.  It depends on the SM
    count, which a dry run cannot read, so :func:`cost`'s counter leaves it
    out of the step's peak."""
    B, H, L = q_abs.shape
    T, R = krope.shape[1:]
    heads, keys = ROUTES[route(q_abs.dtype, L, R)]
    nblocks = grid_blocks(B, H, T, sms, heads, keys)
    return 4 * -(-H // heads) * (nblocks + B) * heads * (L + 2)


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
    if q_abs.device.type not in ("cuda", "meta"):
        raise ValueError(f"mla_decode: no kernel for {q_abs.device}")
    refuse_grad("mla_decode", q_abs, q_rope, ckv, krope)
    out = torch.empty_like(q_abs)
    note("mla_decode", cost, q_abs, q_rope, ckv, krope, kv_len)
    if q_abs.device.type == "meta":
        return out
    B, H, L = q_abs.shape
    T, R = krope.shape[1:]
    heads, keys = ROUTES[route(q_abs.dtype, L, R)]
    sms = sm_count(q_abs.device)
    nblocks = grid_blocks(B, H, T, sms, heads, keys)
    fn = _build.function("mla_decode", _ARGTYPES)
    ws = torch.empty(scratch_bytes(q_abs, krope, sms) // 4,
                     dtype=torch.float32, device=q_abs.device)
    stream = torch.cuda.current_stream(q_abs.device).cuda_stream
    err = fn(q_abs.data_ptr(), q_rope.data_ptr(), ckv.data_ptr(),
             krope.data_ptr(), kv_len.data_ptr(), out.data_ptr(),
             ws.data_ptr(), B, H, T, L, R, nblocks, float(scale),
             _DTYPES[q_abs.dtype], stream)
    _build.check("mla_decode", err)
    launches += 1
    return out


__all__ = ["mla_decode", "mla_decode_ref", "ref", "route", "grid_blocks",
           "split_schedule", "cost", "scratch_bytes"]
