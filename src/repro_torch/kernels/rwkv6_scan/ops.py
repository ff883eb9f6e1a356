"""RWKV-6 WKV scan op: the Hopper kernel for CUDA tensors, the plain version
for CPU tensors.

A CUDA tensor launches ``csrc/rwkv6_scan.cu`` or raises; nothing routes it
to the plain version.  The interface is the Pallas kernel's
(``rwkv6_scan(r, k, v, logw, u, state0)``) without its ``chunk``: chunking
is how a kernel computes the recurrence, not part of the function.  The
Hopper kernel, like the TPU kernel's default, takes chunks of ``CHUNK`` = 32
steps.  A call on the card is three launches (each chunk's own state
contribution, the pass over each row's chunks, each chunk's output);
``launches`` counts calls.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._grad import refuse_grad
from repro_torch.kernels.rwkv6_scan import ref
from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_ref

# kernel launches, counted where the kernel is launched and nowhere else
launches = 0

MAX_HEAD_DIM = 128
CHUNK = 32                        # steps a chunk of the kernel
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 10 + [_I, _I, _I, _I, _P]


def num_chunks(S: int) -> int:
    """Chunks of ``CHUNK`` steps that cover S (the last one may be ragged)."""
    return -(-S // CHUNK)


def padded_head_dim(hd: int) -> int:
    """The head dim the kernel is built for: 64 up to 64, else 128."""
    return 64 if hd <= 64 else 128


def scratch_shapes(N: int, S: int, hd: int) -> tuple:
    """Shapes of the kernel's f32 scratch: each chunk's state (its own
    contribution, then the state entering it) and its log2 decay."""
    nc, hdp = num_chunks(S), padded_head_dim(hd)
    return (N, nc, hdp, hdp), (N, nc, hdp)


def _check(r, k, v, logw, u, state0) -> None:
    if r.dim() != 3 or any(t.shape != r.shape for t in (k, v, logw)):
        raise ValueError("rwkv6_scan: want r, k, v, logw of one shape (N, S, "
                         f"hd); got {[tuple(t.shape) for t in (r, k, v, logw)]}")
    N, S, hd = r.shape
    if N < 1 or S < 1 or not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"rwkv6_scan: want N, S >= 1 and 1 <= hd <= "
                         f"{MAX_HEAD_DIM}; got {tuple(r.shape)}")
    if tuple(u.shape) != (N, hd) or tuple(state0.shape) != (N, hd, hd):
        raise ValueError(f"rwkv6_scan: want u ({N}, {hd}) and state0 ({N}, "
                         f"{hd}, {hd}); got {tuple(u.shape)}, "
                         f"{tuple(state0.shape)}")
    if r.dtype not in _DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError("rwkv6_scan: r, k, v must share one dtype of "
                        f"{list(_DTYPES)}; got {r.dtype}, {k.dtype}, {v.dtype}")
    if any(t.dtype != torch.float32 for t in (logw, u, state0)):
        raise TypeError("rwkv6_scan: logw, u and state0 must be float32; got "
                        f"{logw.dtype}, {u.dtype}, {state0.dtype}")
    devices = {t.device for t in (r, k, v, logw, u, state0)}
    if len(devices) != 1:
        raise ValueError(f"rwkv6_scan: tensors on {devices}")
    if not all(t.is_contiguous() for t in (r, k, v, logw, u, state0)):
        raise ValueError("rwkv6_scan: tensors must be contiguous")


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               logw: torch.Tensor, u: torch.Tensor, state0: torch.Tensor):
    """The RWKV-6 WKV recurrence over N = batch * heads rows.

    r, k, v: (N, S, hd), float32 or bfloat16; logw: (N, S, hd) float32
    log-decays (< 0); u: (N, hd) float32 bonus; state0: (N, hd, hd) float32.
    Returns (out (N, S, hd) f32, state (N, hd, hd) f32).
    """
    global launches
    _check(r, k, v, logw, u, state0)
    if r.device.type == "cpu":
        return rwkv6_scan_ref(r, k, v, logw, u, state0)
    if r.device.type != "cuda":
        raise ValueError(f"rwkv6_scan: no kernel for {r.device}")
    refuse_grad("rwkv6_scan", r, k, v, logw, u, state0)
    N, S, hd = r.shape
    fn = _build.function("rwkv6_scan", _ARGTYPES)
    out = torch.empty((N, S, hd), dtype=torch.float32, device=r.device)
    state = torch.empty_like(state0)
    states_shape, wlast_shape = scratch_shapes(N, S, hd)
    states = torch.empty(states_shape, dtype=torch.float32, device=r.device)
    wlast = torch.empty(wlast_shape, dtype=torch.float32, device=r.device)
    stream = torch.cuda.current_stream(r.device).cuda_stream
    err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
             u.data_ptr(), state0.data_ptr(), out.data_ptr(), state.data_ptr(),
             states.data_ptr(), wlast.data_ptr(),
             N, S, hd, _DTYPES[r.dtype], stream)
    _build.check("rwkv6_scan", err)
    launches += 1
    return out, state


__all__ = ["rwkv6_scan", "rwkv6_scan_ref", "ref"]
