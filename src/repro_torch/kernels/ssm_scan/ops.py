"""Mamba selective-scan op: the Hopper kernel for CUDA tensors, the plain
version for CPU tensors.

A CUDA tensor launches ``csrc/ssm_scan.cu`` or raises; nothing routes it to
the plain version.  The interface is the Pallas kernel's
(``ssm_scan(u, dt, A, B, C, D, h0)``, applying ``-exp(A)`` itself) without
its ``chunk`` and ``block_di``: chunking is how the TPU kernel computes the
recurrence, not part of the function.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssm_scan import ref
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref

# kernel launches, counted where the kernel is launched and nowhere else
launches = 0

D_STATES = (8, 16)               # the d_state values the kernel is built for
MAX_ROWS = 65535                 # Bz is the grid's y extent
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 9 + [_I, _I, _I, _I, _I, _P]


def _check(u, dt, A_log, B, C, D, h0) -> None:
    if u.dim() != 3 or tuple(dt.shape) != tuple(u.shape):
        raise ValueError("ssm_scan: want u and dt of one shape (Bz, S, di); "
                         f"got {tuple(u.shape)}, {tuple(dt.shape)}")
    Bz, S, di = u.shape
    if not (1 <= Bz <= MAX_ROWS and S >= 1 and di >= 1):
        raise ValueError(f"ssm_scan: want 1 <= Bz <= {MAX_ROWS} and S, di >= "
                         f"1; got {tuple(u.shape)}")
    if A_log.dim() != 2 or A_log.shape[0] != di:
        raise ValueError(f"ssm_scan: want A_log ({di}, ds); got "
                         f"{tuple(A_log.shape)}")
    ds = A_log.shape[1]
    if ds not in D_STATES:
        raise ValueError(f"ssm_scan: d_state {ds} is not built; the kernel "
                         f"takes d_state in {D_STATES}")
    if tuple(B.shape) != (Bz, S, ds) or tuple(C.shape) != (Bz, S, ds) \
            or tuple(D.shape) != (di,) or tuple(h0.shape) != (Bz, di, ds):
        raise ValueError(f"ssm_scan: want B, C ({Bz}, {S}, {ds}), D ({di},) "
                         f"and h0 ({Bz}, {di}, {ds}); got {tuple(B.shape)}, "
                         f"{tuple(C.shape)}, {tuple(D.shape)}, "
                         f"{tuple(h0.shape)}")
    if u.dtype not in _DTYPES or B.dtype != u.dtype or C.dtype != u.dtype:
        raise TypeError("ssm_scan: u, B, C must share one dtype of "
                        f"{list(_DTYPES)}; got {u.dtype}, {B.dtype}, {C.dtype}")
    if any(t.dtype != torch.float32 for t in (dt, A_log, D, h0)):
        raise TypeError("ssm_scan: dt, A_log, D and h0 must be float32; got "
                        f"{dt.dtype}, {A_log.dtype}, {D.dtype}, {h0.dtype}")
    devices = {t.device for t in (u, dt, A_log, B, C, D, h0)}
    if len(devices) != 1:
        raise ValueError(f"ssm_scan: tensors on {devices}")
    if not all(t.is_contiguous() for t in (u, dt, A_log, B, C, D, h0)):
        raise ValueError("ssm_scan: tensors must be contiguous")


def ssm_scan(u: torch.Tensor, dt: torch.Tensor, A_log: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
             h0: torch.Tensor):
    """The Mamba selective scan over Bz rows of di channels.

    u: (Bz, S, di) and B, C: (Bz, S, ds), float32 or bfloat16 (one dtype);
    dt: (Bz, S, di) float32 step sizes; A_log: (di, ds) float32 (the op
    applies ``-exp``); D: (di,) float32; h0: (Bz, di, ds) float32.
    Returns (y (Bz, S, di) f32, h (Bz, di, ds) f32).
    """
    global launches
    _check(u, dt, A_log, B, C, D, h0)
    if u.device.type == "cpu":
        return ssm_scan_ref(u, dt, A_log, B, C, D, h0)
    if u.device.type != "cuda":
        raise ValueError(f"ssm_scan: no kernel for {u.device}")
    Bz, S, di = u.shape
    ds = A_log.shape[1]
    fn = _build.function("ssm_scan", _ARGTYPES)
    y = torch.empty((Bz, S, di), dtype=torch.float32, device=u.device)
    h = torch.empty_like(h0)
    stream = torch.cuda.current_stream(u.device).cuda_stream
    err = fn(u.data_ptr(), dt.data_ptr(), A_log.data_ptr(), B.data_ptr(),
             C.data_ptr(), D.data_ptr(), h0.data_ptr(), y.data_ptr(),
             h.data_ptr(), Bz, S, di, ds, _DTYPES[u.dtype], stream)
    _build.check("ssm_scan", err)
    launches += 1
    return y, h


__all__ = ["ssm_scan", "ssm_scan_ref", "ref"]
