"""RWKV-6 WKV scan backward op: the Hopper kernel for CUDA tensors, the plain
version for CPU tensors.

A CUDA tensor launches ``csrc/rwkv6_scan_bwd.cu`` or raises; nothing routes
it to the plain version.  The TPU package has no backward kernel to carry
over (the Pallas kernel is forward-only; the JAX model differentiates its
XLA scan), so this is a new kernel, held against
:func:`ref.rwkv6_scan_bwd_ref` and autograd over :func:`ref.rwkv6_scan_ref`.
It starts from the state entering each chunk, which the forward kernel
leaves in its scratch (:func:`ops.rwkv6_scan_fwd`).  A call is three
launches on one stream, the forward's in reverse: each chunk's own
contribution to the state's gradient, the reverse pass over each row's
chunks, each chunk's dr, dk, dv and dlogw (no atomics: the result is the
same bits from call to call); ``launches`` counts calls.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rwkv6_scan import ops, ref
from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_bwd_ref

# kernel launches (one per call), counted where the kernel is launched and
# nowhere else
launches = 0

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 18 + [_I] * 4 + [_P]


def rwkv6_scan_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   logw: torch.Tensor, u: torch.Tensor, state0: torch.Tensor,
                   dout: torch.Tensor, dstate: torch.Tensor = None, *,
                   states: torch.Tensor = None):
    """The gradient of ``rwkv6_scan(r, k, v, logw, u, state0)`` for dout (N,
    S, hd) f32, the gradient of out, and dstate (N, hd, hd) f32, that of the
    final state (None: zero).  states: on the card, the state entering each
    chunk as the forward kernel left it (``ops.rwkv6_scan_fwd``), required
    (state0 is then not read); on the CPU it is not read.

    Returns (dr, dk, dv, dlogw, du, dstate0) in the dtypes of the inputs
    (dr, dk, dv in r's; the rest f32), all arithmetic in f32.
    """
    global launches
    N, S, hd = r.shape
    if tuple(dout.shape) != (N, S, hd) or dout.dtype != torch.float32 \
            or (dstate is not None and (tuple(dstate.shape) != (N, hd, hd)
                                        or dstate.dtype != torch.float32)):
        raise ValueError(f"rwkv6_scan_bwd: want dout ({N}, {S}, {hd}) and "
                         f"dstate ({N}, {hd}, {hd}) or None, float32")
    if r.device.type == "cpu":
        dr, dk, dv, dlogw, du, ds0 = rwkv6_scan_bwd_ref(
            r, k, v, logw, u, state0, dout, dstate)
        return dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dlogw, du, ds0
    if r.device.type != "cuda":
        raise ValueError(f"rwkv6_scan_bwd: no kernel for {r.device}")
    states_shape, wl_shape = ops.scratch_shapes(N, S, hd)
    if states is None or tuple(states.shape) != states_shape \
            or states.dtype != torch.float32:
        raise ValueError("rwkv6_scan_bwd: on the card it starts from the "
                         f"forward kernel's states {states_shape} float32 "
                         "(ops.rwkv6_scan_fwd)")
    ins = (r, k, v, logw, u, dout, states) + (() if dstate is None
                                              else (dstate,))
    if not all(t.is_contiguous() and t.device == r.device for t in ins):
        raise ValueError("rwkv6_scan_bwd: tensors must be contiguous, on one "
                         "device")
    dev = r.device
    dr, dk, dv = (torch.empty_like(t) for t in (r, k, v))
    dlogw = torch.empty_like(logw)
    du = torch.empty_like(u)
    ds0 = torch.empty((N, hd, hd), dtype=torch.float32, device=dev)
    gst = torch.empty(states_shape, dtype=torch.float32, device=dev)
    wl, dup, q = (torch.empty(wl_shape, dtype=torch.float32, device=dev)
                  for _ in range(3))
    fn = _build.function("rwkv6_scan_bwd", _ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
             u.data_ptr(), dout.data_ptr(),
             None if dstate is None else dstate.data_ptr(), states.data_ptr(),
             dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dlogw.data_ptr(),
             du.data_ptr(), ds0.data_ptr(), gst.data_ptr(), wl.data_ptr(),
             dup.data_ptr(), q.data_ptr(), N, S, hd, ops._DTYPES[r.dtype],
             stream)
    _build.check("rwkv6_scan_bwd", err)
    launches += 1
    return dr, dk, dv, dlogw, du, ds0


__all__ = ["rwkv6_scan_bwd", "rwkv6_scan_bwd_ref", "ref"]
