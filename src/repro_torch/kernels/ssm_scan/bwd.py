"""Mamba selective-scan backward op: the Hopper kernel for CUDA tensors, the
plain version for CPU tensors.

A CUDA tensor launches ``csrc/ssm_scan_bwd.cu`` or raises; nothing routes it
to the plain version.  The TPU package has no backward kernel to carry over
(the Pallas kernel is forward-only; the JAX model differentiates its XLA
scan), so this is a new kernel, held against :func:`ref.ssm_scan_bwd_ref`
and autograd over :func:`ref.ssm_scan_ref`.  It starts from the states that
the forward kernel kept every ``CHECKPOINT`` steps
(:func:`ops.ssm_scan_fwd`) and recomputes the rest.  A call is two launches
on one stream: the reverse walk, which writes the per-channel gradients and
one partial sum of dB and dC a block of channels, then the sums of the
partials in a fixed order (no atomics: the result is the same bits from
call to call); ``launches`` counts calls.  A ``meta`` tensor takes the
CUDA route up to the launch and reports the kernel's :func:`cost` to
``core.cost.analysis`` instead (a dry run); a CUDA call reports it too.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.cost.analysis import note, tensor_bytes
from repro_torch.kernels import _build
from repro_torch.kernels.ssm_scan import ref
from repro_torch.kernels.ssm_scan.ref import ssm_scan_bwd_ref

# kernel launches (one per call), counted where the kernel is launched and
# nowhere else
launches = 0

THREADS = 256                     # threads a block of the walk
# steps between the states the forward keeps; the kernels are built for this
# one (csrc/ssm_checkpoint.cuh) and refuse another
CHECKPOINT = 8
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 19 + [_I] * 6 + [_P]


def checkpoint_shape(Bz: int, S: int, di: int, ds: int) -> tuple:
    """Shape of the f32 states a grad-mode forward keeps for the backward:
    the state entering every ``CHECKPOINT`` steps (the first is h0)."""
    return (Bz, -(-S // CHECKPOINT), di, ds)


def blocks_per_row(di: int, ds: int) -> int:
    """Blocks of channels the walk splits a row into (each writes a partial
    sum of dB and dC): ``THREADS / (ds / 4)`` channels a block."""
    per = THREADS // (ds // 4)
    return -(-di // per)


def cost(ins, outs, ds: int) -> tuple:
    """(FLOPs, bytes) of one call on inputs ``ins`` (u, dt, A_log, B, C, D,
    ckpt, dy and dh if given) and outputs ``outs``.  Its products, per
    (row, step, channel, state): the forward's outer product (dt u) B again
    (each state recomputed from its checkpoint), g's outer product dy C, and
    the contractions for dC, dB, du and ddt, 12 Bz S di ds in all.  Inputs
    read once, outputs written once."""
    Bz, S, di = ins[0].shape
    return (12 * Bz * S * di * ds,
            sum(tensor_bytes(t) for t in tuple(ins) + tuple(outs)))


def ssm_scan_bwd(u: torch.Tensor, dt: torch.Tensor, A_log: torch.Tensor,
                 B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                 h0: torch.Tensor, dy: torch.Tensor, dh: torch.Tensor = None,
                 *, ckpt: torch.Tensor = None):
    """The gradient of ``ssm_scan(u, dt, A_log, B, C, D, h0)`` for dy (Bz, S,
    di) f32, the gradient of y, and dh (Bz, di, ds) f32, that of the final
    state (None: zero).  ckpt: on the card, the forward kernel's checkpoints
    (``ops.ssm_scan_fwd``), required; on the CPU it is not read.

    Returns (du, ddt, dA_log, dB, dC, dD, dh0) in the dtypes of the inputs
    (du, dB, dC in u's; the rest f32), all arithmetic in f32.
    """
    global launches
    Bz, S, di = u.shape
    ds = A_log.shape[1]
    if tuple(dy.shape) != (Bz, S, di) or dy.dtype != torch.float32 \
            or (dh is not None and (tuple(dh.shape) != (Bz, di, ds)
                                    or dh.dtype != torch.float32)):
        raise ValueError(f"ssm_scan_bwd: want dy ({Bz}, {S}, {di}) and dh "
                         f"({Bz}, {di}, {ds}) or None, float32")
    if u.device.type == "cpu":
        du, ddt, dA, dB, dC, dD, dh0 = ssm_scan_bwd_ref(
            u, dt, A_log, B, C, D, h0, dy, dh)
        return du.to(u.dtype), ddt, dA, dB.to(B.dtype), dC.to(C.dtype), dD, dh0
    if u.device.type not in ("cuda", "meta"):
        raise ValueError(f"ssm_scan_bwd: no kernel for {u.device}")
    if ckpt is None or tuple(ckpt.shape) != checkpoint_shape(Bz, S, di, ds) \
            or ckpt.dtype != torch.float32:
        raise ValueError("ssm_scan_bwd: on the card it starts from the forward "
                         f"kernel's checkpoints, {checkpoint_shape(Bz, S, di, ds)}"
                         " float32 (ops.ssm_scan_fwd)")
    ins = (u, dt, A_log, B, C, D, ckpt, dy) + (() if dh is None else (dh,))
    if not all(t.is_contiguous() and t.device == u.device for t in ins):
        raise ValueError("ssm_scan_bwd: tensors must be contiguous, on one "
                         "device")
    if any(t.data_ptr() % 16 for t in (A_log, ckpt) + ins[8:]):
        raise ValueError("ssm_scan_bwd: the kernel reads A_log and the states "
                         "16 bytes at a time; they must be 16-byte aligned")
    dev = u.device
    du, dB, dC = (torch.empty_like(t) for t in (u, B, C))
    ddt = torch.empty_like(dt)
    dA = torch.empty_like(A_log)
    dD = torch.empty_like(D)
    dh0 = torch.empty((Bz, di, ds), dtype=torch.float32, device=dev)
    part_bc = torch.empty((blocks_per_row(di, ds), Bz, S, 2 * ds),
                          dtype=torch.float32, device=dev)
    part_a = torch.empty((Bz, di, ds), dtype=torch.float32, device=dev)
    part_d = torch.empty((Bz, di), dtype=torch.float32, device=dev)
    note("ssm_scan_bwd", cost, ins, (du, ddt, dA, dB, dC, dD, dh0), ds)
    if dev.type == "meta":
        return du, ddt, dA, dB, dC, dD, dh0
    fn = _build.function("ssm_scan_bwd", _ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(u.data_ptr(), dt.data_ptr(), A_log.data_ptr(), B.data_ptr(),
             C.data_ptr(), D.data_ptr(), ckpt.data_ptr(), dy.data_ptr(),
             None if dh is None else dh.data_ptr(), du.data_ptr(),
             ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(), dC.data_ptr(),
             dD.data_ptr(), dh0.data_ptr(), part_bc.data_ptr(),
             part_a.data_ptr(), part_d.data_ptr(), Bz, S, di, ds,
             _DTYPES[u.dtype], CHECKPOINT, stream)
    _build.check("ssm_scan_bwd", err)
    launches += 1
    return du, ddt, dA, dB, dC, dD, dh0


__all__ = ["ssm_scan_bwd", "ssm_scan_bwd_ref", "cost", "ref"]
