"""Mamba selective-scan op: the Hopper kernel for CUDA tensors, the plain
version for CPU tensors.

A CUDA tensor launches ``csrc/ssm_scan.cu`` or raises; nothing routes it to
the plain version.  The interface is the Pallas kernel's
(``ssm_scan(u, dt, A, B, C, D, h0)``, applying ``-exp(A)`` itself) without
its ``chunk`` and ``block_di``: chunking is how the TPU kernel computes the
recurrence, not part of the function.  One keyword is added: ``h_out``, a
tensor to write the final state into, which may be ``h0`` itself (the
Mamba decode step updates its cached state in place).  A call is one
launch: ``ssm_step_kernel`` for one step (S = 1), ``ssm_kernel`` otherwise.

Under grad mode, with an input that requires grad, a CUDA call is a
``torch.autograd.Function`` (:class:`SSMScan`): its forward also writes the
state entering every ``bwd.CHECKPOINT`` steps, and its backward launches
``csrc/ssm_scan_bwd.cu`` (:mod:`.bwd`) from them.  Such a call takes no
``h_out`` (it would write in place into a tensor the backward keeps).
Outside grad mode nothing more is written, so serving runs the kernel
exactly as before.  CPU tensors get :func:`ssm_scan_ref`, which autograd
differentiates.  A ``meta`` tensor takes the CUDA route up to the launch and
reports the kernel's :func:`cost` to ``core.cost.analysis`` instead (a dry
run); a CUDA call reports it too.

Under a mesh, :func:`ssm_scan_by_channels` runs the op (forward and, under
grad, :class:`SSMScan`'s backward) on each rank's batch rows and d_inner
channels under ``local_map``, and names where each input's gradient is
left: the rank's dB and dC are its channels' share, summed over "model".
"""
from __future__ import annotations

import ctypes

import torch
from torch.distributed.tensor import DTensor, Partial, Shard

from repro_torch import sharding as sh
from repro_torch.core.cost.analysis import note, tensor_bytes
from repro_torch.kernels import _build
from repro_torch.kernels.ssm_scan import bwd, ref
from repro_torch.kernels.ssm_scan.bwd import checkpoint_shape
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref

# kernel launches, counted where the kernel is launched and nowhere else
launches = 0

D_STATES = (8, 16)               # the d_state values the kernel is built for
MAX_ROWS = 65535                 # Bz is the grid's y extent
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 10 + [_I] * 6 + [_P]


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


def _check_h_out(h_out, h0) -> None:
    if h_out.shape != h0.shape or h_out.dtype != torch.float32 \
            or h_out.device != h0.device or not h_out.is_contiguous():
        raise ValueError("ssm_scan: h_out must be a contiguous float32 tensor "
                         f"of h0's shape {tuple(h0.shape)} on {h0.device}; got "
                         f"{h_out.dtype} {tuple(h_out.shape)} on {h_out.device}")
    if h_out.data_ptr() != h0.data_ptr() and _overlap(h_out, h0):
        raise ValueError("ssm_scan: h_out overlaps h0 without being h0")


def _overlap(a: torch.Tensor, b: torch.Tensor) -> bool:
    a0, b0 = a.data_ptr(), b.data_ptr()
    return a0 < b0 + b.numel() * b.element_size() and \
        b0 < a0 + a.numel() * a.element_size()


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def cost(u, dt, A_log, B, C, D, h0, y, h, ckpt=None) -> tuple:
    """(FLOPs, bytes) of one call.  The kernel walks the steps one by one;
    its products are, per (row, step, channel, state), the input's outer
    product (dt u) B into the state and the state's contraction with C, 4
    Bz S di ds in all.  Inputs read once, y, h (and the checkpoints) written
    once."""
    Bz, S, di = u.shape
    ins = (u, dt, A_log, B, C, D, h0)
    outs = (y, h) + (() if ckpt is None else (ckpt,))
    return (4 * Bz * S * di * A_log.shape[1],
            sum(tensor_bytes(t) for t in ins + outs))


def _launch(u, dt, A_log, B, C, D, h0, h, ckpt=None) -> torch.Tensor:
    """One launch of the forward kernel on CUDA tensors, the final state into
    h and, if ckpt is given, the checkpoints into it; returns y.  On meta
    tensors: y, and the cost noted."""
    global launches
    Bz, S, di = u.shape
    ds = A_log.shape[1]
    y = torch.empty((Bz, S, di), dtype=torch.float32, device=u.device)
    if any(t.data_ptr() % 16 for t in (A_log, h0, h)):
        raise ValueError("ssm_scan: the kernel reads A_log and h0 and writes "
                         "h_out 16 bytes at a time; they must be 16-byte "
                         "aligned")
    note("ssm_scan", cost, u, dt, A_log, B, C, D, h0, y, h, ckpt)
    if u.device.type == "meta":
        return y
    fn = _build.function("ssm_scan", _ARGTYPES)
    stream = torch.cuda.current_stream(u.device).cuda_stream
    err = fn(u.data_ptr(), dt.data_ptr(), A_log.data_ptr(), B.data_ptr(),
             C.data_ptr(), D.data_ptr(), h0.data_ptr(), y.data_ptr(),
             h.data_ptr(), None if ckpt is None else ckpt.data_ptr(), Bz, S,
             di, ds, _DTYPES[u.dtype], bwd.CHECKPOINT, stream)
    _build.check("ssm_scan", err)
    launches += 1
    return y


def ssm_scan_fwd(u: torch.Tensor, dt: torch.Tensor, A_log: torch.Tensor,
                 B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                 h0: torch.Tensor):
    """(y, h, ckpt): the forward and the checkpoints (``checkpoint_shape``)
    as :class:`SSMScan` keeps them for :func:`bwd.ssm_scan_bwd`; one launch
    of the kernel on CUDA tensors.  No autograd; CUDA only."""
    _check(u, dt, A_log, B, C, D, h0)
    if u.device.type not in ("cuda", "meta"):
        raise ValueError(f"ssm_scan_fwd: no kernel for {u.device}")
    ckpt = torch.empty(checkpoint_shape(*u.shape, A_log.shape[1]),
                       dtype=torch.float32, device=u.device)
    h = torch.empty_like(h0)
    return _launch(u, dt, A_log, B, C, D, h0, h, ckpt), h, ckpt


class SSMScan(torch.autograd.Function):
    """The forward kernel, keeping its checkpoints, and the backward kernel
    for its gradient."""

    @staticmethod
    def forward(ctx, u, dt, A_log, B, C, D, h0):
        y, h, ckpt = ssm_scan_fwd(u, dt, A_log, B, C, D, h0)
        ctx.save_for_backward(u, dt, A_log, B, C, D, h0, ckpt)
        ctx.set_materialize_grads(False)
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        u, dt, A_log, B, C, D, h0, ckpt = ctx.saved_tensors
        dy = torch.zeros_like(dt) if dy is None else dy.float().contiguous()
        dh = None if dh is None else dh.float().contiguous()
        return bwd.ssm_scan_bwd(u, dt, A_log, B, C, D, h0, dy, dh, ckpt=ckpt)


def ssm_scan(u: torch.Tensor, dt: torch.Tensor, A_log: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
             h0: torch.Tensor, *, h_out: torch.Tensor = None):
    """The Mamba selective scan over Bz rows of di channels.

    u: (Bz, S, di) and B, C: (Bz, S, ds), float32 or bfloat16 (one dtype);
    dt: (Bz, S, di) float32 step sizes; A_log: (di, ds) float32 (the op
    applies ``-exp``); D: (di,) float32; h0: (Bz, di, ds) float32.
    h_out: where the final state goes (h0's shape, float32, contiguous; it
    may be h0 itself); a new tensor when None.  Not taken by a CUDA call
    under grad mode with an input that requires grad (ValueError).
    Returns (y (Bz, S, di) f32, h (Bz, di, ds) f32), h being h_out if given,
    with a ``grad_fn`` when grad mode is on and an input requires grad.
    """
    _check(u, dt, A_log, B, C, D, h0)
    if h_out is not None:
        _check_h_out(h_out, h0)
    grad = _wants_grad(u, dt, A_log, B, C, D, h0)
    if u.device.type == "cpu":
        y, h = ssm_scan_ref(u, dt, A_log, B, C, D, h0)
        return y, h if h_out is None else h_out.copy_(h)
    if grad and h_out is not None:
        raise ValueError("ssm_scan: h_out is not taken under grad mode: the "
                         "backward keeps the inputs, and h_out may be one of "
                         "them (h0); leave it None")
    if u.device.type not in ("cuda", "meta"):
        raise ValueError(f"ssm_scan: no kernel for {u.device}")
    if grad:
        return SSMScan.apply(u, dt, A_log, B, C, D, h0)
    h = torch.empty_like(h0) if h_out is None else h_out
    return _launch(u, dt, A_log, B, C, D, h0, h), h


def ssm_scan_by_channels(u: torch.Tensor, dt: torch.Tensor,
                         A_log: torch.Tensor, B: torch.Tensor,
                         C: torch.Tensor, D: torch.Tensor,
                         h0: torch.Tensor = None, *, in_place: bool = False,
                         scan=None):
    """``scan`` (:func:`ssm_scan` by default) from ``h0`` (zeros when None),
    under a mesh on each rank's batch rows and channels (``local_map``).

    u, dt (Bz, S, di) are laid out alike, their channels on "model" or
    replicated; h0 (Bz, di, ds) as they are (the decode cache's spec,
    ("batch", "mlp", None)); B, C (Bz, S, ds) share their batch layout and
    are replicated over "model"; A_log (di, ds) and D (di,) are replicated
    params, of which each rank reads the rows of its channels.  So each
    rank's dB and dC are partial sums over "model" (its channels' share),
    reduced where they enter B and C, and its dA_log and dD are partial
    over "model" and over the axes that shard the batch (its rows' share).
    With ``in_place`` the final state is written into h0's own local shard
    (the decode step's cache) and h0 returned.  Returns (y, h) laid out as
    u and h0.  Plain tensors: the op itself."""
    scan = scan or ssm_scan
    mesh = u.device_mesh if isinstance(u, DTensor) else None
    split = mesh is not None and isinstance(sh.on_model(u), Shard)
    ds = A_log.shape[-1]

    def local(ul, dtl, al, bl, cl, dl, hl=None):
        n = ul.shape[-1]
        first = sh.model_rank(mesh) * n if split else 0
        if hl is None:
            hl = torch.zeros((ul.shape[0], n, ds), dtype=torch.float32,
                             device=ul.device)
        return scan(ul.contiguous(), dtl.contiguous(),
                    al[first:first + n].contiguous(), bl.contiguous(),
                    cl.contiguous(), dl[first:first + n].contiguous(), hl,
                    h_out=hl if in_place else None)

    hs = () if h0 is None else (h0,)
    if mesh is None:
        return local(u, dt, A_log, B, C, D, *hs)
    bc = B.placements
    if split:   # left pending, a gradient sum meets x_proj's backward
        B, C = sh.grad_as(B, B.placements), sh.grad_as(C, C.placements)
        bc = sh.on_model_as(B, Partial())
    h_place = tuple(Shard(1) if p == Shard(2) else p for p in u.placements)
    grads = (u.placements, dt.placements, sh.batch_grad(u, A_log, split),
             bc, bc, sh.batch_grad(u, D, split)) + \
        tuple(h.placements for h in hs)
    return sh.run_local(local, [u.placements, h_place], u, dt, A_log, B, C,
                        D, *hs, in_grad_placements=grads)


__all__ = ["ssm_scan", "ssm_scan_fwd", "ssm_scan_by_channels", "SSMScan",
           "ssm_scan_ref", "bwd", "cost", "ref"]
