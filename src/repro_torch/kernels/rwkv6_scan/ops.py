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

Under grad mode, with an input that requires grad, a CUDA call is a
``torch.autograd.Function`` (:class:`RWKV6Scan`): its forward keeps the
kernel's scratch of states (the state entering each chunk) instead of
freeing it, and its backward launches ``csrc/rwkv6_scan_bwd.cu``
(:mod:`.bwd`) from them.  Outside grad mode the scratch is freed as before.
CPU tensors get :func:`rwkv6_scan_ref`, which autograd differentiates.  A
``meta`` tensor takes the CUDA route up to the launch and reports the
kernel's :func:`cost` to ``core.cost.analysis`` instead (a dry run); a CUDA
call reports it too.

Under a mesh, :func:`rwkv6_scan_by_heads` runs the op (forward and, under
grad, :class:`RWKV6Scan`'s backward) on each rank's batch rows and heads
under ``local_map``, and names where each input's gradient is left: the
rank's du is its heads' and its rows' share, summed over "model" and the
batch's axes.
"""
from __future__ import annotations

import ctypes

import torch
from torch.distributed.tensor import DTensor, Shard

from repro_torch import sharding as sh
from repro_torch.core.cost.analysis import note, tensor_bytes
from repro_torch.kernels import _build
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


def chunk_products(S: int, hd: int) -> tuple:
    """(sum over a row's chunks of c hd^2, of c^2 hd), c each chunk's steps:
    the sizes of the (c x hd)(hd x hd) and (c x c)(c x hd) products of the
    chunked form."""
    full, last = divmod(S, CHUNK)
    return S * hd * hd, (full * CHUNK * CHUNK + last * last) * hd


def cost(r, k, v, logw, u, state0, outs) -> tuple:
    """(FLOPs, bytes) of one forward call, outputs ``outs``.  Its products,
    chunk by chunk: the chunk's own state k^T v, the in-chunk scores r k^T
    and their product with v, and r times the entering state, 4 N (sum c
    hd^2 + sum c^2 hd) over the chunks' sizes c.  Inputs read once, outputs
    written once."""
    a, b = chunk_products(r.shape[1], r.shape[2])
    return (4 * r.shape[0] * (a + b),
            sum(tensor_bytes(t) for t in (r, k, v, logw, u, state0) + outs))


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


def _launch(r, k, v, logw, u, state0):
    """One call of the forward kernel on CUDA tensors: (out, state, states),
    states being the scratch that ends holding the state entering each
    chunk."""
    global launches
    N, S, hd = r.shape
    out = torch.empty((N, S, hd), dtype=torch.float32, device=r.device)
    state = torch.empty_like(state0)
    states_shape, wlast_shape = scratch_shapes(N, S, hd)
    states = torch.empty(states_shape, dtype=torch.float32, device=r.device)
    wlast = torch.empty(wlast_shape, dtype=torch.float32, device=r.device)
    note("rwkv6_scan", cost, r, k, v, logw, u, state0, (out, state))
    if r.device.type == "meta":
        return out, state, states
    fn = _build.function("rwkv6_scan", _ARGTYPES)
    stream = torch.cuda.current_stream(r.device).cuda_stream
    err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
             u.data_ptr(), state0.data_ptr(), out.data_ptr(), state.data_ptr(),
             states.data_ptr(), wlast.data_ptr(),
             N, S, hd, _DTYPES[r.dtype], stream)
    _build.check("rwkv6_scan", err)
    launches += 1
    return out, state, states


def rwkv6_scan_fwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   logw: torch.Tensor, u: torch.Tensor, state0: torch.Tensor):
    """(out, state, states): the forward and the state entering each chunk
    (``scratch_shapes(...)[0]``), as :class:`RWKV6Scan` keeps them for
    :func:`bwd.rwkv6_scan_bwd`.  No autograd; CUDA only."""
    _check(r, k, v, logw, u, state0)
    if r.device.type not in ("cuda", "meta"):
        raise ValueError(f"rwkv6_scan_fwd: no kernel for {r.device}")
    return _launch(r, k, v, logw, u, state0)


class RWKV6Scan(torch.autograd.Function):
    """The forward kernel, keeping the state entering each chunk, and the
    backward kernel for its gradient."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u, state0):
        out, state, states = rwkv6_scan_fwd(r, k, v, logw, u, state0)
        ctx.save_for_backward(r, k, v, logw, u, state0, states)
        ctx.set_materialize_grads(False)
        return out, state

    @staticmethod
    def backward(ctx, dout, dstate):
        from repro_torch.kernels.rwkv6_scan import bwd   # it imports this module
        r, k, v, logw, u, state0, states = ctx.saved_tensors
        dout = torch.zeros_like(logw) if dout is None \
            else dout.float().contiguous()
        dstate = None if dstate is None else dstate.float().contiguous()
        return bwd.rwkv6_scan_bwd(r, k, v, logw, u, state0, dout, dstate,
                                  states=states)


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               logw: torch.Tensor, u: torch.Tensor, state0: torch.Tensor):
    """The RWKV-6 WKV recurrence over N = batch * heads rows.

    r, k, v: (N, S, hd), float32 or bfloat16; logw: (N, S, hd) float32
    log-decays (< 0); u: (N, hd) float32 bonus; state0: (N, hd, hd) float32.
    Returns (out (N, S, hd) f32, state (N, hd, hd) f32), with a ``grad_fn``
    when grad mode is on and an input requires grad.
    """
    _check(r, k, v, logw, u, state0)
    if r.device.type == "cpu":
        return rwkv6_scan_ref(r, k, v, logw, u, state0)
    if r.device.type not in ("cuda", "meta"):
        raise ValueError(f"rwkv6_scan: no kernel for {r.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (r, k, v, logw, u, state0)):
        return RWKV6Scan.apply(r, k, v, logw, u, state0)
    return _launch(r, k, v, logw, u, state0)[:2]


def rwkv6_scan_by_heads(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        logw: torch.Tensor, u: torch.Tensor,
                        state0: torch.Tensor = None):
    """:func:`rwkv6_scan` from ``state0`` (zeros when None) over (B, H)
    heads, under a mesh on each rank's batch rows and heads
    (``local_map``).

    r, k, v, logw (B, H, S, hd) are laid out alike, their heads on "model"
    or replicated; state0 (B, H, hd, hd) as they are (the decode cache's
    spec, ("batch", "heads", None, None)).  u (H, hd) is a replicated
    param, of which each rank reads the rows of its own heads, so its du
    is partial over "model" (its heads' share) and over the axes that shard
    the batch (its rows' share).  Returns (out (B, H, S, hd), state
    (B, H, hd, hd)), f32, laid out as r.  Plain tensors: the op itself."""
    mesh = r.device_mesh if isinstance(r, DTensor) else None
    split = mesh is not None and isinstance(sh.on_model(r), Shard)

    def local(rl, kl, vl, wl, ul, sl=None):
        B, H, S, hd = rl.shape
        first = sh.model_rank(mesh) * H if split else 0

        def rows(t):
            return t.contiguous().reshape(B * H, S, hd)

        s0 = torch.zeros((B * H, hd, hd), dtype=torch.float32,
                         device=rl.device) if sl is None \
            else sl.float().reshape(B * H, hd, hd).contiguous()
        out, state = rwkv6_scan(rows(rl), rows(kl), rows(vl),
                                rows(wl.float()),
                                ul[first:first + H].float().repeat(B, 1), s0)
        return out.reshape(B, H, S, hd), state.reshape(B, H, hd, hd)

    ss = () if state0 is None else (state0,)
    if mesh is None:
        return local(r, k, v, logw, u, *ss)
    grads = (r.placements, k.placements, v.placements, logw.placements,
             sh.batch_grad(r, u, split)) + tuple(s.placements for s in ss)
    return sh.run_local(local, [r.placements, r.placements], r, k, v, logw,
                        u, *ss, in_grad_placements=grads)


__all__ = ["rwkv6_scan", "rwkv6_scan_fwd", "rwkv6_scan_by_heads",
           "RWKV6Scan", "rwkv6_scan_ref", "cost", "ref"]
