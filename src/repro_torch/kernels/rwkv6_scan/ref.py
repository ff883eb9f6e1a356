"""Plain PyTorch versions of the RWKV-6 WKV recurrence and of its gradient
(the kernels' CPU path and their on-card yardsticks): the sequential form,
one time step at a time, in f32 (in f64 for f64 inputs)."""
from __future__ import annotations

import torch

# calls of the plain versions; the server's run on the card must leave it at 0
calls = 0


def _wide(t: torch.Tensor) -> torch.Tensor:
    """t in f32, or as it is if it is f64."""
    return t if t.dtype == torch.float64 else t.float()


def rwkv6_scan_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   logw: torch.Tensor, u: torch.Tensor, state0: torch.Tensor):
    """r, k, v, logw: (N, S, hd); u: (N, hd); state0: (N, hd, hd).

    y_t = r_t (S_{t-1} + diag(u) k_t^T v_t);  S_t = diag(w_t) S_{t-1} + k_t^T v_t
    with w_t = exp(logw_t).  Returns (out (N, S, hd), state (N, hd, hd)), f32.
    """
    global calls
    calls += 1
    rf, kf, vf = _wide(r), _wide(k), _wide(v)
    wf = torch.exp(_wide(logw))
    uf = _wide(u)[:, :, None]
    s = _wide(state0)
    ys = []
    for t in range(r.shape[1]):
        kv = kf[:, t, :, None] * vf[:, t, None, :]            # (N, hd, hd)
        ys.append(torch.einsum("nk,nkv->nv", rf[:, t], s + uf * kv))
        s = wf[:, t, :, None] * s + kv
    return torch.stack(ys, dim=1), s


def rwkv6_scan_bwd_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       logw: torch.Tensor, u: torch.Tensor,
                       state0: torch.Tensor, dout: torch.Tensor,
                       dstate: torch.Tensor = None):
    """The gradient of :func:`rwkv6_scan_ref` as the reverse WKV recurrence
    (no autograd): the backward kernel's yardstick.

    dout: (N, S, hd), the gradient of out; dstate: (N, hd, hd), that of the
    final state (None: zero).  With G_t = dL/dS_t, G_{S-1} = dstate and
    G_{t-1} = diag(w_t) G_t + r_t^T dy_t:
    dr_t = (S_{t-1} + diag(u) k_t^T v_t) dy_t, dk_t = G_t v_t + r_t o u
    (v_t . dy_t), dv_t = k_t G_t + (r_t . u o k_t) dy_t, du = sum_t r_t o
    k_t (v_t . dy_t), dlogw_t = w_t o sum_v G_t o S_{t-1} (directly, from
    the stored states), dstate0 = G_{-1}.  Returns (dr, dk, dv, dlogw, du,
    dstate0) in the shapes of the inputs.
    """
    global calls
    calls += 1
    rf, kf, vf, dyf = _wide(r), _wide(k), _wide(v), _wide(dout)
    wf = torch.exp(_wide(logw))
    uf = _wide(u)
    s = _wide(state0)
    prev = []                                  # prev[t] = S_{t-1}
    for t in range(r.shape[1]):
        prev.append(s)
        s = wf[:, t, :, None] * s + kf[:, t, :, None] * vf[:, t, None, :]
    G = torch.zeros_like(s) if dstate is None else _wide(dstate).clone()
    dr, dk, dv, dlogw = (torch.empty_like(rf) for _ in range(4))
    du = torch.zeros_like(uf)
    for t in reversed(range(r.shape[1])):
        vdy = (vf[:, t] * dyf[:, t]).sum(-1, keepdim=True)   # (N, 1)
        dr[:, t] = torch.einsum("nkv,nv->nk", prev[t], dyf[:, t]) \
            + uf * kf[:, t] * vdy
        dk[:, t] = torch.einsum("nkv,nv->nk", G, vf[:, t]) + rf[:, t] * uf * vdy
        bonus = (rf[:, t] * uf * kf[:, t]).sum(-1, keepdim=True)
        dv[:, t] = torch.einsum("nk,nkv->nv", kf[:, t], G) + bonus * dyf[:, t]
        du += rf[:, t] * kf[:, t] * vdy
        dlogw[:, t] = wf[:, t] * (G * prev[t]).sum(-1)
        G = wf[:, t, :, None] * G + rf[:, t, :, None] * dyf[:, t, None, :]
    return dr, dk, dv, dlogw, du, G
