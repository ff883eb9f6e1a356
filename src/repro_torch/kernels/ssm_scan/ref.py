"""Plain PyTorch versions of the Mamba selective scan and of its gradient
(the kernels' CPU path and their on-card yardsticks): the sequential
recurrence, one time step at a time, in f32 (in f64 for f64 inputs)."""
from __future__ import annotations

import torch

# calls of the plain versions; the server's run on the card must leave it at 0
calls = 0


def _wide(t: torch.Tensor) -> torch.Tensor:
    """t in f32, or as it is if it is f64."""
    return t if t.dtype == torch.float64 else t.float()


def ssm_scan_ref(u: torch.Tensor, dt: torch.Tensor, A_log: torch.Tensor,
                 B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                 h0: torch.Tensor):
    """u, dt: (Bz, S, di); A_log: (di, ds); B, C: (Bz, S, ds); D: (di,);
    h0: (Bz, di, ds).

    h_t = exp(dt_t * -exp(A_log)) * h_{t-1} + dt_t * u_t * B_t;
    y_t = h_t C_t + u_t * D.  Returns (y (Bz, S, di), h (Bz, di, ds)), f32.
    """
    global calls
    calls += 1
    uf, dtf = _wide(u), _wide(dt)
    A = -torch.exp(_wide(A_log))
    Bf, Cf, Df = _wide(B), _wide(C), _wide(D)
    h = _wide(h0)
    ys = []
    for t in range(u.shape[1]):
        da = torch.exp(dtf[:, t, :, None] * A[None])                # (Bz,di,ds)
        dbu = (dtf[:, t] * uf[:, t])[:, :, None] * Bf[:, t, None, :]
        h = da * h + dbu
        ys.append(torch.einsum("bds,bs->bd", h, Cf[:, t]) + uf[:, t] * Df)
    return torch.stack(ys, dim=1), h


def ssm_scan_bwd_ref(u: torch.Tensor, dt: torch.Tensor, A_log: torch.Tensor,
                     B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                     h0: torch.Tensor, dy: torch.Tensor,
                     dh: torch.Tensor = None):
    """The gradient of :func:`ssm_scan_ref` as an explicit reverse
    recurrence (no autograd): the backward kernel's yardstick.

    dy: (Bz, S, di), the gradient of y; dh: (Bz, di, ds), that of the final
    state (None: zero).  With a = -exp(A_log), da_t = exp(dt_t a) and g_t =
    dL/dh_t = dy_t C_t + da_{t+1} g_{t+1} (g_{S-1} also takes dh):
    dC_t = sum_d h_t dy_t and dB_t = sum_d g_t dt_t u_t (over all channels),
    du_t = sum_s g_t dt_t B_t + dy_t D, ddt_t = sum_s g_t (a da_t h_{t-1} +
    u_t B_t), dA_log = sum_{b,t} g_t da_t h_{t-1} dt_t a and dD = sum_{b,t}
    dy_t u_t (over rows and steps), dh0 = da_0 g_0.  Returns (du, ddt,
    dA_log, dB, dC, dD, dh0) in the shapes of the inputs.
    """
    global calls
    calls += 1
    uf, dtf, dyf = _wide(u), _wide(dt), _wide(dy)
    A = -torch.exp(_wide(A_log))
    Bf, Cf = _wide(B), _wide(C)
    h = _wide(h0)
    hs = [h]                                   # hs[t + 1] = h_t
    for t in range(u.shape[1]):
        da = torch.exp(dtf[:, t, :, None] * A[None])
        h = da * h + (dtf[:, t] * uf[:, t])[:, :, None] * Bf[:, t, None, :]
        hs.append(h)
    g = torch.zeros_like(h) if dh is None else _wide(dh).clone()
    du, ddt = torch.empty_like(uf), torch.empty_like(dtf)
    dB, dC = torch.empty_like(Bf), torch.empty_like(Cf)
    dA = torch.zeros_like(A)
    for t in reversed(range(u.shape[1])):
        h_t, h_prev = hs[t + 1], hs[t]
        da = torch.exp(dtf[:, t, :, None] * A[None])        # (Bz, di, ds)
        g = g + dyf[:, t, :, None] * Cf[:, t, None, :]       # g_t
        dC[:, t] = torch.einsum("bds,bd->bs", h_t, dyf[:, t])
        dB[:, t] = torch.einsum("bds,bd->bs", g, dtf[:, t] * uf[:, t])
        gb = torch.einsum("bds,bs->bd", g, Bf[:, t])
        du[:, t] = dtf[:, t] * gb + dyf[:, t] * _wide(D)
        gdah = g * da * h_prev
        ddt[:, t] = (gdah * A[None]).sum(-1) + uf[:, t] * gb
        dA += (gdah * dtf[:, t, :, None]).sum(0) * A
        g = da * g                                           # da_t g_t
    dD = (dyf * uf).sum((0, 1))
    return du, ddt, dA, dB, dC, dD, g
