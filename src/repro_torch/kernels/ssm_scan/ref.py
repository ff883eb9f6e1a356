"""Plain PyTorch version of the Mamba selective scan (the kernel's CPU path
and its on-card yardstick): the sequential recurrence, one time step at a
time, all in f32."""
from __future__ import annotations

import torch

# calls of the plain version; the server's run on the card must leave it at 0
calls = 0


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
    uf, dtf = u.float(), dt.float()
    A = -torch.exp(A_log.float())
    Bf, Cf, Df = B.float(), C.float(), D.float()
    h = h0.float()
    ys = []
    for t in range(u.shape[1]):
        da = torch.exp(dtf[:, t, :, None] * A[None])                # (Bz,di,ds)
        dbu = (dtf[:, t] * uf[:, t])[:, :, None] * Bf[:, t, None, :]
        h = da * h + dbu
        ys.append(torch.einsum("bds,bs->bd", h, Cf[:, t]) + uf[:, t] * Df)
    return torch.stack(ys, dim=1), h
