"""Plain PyTorch version of the RWKV-6 WKV recurrence (the kernel's CPU path
and its on-card yardstick): the sequential form, one time step at a time."""
from __future__ import annotations

import torch

# calls of the plain version; the server's run on the card must leave it at 0
calls = 0


def rwkv6_scan_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   logw: torch.Tensor, u: torch.Tensor, state0: torch.Tensor):
    """r, k, v, logw: (N, S, hd); u: (N, hd); state0: (N, hd, hd).

    y_t = r_t (S_{t-1} + diag(u) k_t^T v_t);  S_t = diag(w_t) S_{t-1} + k_t^T v_t
    with w_t = exp(logw_t).  Returns (out (N, S, hd), state (N, hd, hd)), f32.
    """
    global calls
    calls += 1
    rf, kf, vf = r.float(), k.float(), v.float()
    wf = torch.exp(logw.float())
    uf = u.float()[:, :, None]
    s = state0.float()
    ys = []
    for t in range(r.shape[1]):
        kv = kf[:, t, :, None] * vf[:, t, None, :]            # (N, hd, hd)
        ys.append(torch.einsum("nk,nkv->nv", rf[:, t], s + uf * kv))
        s = wf[:, t, :, None] * s + kv
    return torch.stack(ys, dim=1), s
