"""Plain PyTorch version of the absorbed MLA decode (the kernel's CPU path
and its on-card yardstick): the reference's einsums between ``q_abs`` and
``ctx`` (``src/repro/models/attention.py``, ``apply_mla``'s decode)."""
from __future__ import annotations

import math

import torch

# calls of the plain version; the server's run on the card must leave it at 0
calls = 0


def mla_decode_ref(q_abs: torch.Tensor, q_rope: torch.Tensor,
                   ckv: torch.Tensor, krope: torch.Tensor,
                   kv_len: torch.Tensor, scale: float) -> torch.Tensor:
    """q_abs: (B, H, L); q_rope: (B, H, R); ckv: (B, T, L); krope: (B, T,
    R); kv_len: (B,) int.

    s = (q_abs . ckv + q_rope . krope) * scale over positions t < kv_len[b]
    in f32, softmax, the probabilities rounded to the input dtype, and ctx
    = P . ckv summed in f32; a row with no valid position gives 0.  Returns
    ctx (B, H, L) in q_abs.dtype.
    """
    global calls
    calls += 1
    T = ckv.shape[1]
    s = torch.einsum("bhl,btl->bht", q_abs.float(), ckv.float())
    s = s + torch.einsum("bhr,btr->bht", q_rope.float(), krope.float())
    s = s * scale
    mask = torch.arange(T, device=ckv.device)[None, :] \
        < kv_len.reshape(-1, 1).to(ckv.device)
    s = s.masked_fill(~mask[:, None, :], -math.inf)
    p = torch.nan_to_num(torch.softmax(s, dim=-1), nan=0.0)
    ctx = torch.einsum("bht,btl->bhl", p.to(ckv.dtype).float(), ckv.float())
    return ctx.to(q_abs.dtype)
