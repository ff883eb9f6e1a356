"""Plain PyTorch version of the flash-attention forward (the kernel's CPU
path and its on-card yardstick)."""
from __future__ import annotations

import math

import torch

# calls of the plain version; the prefill's run on the card must leave it at 0
calls = 0


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """q: (B, Hq, Sq, hd); k, v: (B, Hkv, Sk, hd); query i sits at position
    ``q_offset + i``.  f32 softmax attention; a row with no visible key
    gives 0.  Returns (B, Hq, Sq, hd) in q.dtype."""
    global calls
    calls += 1
    B, Hq, Sq, hd = q.shape
    _, Hkv, Sk, _ = k.shape
    group = Hq // Hkv
    qg = q.reshape(B, Hkv, group, Sq, hd).float()
    s = torch.einsum("bngqd,bnkd->bngqk", qg, k.float()) / math.sqrt(hd)
    if causal:
        q_pos = q_offset + torch.arange(Sq, device=q.device)
        k_pos = torch.arange(Sk, device=q.device)
        s = s.masked_fill(q_pos[:, None] < k_pos[None, :], -math.inf)
    p = torch.nan_to_num(torch.softmax(s, dim=-1), nan=0.0)
    o = torch.einsum("bngqk,bnkd->bngqd", p, v.float())
    return o.reshape(B, Hq, Sq, hd).to(q.dtype)
