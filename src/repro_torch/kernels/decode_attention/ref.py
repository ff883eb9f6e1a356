"""Plain PyTorch version of flash-decode (the kernel's CPU path and its
on-card yardstick)."""
from __future__ import annotations

import math

import torch

# calls of the plain version; the server's run on the card must leave it at 0
calls = 0


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         kv_len: torch.Tensor) -> torch.Tensor:
    """q: (B, Hq, hd); k, v: (B, Hkv, S, hd); kv_len: (B,) int.

    softmax(q k^T / sqrt(hd)) v over positions < kv_len[b], in f32; a row
    with no valid position gives 0.  Returns (B, Hq, hd) in q.dtype.
    """
    global calls
    calls += 1
    B, Hq, hd = q.shape
    _, Hkv, S, _ = k.shape
    group = Hq // Hkv
    qg = q.reshape(B, Hkv, group, hd).float()
    s = torch.einsum("bngd,bnsd->bngs", qg, k.float()) / math.sqrt(hd)
    pos = torch.arange(S, device=q.device)
    mask = pos[None, :] < kv_len.reshape(B, 1).to(q.device)
    s = s.masked_fill(~mask[:, None, None, :], -math.inf)
    p = torch.nan_to_num(torch.softmax(s, dim=-1), nan=0.0)
    o = torch.einsum("bngs,bnsd->bngd", p, v.float())
    return o.reshape(B, Hq, hd).to(q.dtype)
