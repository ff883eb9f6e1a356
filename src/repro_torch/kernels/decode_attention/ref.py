"""Plain PyTorch version of flash-decode (the kernel's CPU path and its
on-card yardstick)."""
from __future__ import annotations

import math

import torch

# calls of the plain version; the server's run on the card must leave it at 0
calls = 0


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         kv_len: torch.Tensor, *, return_lse: bool = False):
    """q: (B, Hq, hd); k, v: (B, Hkv, S, hd); kv_len: (B,) int.

    softmax(q k^T / sqrt(hd)) v over positions < kv_len[b], in f32; a row
    with no valid position gives 0.  Returns (B, Hq, hd) in q.dtype, and
    with ``return_lse`` also each row's log-sum-exp of its scaled scores,
    (B, Hq) f32, -inf for a row with no valid position.
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
    o = o.reshape(B, Hq, hd).to(q.dtype)
    if not return_lse:
        return o
    return o, torch.logsumexp(s, dim=-1).reshape(B, Hq)


def merge_partials(outs: torch.Tensor, lses: torch.Tensor) -> torch.Tensor:
    """The attention over the union of disjoint key ranges from each
    range's result: outs (n, B, Hq, hd) and their log-sum-exps lses (n, B,
    Hq) f32, n ranges.  Each range's output is weighted by exp(lse - max
    lse) and the sum divided by the weights' sum, in f32; a range with no
    valid key (lse -inf) weighs 0, and a row with none in any range gives 0
    (no NaN).  Returns (B, Hq, hd) in outs.dtype."""
    m = lses.amax(dim=0)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    w = torch.exp(lses - m)                                   # (n, B, Hq)
    num = (w[..., None] * outs.float()).sum(dim=0)
    den = w.sum(dim=0)[..., None]
    return (num / torch.clamp(den, min=1e-30)).to(outs.dtype)
