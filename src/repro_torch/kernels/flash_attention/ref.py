"""Plain PyTorch versions of the flash-attention forward and backward (the
kernels' CPU path and their on-card yardstick)."""
from __future__ import annotations

import math

import torch

# calls of the plain versions; a run on the card must leave it at 0
calls = 0

# the (hd, hd_v) pairs the kernels (forward and backward) take, each width in
# 64-column slices: one class up to 128, or MLA's 192 with 128
PAIRS = {(1, 1), (2, 2), (3, 2)}


def check_widths(name: str, hd: int, hd_v: int) -> None:
    """Raise ValueError unless the kernels take (hd, hd_v): hd_v <= hd,
    both in one 64-wide class up to 128, or hd in (128, 192] with hd_v in
    (64, 128]."""
    if hd_v > hd or (-(-hd // 64), -(-hd_v // 64)) not in PAIRS:
        raise ValueError(f"{name}: want hd_v <= hd <= 192, both in one "
                         "64-wide class up to 128, or hd in (128, 192] with "
                         f"hd_v in (64, 128]; got hd {hd}, hd_v {hd_v}")


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool, q_offset: int
            ) -> torch.Tensor:
    """f32 scaled scores (B, Hkv, group, Sq, Sk), -inf where masked."""
    B, Hq, Sq, hd = q.shape
    _, Hkv, Sk, _ = k.shape
    qg = q.reshape(B, Hkv, Hq // Hkv, Sq, hd).float()
    s = torch.einsum("bngqd,bnkd->bngqk", qg, k.float()) / math.sqrt(hd)
    if causal:
        q_pos = q_offset + torch.arange(Sq, device=q.device)
        k_pos = torch.arange(Sk, device=q.device)
        s = s.masked_fill(q_pos[:, None] < k_pos[None, :], -math.inf)
    return s


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """q: (B, Hq, Sq, hd); k: (B, Hkv, Sk, hd); v: (B, Hkv, Sk, hd_v); query
    i sits at position ``q_offset + i``.  f32 softmax attention, scaled by
    1 / sqrt(hd); a row with no visible key gives 0.  Returns (B, Hq, Sq,
    hd_v) in q.dtype."""
    global calls
    calls += 1
    B, Hq, Sq, _ = q.shape
    s = _scores(q, k, causal, q_offset)
    p = torch.nan_to_num(torch.softmax(s, dim=-1), nan=0.0)
    o = torch.einsum("bngqk,bnkd->bngqd", p, v.float())
    return o.reshape(B, Hq, Sq, v.shape[-1]).to(q.dtype)


def attention_lse_ref(q: torch.Tensor, k: torch.Tensor, *,
                      causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """Each query row's log-sum-exp of its scaled visible scores, (B, Hq,
    Sq) f32: what the forward kernel keeps for the backward.  A row with no
    visible key gets +inf, so that ``exp(s - lse)`` is 0 there."""
    global calls
    calls += 1
    B, Hq, Sq, _ = q.shape
    lse = torch.logsumexp(_scores(q, k, causal, q_offset), dim=-1)
    return lse.masked_fill(torch.isneginf(lse), math.inf).reshape(B, Hq, Sq)


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                      causal: bool = True, q_offset: int = 0):
    """Gradients of :func:`attention_ref` for the output gradient ``do``,
    from the forward's output ``o`` and row log-sum-exps ``lse`` (B, Hq, Sq)
    f32, in explicit f32 tensor ops (the FA2 form):

        P  = exp(S - lse)            S = q k^T / sqrt(hd), masked
        dv = P^T do                  summed over a KV head's query heads
        dP = do v^T,  D = rowsum(do * o),  dS = P (dP - D)
        dq = dS k / sqrt(hd),  dk = dS^T q / sqrt(hd)

    Returns (dq, dk, dv) in the dtypes of q, k, v."""
    global calls
    calls += 1
    B, Hq, Sq, hd = q.shape
    _, Hkv, Sk, _ = k.shape
    group = Hq // Hkv
    scale = 1.0 / math.sqrt(hd)

    def grouped(t):
        return t.reshape(B, Hkv, group, *t.shape[2:]).float()

    p = torch.exp(_scores(q, k, causal, q_offset) - grouped(lse)[..., None])
    dog = grouped(do)
    dv = torch.einsum("bngqk,bngqd->bnkd", p, dog)
    dp = torch.einsum("bngqd,bnkd->bngqk", dog, v.float())
    delta = (dog * grouped(o)).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    dq = torch.einsum("bngqk,bnkd->bngqd", ds, k.float()) * scale
    dk = torch.einsum("bngqk,bngqd->bnkd", ds, grouped(q)) * scale
    return (dq.reshape(B, Hq, Sq, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
