"""Common model building blocks (PyTorch twin of ``repro.models.layers``).

Parameters are plain nested dicts of tensors, in the JAX package's layout:
projections are 2-D ``(d_in, d_out)`` matrices (stacked to ``(L, d_in,
d_out)`` by the stack), so a JAX param tree maps onto this one key for key.
Initialisers draw from an explicit ``torch.Generator`` and allocate on its
device; they use the reference's distributions and scales, not its bits.

Under a mesh (``repro_torch.sharding``) the params and activations are
DTensors, and each product makes its collectives explicit rather than left
to DTensor's choice of strategy: the weight's FSDP shard is gathered over
"data" and its "model" shard kept; the activation's contraction dim is laid
out on "model" as the weight's d_in is (gathered before a column-parallel
product, sliced before a row-parallel one); an activation's batch shard is
never gathered.  A row-parallel product's pending sum over "model" is
all-reduced at its output.
"""
from __future__ import annotations

import math
import os
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch import sharding as sh

Params = Dict[str, Any]


def tree_map(fn, *trees):
    """Apply ``fn`` leaf by leaf over nested dicts of the same keys."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def leaves(tree):
    """The leaves of nested dicts, in key order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    else:
        yield tree


def copy_into_leading(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst``'s leading part of ``src``'s shape = ``src``, in place (a cache
    of S positions into one of more)."""
    dst[tuple(slice(0, n) for n in src.shape)].copy_(src)


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


# ---------------------------------------------------------------------------
# Initialisers
# ---------------------------------------------------------------------------


def _normal(gen: torch.Generator, shape, scale: float, dtype) -> torch.Tensor:
    x = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return x.mul_(scale).to(dtype)


def _normal_stack(gen: torch.Generator, n: int, shape, scale: float, dtype
                  ) -> torch.Tensor:
    """``n`` draws of ``_normal`` stacked on a leading axis, drawn one at a
    time into the stacked tensor: no f32 temporary of the whole stack."""
    out = torch.empty((n,) + tuple(shape), dtype=dtype, device=gen.device)
    for i in range(n):
        out[i] = _normal(gen, shape, scale, dtype)
    return out


def init_linear(gen: torch.Generator, d_in: int, d_out: int, dtype,
                bias: bool = False, scale: Optional[float] = None) -> Params:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    p = {"w": _normal(gen, (d_in, d_out), scale, dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=gen.device)
    return p


def cast_before_reduce() -> bool:
    """``REPRO_BF16_AR`` (default on), read at each call: the products'
    output dtype is the compute dtype, so a row-parallel product's sum over
    "model" is reduced in bf16 (f32 accumulation inside each product; only
    the reduction across shards is rounded).  ``REPRO_BF16_AR=0`` gives f32
    products, reduced in f32, then cast."""
    return os.environ.get("REPRO_BF16_AR", "1") != "0"


def product_operands(x: DTensor, w: DTensor) -> Tuple[DTensor, DTensor]:
    """(x, w) laid out for ``x @ w`` under a mesh: w's FSDP shard gathered
    and its "model" shard kept; x's contraction dim on "model" as w's d_in
    is (sharded when w is row-parallel, else gathered), its other
    placements (the batch's) kept."""
    w = sh.gather_fsdp(w)
    want = Shard(x.ndim - 1) if sh.on_model(w) == Shard(0) else Replicate()
    return sh.with_placement(x, "model", want), w


def _matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for a 2-D ``w``: ``torch.matmul`` on one chip; under a mesh
    one 2-D product over x's rows (``torch.matmul`` may expand ``w`` over
    a DTensor's batch instead, and copy it a row)."""
    if not isinstance(x, DTensor):
        return torch.matmul(x, w)
    y = torch.mm(x.reshape(-1, x.shape[-1]), w)
    return y.reshape(x.shape[:-1] + (w.shape[-1],))


def linear(p: Params, x: torch.Tensor, compute_dtype=torch.bfloat16
           ) -> torch.Tensor:
    """``x @ w (+ b)``.  The product comes out in the compute dtype (the
    reference's default cast-before-reduce: f32 accumulation inside the
    product, one rounding at its output); the bias is added in f32.  With
    ``REPRO_BF16_AR=0`` the product comes out in f32 from bf16 operands
    upcast to f32, which is exact (``torch.mm`` has no bf16 -> f32 form
    that runs on the CPU or under DTensor), then rounds once.  Under a mesh
    the operands are laid out by :func:`product_operands` and a pending
    sum is reduced before the bias and the rounding."""
    x, w = x.to(compute_dtype), p["w"].to(compute_dtype)
    if isinstance(x, DTensor):
        x, w = product_operands(x, w)
    if cast_before_reduce():
        y = _matmul(x, w)
    else:
        y = _matmul(x.float(), w.float())
    if isinstance(y, DTensor) and isinstance(sh.on_model(y), Partial):
        # a row-parallel product's sum, all-reduced as the reference's
        # compiled program reduces it (a later constrain to "embed" keeps
        # each rank's slice)
        y = sh.with_placement(y, "model", Replicate())
    if "b" in p:
        y = y.float() + p["b"].float()
    return y.to(compute_dtype)


# ---------------------------------------------------------------------------
# Normalisation
# ---------------------------------------------------------------------------


def init_norm(d: int, kind: str, dtype, device=None) -> Params:
    p = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def _mean_last(t: torch.Tensor) -> torch.Tensor:
    """The mean over the last dim, kept.  Under a mesh that dim may be
    sharded on "model": its pending sum is all-reduced here (DTensor left
    to itself scatters a pending mean over the batch), then divided."""
    if not isinstance(t, DTensor):
        return t.mean(dim=-1, keepdim=True)
    s = t.sum(dim=-1, keepdim=True)
    if isinstance(sh.on_model(s), Partial):
        s = sh.with_placement(s, "model", Replicate())
        # its gradient, replicated, reaches each rank's partial sum whole
        # (DTensor would leave it pending and reduce the (B, S, D) product
        # that expands it)
        s = sh.grad_as(s, s.placements)
    return s / t.shape[-1]


def apply_norm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    if "bias" in p:  # layernorm
        mu = _mean_last(xf)
        if isinstance(xf, DTensor):
            var = _mean_last((xf - mu).square())
        else:
            var = xf.var(dim=-1, keepdim=True, correction=0)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"].float() + p["bias"].float()
    else:  # rmsnorm
        ms = _mean_last(xf.square())
        y = xf * torch.rsqrt(ms + eps) * p["scale"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (exps / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S).  Split-half
    rotation."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                 # (hd/2,)
    angles = positions[..., None].float() * freqs            # (..., S, hd/2)
    angles = angles[..., None, :]                            # (..., S, 1, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention, plain PyTorch.  The model's attention runs through the kernels
# in repro_torch.kernels; these are the twins of the reference's XLA paths.
# ---------------------------------------------------------------------------


def _kv_len_mask(kv_len, k_pos: torch.Tensor, B: int) -> torch.Tensor:
    vl = torch.as_tensor(kv_len, device=k_pos.device).reshape(-1, 1, 1, 1, 1)
    return k_pos[None, None, None, None, :] < vl.expand(B, 1, 1, 1, 1)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      *, causal: bool, q_offset: int = 0,
                      chunk_q: int = 512, chunk_k: int = 1024,
                      kv_len=None) -> torch.Tensor:
    """Online-softmax attention over key chunks.

    q: (B, Hq, Sq, hd);  k, v: (B, Hkv, Sk, hd) with Hq % Hkv == 0 (GQA).
    ``q_offset``: absolute position of q[0].  ``kv_len``: optional scalar or
    (B,) valid kv lengths.  Returns (B, Hq, Sq, hd) in q.dtype.
    """
    B, Hq, Sq, hd = q.shape
    _, Hkv, Sk, _ = k.shape
    vd = v.shape[-1]
    group = Hq // Hkv
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(B, Hkv, group, Sq, hd).float()

    chunk_q = min(chunk_q, Sq)
    chunk_k = min(chunk_k, Sk)
    nq, nk = -(-Sq // chunk_q), -(-Sk // chunk_k)
    q_pad, k_pad = nq * chunk_q - Sq, nk * chunk_k - Sk
    if q_pad:
        qg = F.pad(qg, (0, 0, 0, q_pad))
    if k_pad:
        k = F.pad(k, (0, 0, 0, k_pad))
        v = F.pad(v, (0, 0, 0, k_pad))

    dev = q.device
    q_pos = q_offset + torch.arange(nq * chunk_q, device=dev)
    k_pos = torch.arange(nk * chunk_k, device=dev)
    shape = (B, Hkv, group, nq * chunk_q)
    acc = torch.zeros(shape + (vd,), dtype=torch.float32, device=dev)
    m = torch.full(shape + (1,), -math.inf, dtype=torch.float32, device=dev)
    denom = torch.zeros(shape + (1,), dtype=torch.float32, device=dev)
    for kc in range(nk):
        sl = slice(kc * chunk_k, (kc + 1) * chunk_k)
        ks, vs, kp = k[:, :, sl].float(), v[:, :, sl], k_pos[sl]
        s = torch.einsum("bngqd,bnkd->bngqk", qg, ks) * scale
        mask = torch.ones(s.shape, dtype=torch.bool, device=dev)
        if causal:
            mask = (q_pos[:, None] >= kp[None, :])[None, None, None]
        if kv_len is not None:
            mask = mask & _kv_len_mask(kv_len, kp, B)
        elif k_pad:
            mask = mask & (kp < Sk)[None, None, None, None, :]
        s = s.masked_fill(~mask, -math.inf)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        # guard rows where everything is masked (m_new == -inf)
        m_safe = torch.where(torch.isfinite(m_new), m_new,
                             torch.zeros_like(m_new))
        p = torch.exp(s - m_safe).masked_fill(~mask, 0.0)
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe),
                           torch.zeros_like(m))
        denom = denom * corr + p.sum(dim=-1, keepdim=True)
        pv = torch.einsum("bngqk,bnkd->bngqd", p.to(vs.dtype).float(),
                          vs.float())
        acc = acc * corr + pv
        m = m_new
    out = acc / torch.clamp(denom, min=1e-30)
    out = out.reshape(B, Hq, nq * chunk_q, vd)[:, :, :Sq]
    return out.to(q.dtype)


def full_attention(q, k, v, *, causal: bool, q_offset: int = 0,
                   kv_len=None) -> torch.Tensor:
    """Full-materialisation softmax attention (small shapes only)."""
    B, Hq, Sq, hd = q.shape
    _, Hkv, Sk, _ = k.shape
    vd = v.shape[-1]
    group = Hq // Hkv
    dev = q.device
    qg = q.reshape(B, Hkv, group, Sq, hd).float()
    s = torch.einsum("bngqd,bnkd->bngqk", qg, k.float()) / math.sqrt(hd)
    q_pos = q_offset + torch.arange(Sq, device=dev)
    k_pos = torch.arange(Sk, device=dev)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=dev)
    if causal:
        mask = q_pos[:, None] >= k_pos[None, :]
    mask = mask[None, None, None]
    if kv_len is not None:
        mask = mask & _kv_len_mask(kv_len, k_pos, B)
    s = s.masked_fill(~mask, -math.inf)
    p = torch.softmax(s, dim=-1)
    p = torch.nan_to_num(p, nan=0.0)
    out = torch.einsum("bngqk,bnkd->bngqd", p.to(v.dtype).float(), v.float())
    return out.reshape(B, Hq, Sq, vd).to(q.dtype)


def attention(q, k, v, *, causal: bool, q_offset: int = 0, kv_len=None,
              chunked_threshold: int = 1024) -> torch.Tensor:
    """Dispatch: full softmax for short sequences, online-softmax otherwise."""
    if q.shape[2] * k.shape[2] <= chunked_threshold ** 2:
        return full_attention(q, k, v, causal=causal, q_offset=q_offset,
                              kv_len=kv_len)
    return chunked_attention(q, k, v, causal=causal, q_offset=q_offset,
                             kv_len=kv_len)


# ---------------------------------------------------------------------------
# Feed-forward
# ---------------------------------------------------------------------------


def init_ffn(gen: torch.Generator, d_model: int, d_ff: int, act: str,
             dtype) -> Params:
    p = {"w_up": init_linear(gen, d_model, d_ff, dtype),
         "w_down": init_linear(gen, d_ff, d_model, dtype)}
    if act == "swiglu":
        p["w_gate"] = init_linear(gen, d_model, d_ff, dtype)
    return p


def apply_ffn(p: Params, x: torch.Tensor, act: str,
              compute_dtype=torch.bfloat16) -> torch.Tensor:
    if isinstance(x, DTensor):   # one gather over "model" for both products
        x = sh.with_placement(x.to(compute_dtype), "model", Replicate())
    h = linear(p["w_up"], x, compute_dtype)
    if act == "swiglu":
        g = linear(p["w_gate"], x, compute_dtype)
        h = F.silu(g.float()).to(compute_dtype) * h
    elif act == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(h.float(), approximate="tanh").to(compute_dtype)
    elif act == "relu2":
        h = F.relu(h.float()).square().to(compute_dtype)
    else:
        raise ValueError(act)
    return linear(p["w_down"], h, compute_dtype)


# ---------------------------------------------------------------------------
# Mixture of Experts: grouped, capacity-based, one-hot dispatch and combine,
# with the reference's Switch/T5X semantics (tokens over an expert's
# capacity contribute zero).  The expert products are plain batched matrix
# products over all E experts (a mesh rank's E/m), as the reference leaves
# them to XLA.
# ---------------------------------------------------------------------------


def init_moe(gen: torch.Generator, cfg, dtype) -> Params:
    """The router is f32 whatever ``dtype`` is, as in the reference; each
    expert's matrices are drawn one expert at a time."""
    m = cfg.moe
    d, f, e = cfg.d_model, m.d_ff_expert, m.num_experts
    scale_in = 1.0 / math.sqrt(d)
    p = {
        "router": init_linear(gen, d, e, torch.float32, scale=scale_in),
        "w_up": _normal_stack(gen, e, (d, f), scale_in, dtype),
        "w_gate": _normal_stack(gen, e, (d, f), scale_in, dtype),
        "w_down": _normal_stack(gen, e, (f, d), 1.0 / math.sqrt(f), dtype),
    }
    if m.num_shared_experts:
        f_sh = m.d_ff_shared or f * m.num_shared_experts
        p["shared"] = init_ffn(gen, d, f_sh, "swiglu", dtype)
    return p


def moe_capacity(seq: int, num_experts: int, top_k: int,
                 capacity_factor: float = 1.25) -> int:
    c = int(math.ceil(seq * top_k / num_experts * capacity_factor))
    return max(4, min(c, seq * top_k))


MOE_GROUP_SIZE = 4096   # routing-group tokens; capacity scales with the
#                         group, not the sequence


def one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``F.one_hot(idx, n)`` in f32 by one comparison, the same ops on every
    device (``F.one_hot`` scatters on the card and compares on ``meta``, so
    a dry run would count other ops than the card runs)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def _group_len(S0: int) -> int:
    """Tokens in a routing group of a sequence of ``S0``: ``MOE_GROUP_SIZE``
    when the sequence is a longer multiple of it, else the sequence."""
    if S0 > MOE_GROUP_SIZE and S0 % MOE_GROUP_SIZE == 0:
        return MOE_GROUP_SIZE
    return S0


def _routing_groups(x: torch.Tensor) -> torch.Tensor:
    """(G0, S0, ...) re-grouped into routing groups of
    :func:`_group_len` tokens."""
    S = _group_len(x.shape[1])
    return x if S == x.shape[1] else x.reshape((-1, S) + tuple(x.shape[2:]))


def moe_slots(cfg, S: int, capacity_factor: Optional[float] = None) -> int:
    """C, an expert's slots in a routing group of ``S`` tokens (S K when
    the capacity factor is <= 0: dropless)."""
    m = cfg.moe
    cf = m.capacity_factor if capacity_factor is None else capacity_factor
    K = m.num_experts_per_tok
    return S * K if cf <= 0 else moe_capacity(S, m.num_experts, K, cf)


def _route(probs: torch.Tensor, K: int, C: int, experts: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(onehot (G,S,K,E'), dispatch (G,S,E',C), combine (G,S,E',C)) of the
    experts ``experts`` (ids, E' of them) for router ``probs`` (G,S,E):
    top-K, renormalised; a choice takes its expert's next slot, earlier
    tokens first, then earlier choices; past C slots it is dropped.  An
    expert's slots depend on its own column alone, so a subset of the
    experts routes as all of them do."""
    G, S, _ = probs.shape
    gate_vals, gate_idx = torch.topk(probs, K, dim=-1)             # (G,S,K)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    # expert one-hot per choice
    onehot = (gate_idx[..., None] == experts).float()
    # position of each (token, choice) within its expert queue
    flat = onehot.reshape(G, S * K, -1)
    pos = (torch.cumsum(flat, dim=1) * flat - 1.0).reshape(onehot.shape)
    within_cap = (pos >= 0) & (pos < C)
    pos = torch.clamp(pos, 0, C - 1).long()

    # dispatch one-hot over capacity: (G,S,K,E',C) -> reduce over K
    cap_oh = one_hot(pos, C) * within_cap[..., None] \
        * onehot[..., None]
    dispatch = cap_oh.sum(dim=2)
    combine = (cap_oh * gate_vals[..., None, None]).sum(dim=2)
    return onehot, dispatch, combine


def _expert_ffn(x: torch.Tensor, dispatch: torch.Tensor,
                combine: torch.Tensor, w_up: torch.Tensor,
                w_gate: torch.Tensor, w_down: torch.Tensor, cd
                ) -> torch.Tensor:
    """The experts' SwiGLU on their slots, combined back to (G, S, D): one
    ``torch.bmm`` an expert bank over the E' experts of ``dispatch``."""
    G, _, E, C = dispatch.shape
    D = x.shape[-1]
    xe = torch.einsum("gsec,gsd->egcd", dispatch.to(cd), x.to(cd))
    xe = xe.reshape(E, G * C, D)
    up = torch.bmm(xe, w_up.to(cd))
    gate = torch.bmm(xe, w_gate.to(cd))
    h = (F.silu(gate.float()) * up.float()).to(cd)
    ye = torch.bmm(h, w_down.to(cd)).reshape(E, G, C, D)
    return torch.einsum("gsec,egcd->gsd", combine.to(cd), ye)


def apply_moe(p: Params, x: torch.Tensor, cfg,
              capacity_factor: Optional[float] = None,
              compute_dtype=torch.bfloat16, aux_loss: bool = True
              ) -> Tuple[torch.Tensor, Any]:
    """x: (G, S, D) groups of tokens (batch rows).  Returns (out, aux_loss);
    the aux loss is the number 0.0 when ``aux_loss`` is off (prefill and
    decode, which drop it; under a mesh it costs two all-reduces).

    The up and gate products come out in the compute dtype (f32 in the
    reference); with a bf16 compute dtype that is one more rounding of each
    before the SwiGLU.  Under a mesh: :func:`_apply_moe_sharded`."""
    if isinstance(x, DTensor):
        return _apply_moe_sharded(p, x, cfg, capacity_factor, compute_dtype,
                                  aux_loss)
    m = cfg.moe
    G0, S0, D = x.shape
    x = _routing_groups(x)
    G, S, D = x.shape
    E, K = m.num_experts, m.num_experts_per_tok
    C = moe_slots(cfg, S, capacity_factor)

    logits = torch.einsum("gsd,de->gse", x.float(), p["router"]["w"].float())
    probs = torch.softmax(logits, dim=-1)                          # (G,S,E)
    onehot, dispatch, combine = _route(
        probs, K, C, torch.arange(E, device=x.device))

    cd = compute_dtype
    y = _expert_ffn(x, dispatch, combine, p["w_up"], p["w_gate"],
                    p["w_down"], cd)

    if "shared" in p:
        y = y + apply_ffn(p["shared"], x, "swiglu", cd)
    if (G, S) != (G0, S0):
        y = y.reshape(G0, S0, D)
    if not aux_loss:
        return y, 0.0

    # load-balancing aux loss (Switch): E * sum_e f_e * p_e
    density = onehot.sum(dim=2).mean(dim=(0, 1))                   # (E,)
    router_prob = probs.mean(dim=(0, 1))                           # (E,)
    aux = E * torch.sum(density / K * router_prob)
    return y, aux


def _apply_moe_sharded(p: Params, x: DTensor, cfg,
                       capacity_factor: Optional[float], cd, aux_loss: bool
                       ) -> Tuple[DTensor, Any]:
    """:func:`apply_moe` under a mesh, its experts on "model": each rank
    routes its own batch rows (routing is per group, so sharding the batch
    changes no decision) and runs its E/m experts alone.

    * The router's product is split over "model" as x's d_model is (each
      rank its rows of the replicated router), its sum all-reduced: the
      (G, S, E) probabilities, replicated over "model".
    * Each rank gathers x over "model" and its own experts' weights over
      "data" (their FSDP shard), routes every token to its E/m experts
      (:func:`_route` on their ids) and runs them (:func:`_expert_ffn`).
      Its combined output is its experts' share, a sum pending over
      "model", all-reduced as a row-parallel product's is.
    * The aux loss's per-expert counts and probability sums are summed over
      the batch's ranks before the product, as the reference's mean over
      the global (G, S).

    With E not a multiple of the "model" axis the expert banks are
    replicated and each rank runs all of them."""
    m = cfg.moe
    E, K = m.num_experts, m.num_experts_per_tok
    mesh = x.device_mesh
    G0, S0, D = x.shape

    # the router: x's d_model rows against the router's same rows
    w_r = p["router"]["w"]
    if isinstance(sh.on_model(x), Shard):
        w_r = sh.with_placement(w_r, "model", Shard(0))
    split = sh.on_model(w_r) == Shard(0)
    logits = sh.run_local(
        lambda xl, wl: torch.einsum("gsd,de->gse", xl.float(), wl.float()),
        sh.on_model_as(x, Partial() if split else Replicate()), x, w_r,
        in_grad_placements=(x.placements, sh.batch_grad(x, w_r)))
    logits = sh.with_placement(logits, "model", Replicate())
    probs = torch.softmax(logits, dim=-1)                          # (G,S,E)

    # each rank's experts on its batch rows
    x = sh.with_placement(x.to(cd), "model", Replicate())
    w_up, w_gate, w_down = (sh.gather_fsdp(p[k].to(cd))
                            for k in ("w_up", "w_gate", "w_down"))
    experts_sharded = sh.on_model(w_up) == Shard(0)
    n_local = w_up.to_local().shape[0]
    first = sh.model_rank(mesh) * n_local if experts_sharded else 0
    C = moe_slots(cfg, _group_len(S0), capacity_factor)

    def experts(xl, pl, wu, wg, wd):
        xg, pg = _routing_groups(xl), _routing_groups(pl)
        ids = torch.arange(first, first + n_local, device=xl.device)
        _, dispatch, combine = _route(pg, K, C, ids)
        return _expert_ffn(xg, dispatch, combine, wu, wg, wd, cd
                           ).reshape(xl.shape)

    share = Partial() if experts_sharded else Replicate()
    rows = sh.on_model_as(x, share)
    grads = (rows, sh.on_model_as(probs, share)) + tuple(
        sh.batch_grad(x, w) for w in (w_up, w_gate, w_down))
    y = sh.run_local(experts, rows, x, probs, w_up, w_gate, w_down,
                     in_grad_placements=grads)
    y = sh.with_placement(y, "model", Replicate())

    if "shared" in p:
        y = y + apply_ffn(p["shared"], x, "swiglu", cd)
    if not aux_loss:
        return y, 0.0

    # load-balancing aux loss (Switch) over the global (G, S)
    def counts(pl):
        return one_hot(torch.topk(pl, K, dim=-1)[1], E).sum(dim=(0, 1, 2))

    whole = (Replicate(),) * mesh.ndim
    tokens = G0 * S0
    summed = tuple(Partial() if pl == Shard(0) else Replicate()
                   for pl in probs.placements)
    density = sh.run_local(counts, summed, probs.detach()
                           ).redistribute(mesh, whole) / tokens      # (E,)
    router_prob = probs.sum(dim=(0, 1)).redistribute(mesh, whole) / tokens
    aux = E * torch.sum(density / K * router_prob)
    return y, aux


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------


def init_embedding(gen: torch.Generator, vocab: int, d_model: int,
                   dtype) -> Params:
    return {"table": _normal(gen, (vocab, d_model), 0.02, dtype)}


def embed(p: Params, tokens: torch.Tensor, compute_dtype=torch.bfloat16
          ) -> torch.Tensor:
    if isinstance(tokens, DTensor):
        return _embed_sharded(p["table"], tokens, compute_dtype)
    return p["table"][tokens].to(compute_dtype)


def _embed_sharded(table: DTensor, tokens: DTensor, compute_dtype
                   ) -> DTensor:
    """The lookup under a mesh: the table's FSDP shard gathered; with its
    vocab on "model" each rank looks up the tokens of its own rows, zero
    for the others, and the rows' sum is left pending over "model" (the
    caller's layout reduces it: one nonzero term an element, so exact)."""
    table = sh.gather_fsdp(table)
    vocab_sharded = sh.on_model(table) == Shard(0)
    rows = table.to_local().shape[0] if vocab_sharded else table.shape[0]
    first = sh.model_rank(table.device_mesh) * rows if vocab_sharded else 0

    def lookup(tab, tok):
        idx = tok.long() - first
        hit = (idx >= 0) & (idx < rows)
        out = tab[idx.clamp(0, rows - 1)] * hit[..., None].to(tab.dtype)
        return out.to(compute_dtype)

    md = sh.mesh_dim(tokens.device_mesh, "model")
    out_place = list(tokens.placements)
    if md is not None:
        out_place[md] = Partial() if vocab_sharded else Replicate()
    # a rank looks up its own batch rows: the table's gradient is partial
    # over the axes the tokens are sharded on
    grad = tuple(Partial() if isinstance(t, Shard) else p
                 for t, p in zip(tokens.placements, table.placements))
    return sh.run_local(lookup, tuple(out_place), table, tokens,
                        in_grad_placements=(grad, tokens.placements))


def dot_f32(x: torch.Tensor, w: torch.Tensor, compute_dtype) -> torch.Tensor:
    """``x @ w`` of compute-dtype operands, summed and returned in f32
    (laid out by :func:`product_operands` under a mesh)."""
    x, w = x.to(compute_dtype), w.to(compute_dtype)
    if isinstance(x, DTensor):
        x, w = product_operands(x, w)
    if compute_dtype != torch.float32:
        x, w = x.float(), w.float()
    return _matmul(x, w)


def logits_from_embedding(p: Params, x: torch.Tensor, softcap: float = 0.0,
                          compute_dtype=torch.bfloat16) -> torch.Tensor:
    y = dot_f32(x, p["table"].t(), compute_dtype)
    if softcap:
        y = torch.tanh(y / softcap) * softcap
    return y
