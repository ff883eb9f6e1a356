"""Attention mixers (PyTorch twin of ``repro.models.attention``): GQA with
RoPE and optional QKV bias, and MLA (DeepSeek-V2 multi-head latent
attention).

Cache layouts per layer:
  gqa: {"k": (B, Hkv, S_max, hd), "v": (B, Hkv, S_max, hd)}
  mla: {"ckv": (B, S_max, kv_lora), "krope": (B, S_max, rope_dim)}
Attention runs through the port's kernels: ``flash_attention`` for train and
prefill (MLA expanded to 192-wide queries and keys and 128-wide values),
``decode_attention`` for GQA decode and ``mla_decode`` for MLA decode, which
absorbs W_uk into the query and W_uv into the output and attends over the
compressed latent cache.  Decode writes the new row into the cache **in
place** and returns the same cache tensors.

Under a mesh (DTensor params and activations, ``repro_torch.sharding``)
GQA runs the same body: the products as ``layers.linear`` lays them out,
the kernels under ``local_map`` on each rank's batch rows and query heads
(with the KV heads those heads read), and decode either by heads or, with
the cache sharded along its keys ("kv_seq"), over each rank's keys,
merged by log-sum-exp.  MLA has no mesh path yet.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed._functional_collectives as funcol
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch import sharding as sh
from repro_torch.core.config import AttentionConfig, ModelConfig
from repro_torch.kernels.decode_attention.ops import (decode_attention,
                                                      merge_partials)
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.mla_decode.ops import mla_decode
from repro_torch.models import layers as L
from repro_torch.models.layers import Params


class TensorSpec(NamedTuple):
    """Shape and dtype of a tensor to allocate; the twin of
    ``jax.ShapeDtypeStruct``."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


# ---------------------------------------------------------------------------
# GQA
# ---------------------------------------------------------------------------


def init_gqa(gen: torch.Generator, cfg: ModelConfig) -> Params:
    a = cfg.attention
    dt = L.dtype_of(cfg.param_dtype)
    d = cfg.d_model
    return {
        "wq": L.init_linear(gen, d, a.num_heads * a.head_dim, dt, bias=a.qkv_bias),
        "wk": L.init_linear(gen, d, a.num_kv_heads * a.head_dim, dt, bias=a.qkv_bias),
        "wv": L.init_linear(gen, d, a.num_kv_heads * a.head_dim, dt, bias=a.qkv_bias),
        "wo": L.init_linear(gen, a.num_heads * a.head_dim, d, dt),
    }


def gqa_cache_spec(cfg: ModelConfig, batch: int, max_len: int
                   ) -> Dict[str, TensorSpec]:
    a = cfg.attention
    dt = L.dtype_of(cfg.compute_dtype)
    shp = (batch, a.num_kv_heads, max_len, a.head_dim)
    return {"k": TensorSpec(shp, dt), "v": TensorSpec(shp, dt)}


def _write_cache(cache: torch.Tensor, new: torch.Tensor, pos: torch.Tensor,
                 axis: int = 2) -> None:
    """cache[b, ..., pos[b]] = new[b] for every row b, in place, the
    position on ``axis`` (2: GQA's (B, Hkv, S, hd); 1: MLA's (B, S, d)).
    Like the reference's dynamic_update_slice, an index past the end is
    clamped to the last position instead of faulting."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    at = pos.long().clamp(0, cache.shape[axis] - 1)
    index = (rows, slice(None), at) if axis == 2 else (rows, at)
    cache[index] = new.to(cache.dtype)


# ---------------------------------------------------------------------------
# GQA's steps that differ under a mesh (each the plain step on plain tensors)
# ---------------------------------------------------------------------------

# the functional all-gather (renamed in later PyTorch releases)
_all_gather = getattr(funcol, "all_gather_single", None) \
    or funcol.all_gather_tensor


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


def _split_heads(t: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    """(B, S, n hd) -> (B, S, n, hd).  A "model" shard of the last dim
    that does not fall on whole heads (n not a multiple of the axis) is
    gathered first."""
    if isinstance(t, DTensor) and isinstance(sh.on_model(t), Shard) \
            and n % sh.model_size(t.device_mesh):
        t = sh.with_placement(t, "model", Replicate())
    return t.reshape(t.shape[0], t.shape[1], n, hd)


def _local_rows(t: torch.Tensor, full: torch.Tensor) -> torch.Tensor:
    """The rows of ``full`` (a whole (B, ...) tensor) that this rank holds
    of ``t``'s batch dim (all of them without a mesh)."""
    if full.shape[0] == 1 or not isinstance(t, DTensor):
        return full
    local, off = sh.local_extent(t.shape, t.placements, t.device_mesh)
    return full[off[0]:off[0] + local[0]]


def _rope(t: torch.Tensor, positions: torch.Tensor, theta: float
          ) -> torch.Tensor:
    """RoPE of t (B, S, H, hd), under a mesh of each rank's shard at its
    rows' positions (``positions`` (B or 1, S), whole)."""
    if not isinstance(t, DTensor):
        return L.apply_rope(t, positions, theta)
    pos = _local_rows(t, positions)
    return sh.run_local(lambda tl: L.apply_rope(tl, pos, theta),
                        t.placements, t)


def _pad_heads(q: torch.Tensor, n: int) -> torch.Tensor:
    """q (B, H, S, hd) with H padded by zero heads to a multiple of ``n``
    (replicated over "model" first), so that its "model" shards are even:
    40 heads on 16 ranks become 48, 3 a rank, as the reference pads."""
    H = q.shape[1]
    if H < n or H % n == 0:
        return q
    q = sh.with_placement(q, "model", Replicate())
    extra = -(-H // n) * n - H
    return sh.run_local(lambda ql: F.pad(ql, (0, 0, 0, 0, 0, extra)),
                        q.placements, q)


def _kv_for_heads(k: torch.Tensor, v: torch.Tensor, first: int, count: int,
                  group: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The KV heads that query heads [first, first + count) read (head h
    reads h // group; padding heads past the last read the last), regrouped
    so that the local call has count % Hkv == 0: the contiguous run of KV
    heads when every one serves the same number of these heads, else one
    KV head per query head."""
    n_kv = k.shape[1]
    idx = [min((first + j) // group, n_kv - 1) for j in range(count)]
    lo, n = idx[0], idx[-1] - idx[0] + 1
    if count % n == 0 and idx == [lo + j // (count // n) for j in range(count)]:
        return k[:, lo:lo + n], v[:, lo:lo + n]
    sel = torch.tensor(idx, device=k.device)
    return k.index_select(1, sel), v.index_select(1, sel)


def _by_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group: int,
              call) -> torch.Tensor:
    """``call(q, k, v)`` (a kernel: plain tensors), under a mesh on each
    rank's batch rows and query heads (``local_map``).  q's
    heads are sharded on "model" (or replicated); k and v keep a "model"
    shard that matches q's heads one group for one, else are replicated
    over "model" and each rank takes the KV heads its query heads read
    (their gradient then partial over "model")."""
    if not isinstance(q, DTensor):
        return call(q.contiguous(), k.contiguous(), v.contiguous())
    mesh = q.device_mesh
    n = sh.model_size(mesh)
    q_sharded = isinstance(sh.on_model(q), Shard)
    aligned = q_sharded and q.shape[1] % n == 0 and k.shape[1] % n == 0 \
        and isinstance(sh.on_model(k), Shard)
    if not aligned:
        k = sh.with_placement(k, "model", Replicate())
        v = sh.with_placement(v, "model", Replicate())
    select = q_sharded and not aligned
    first = sh.model_rank(mesh) * (q.shape[1] // n) if select else 0

    def local(ql, kl, vl):
        if select:
            kl, vl = _kv_for_heads(kl, vl, first, ql.shape[1], group)
        return call(ql.contiguous(), kl.contiguous(), vl.contiguous())

    grad = None
    if select:
        md = sh.mesh_dim(mesh, "model")
        kv_grad = tuple(Partial() if i == md else p
                        for i, p in enumerate(k.placements))
        grad = (q.placements, kv_grad, kv_grad)
        k, v = sh.grad_as(k, k.placements), sh.grad_as(v, v.placements)
    return sh.run_local(local, q.placements, q, k, v, in_grad_placements=grad)


def _write_cache_sharded(cache: DTensor, new: DTensor, pos_b: torch.Tensor
                         ) -> None:
    """cache[b, :, pos[b]] = new[b] in place, on each rank's shard: the
    rank whose keys hold pos[b] (clamped to the cache, as the one-chip
    write) writes it, the others keep what they hold.  ``new`` (B, Hkv, hd)
    is laid out as the cache's heads are; ``pos_b`` (B,) is whole."""
    mesh = cache.device_mesh
    new = sh.with_placement(
        new, "model", Shard(1) if sh.on_model(cache) == Shard(1)
        else Replicate())
    c, nl = cache.to_local(), new.to_local().to(cache.dtype)
    _, off = sh.local_extent(cache.shape, cache.placements, mesh)
    at = _local_rows(cache, pos_b).long().clamp(0, cache.shape[2] - 1) - off[2]
    keep = (at >= 0) & (at < c.shape[2])
    at = at.clamp(0, max(c.shape[2] - 1, 0))
    rows = torch.arange(c.shape[0], device=c.device)
    c[rows, :, at] = torch.where(keep[:, None, None], nl, c[rows, :, at])


def _decode_over_keys(q: DTensor, k: DTensor, v: DTensor,
                      kv_len: torch.Tensor) -> DTensor:
    """Decode attention over a cache sharded on "model" along its keys: the
    query gathered over "model"; each rank runs K1 for every query head
    over its own keys (kv_len - its first key, clamped to its shard; 0
    gives output 0 and lse -inf) and returns its log-sum-exp; the (out,
    lse) pairs are all-gathered over "model" and merged.  q (B, H, hd);
    k, v (B, Hkv, S, hd); kv_len (B,) whole.  The cache is never
    gathered."""
    mesh = k.device_mesh
    q = sh.with_placement(q, "model", Replicate())
    _, off = sh.local_extent(k.shape, k.placements, mesh)
    lens = _local_rows(k, kv_len)
    group = mesh.get_group("model")

    def local(ql, kl, vl):
        n = (lens - off[2]).clamp(0, kl.shape[2]).to(torch.int32)
        out, lse = decode_attention(ql.contiguous(), kl, vl, n,
                                    return_lse=True)
        outs = _all_gather(out[None], 0, group)
        lses = _all_gather(lse[None], 0, group)
        return merge_partials(outs, lses)

    return sh.run_local(local, q.placements, q, k, v)


def apply_gqa(p: Params, x: torch.Tensor, cfg: ModelConfig, *, mode: str,
              cache: Optional[Params] = None, pos=None,
              causal: bool = True) -> Tuple[torch.Tensor, Optional[Params]]:
    """mode: 'train' | 'prefill' | 'decode'.  x: (B, S, D).

    Decode takes one token per row (S == 1) and ``pos``, a scalar or (B,)
    int tensor: the cache index each row writes and then attends up to.

    One body for one chip and a mesh (x a DTensor; the reference's
    constraint sites: q on ("batch", "heads", "seq", None), the output on
    ("batch", "seq", "embed")).  The helpers above are the identity, or
    the plain call, on plain tensors; under a mesh they are where the
    steps differ: the kernels take plain tensors, so they run under
    ``local_map`` on each rank's batch rows and query heads, RoPE reads
    each rank's rows' positions, the cache write lands on the rank whose
    shard holds ``pos``, and a cache sharded on its keys decodes by
    :func:`_decode_over_keys`.
    """
    if mode != "decode" and sh.seq_parallel():
        raise NotImplementedError(
            "sequence-parallel train/prefill (K2 with q_offset over gathered "
            "keys) is not ported yet (ROADMAP.md item 14b)")
    a = cfg.attention
    cd = L.dtype_of(cfg.compute_dtype)
    B, S, _ = x.shape
    H, Hkv, hd = a.num_heads, a.num_kv_heads, a.head_dim
    sharded = isinstance(x, DTensor)
    n = sh.model_size(x.device_mesh) if sharded else 1
    if sharded:     # one gather over "model" for the three products
        x = sh.with_placement(x.to(cd), "model", Replicate())

    q = _split_heads(L.linear(p["wq"], x, cd), H, hd)
    k = _split_heads(L.linear(p["wk"], x, cd), Hkv, hd)
    v = _split_heads(L.linear(p["wv"], x, cd), Hkv, hd)
    device = _local(q).device
    if mode == "decode":
        if cache is None or S != 1:
            raise ValueError("decode takes a cache and one token per row")
        pos_b = torch.as_tensor(sh.full(pos), device=device)
        pos_b = pos_b.reshape(-1).expand(B)
        positions = pos_b.reshape(B, 1)
    else:
        positions = torch.arange(S, device=device)[None, :]
    q = _rope(q, positions, a.rope_theta).transpose(1, 2)     # (B,H,S,hd)
    k = _rope(k, positions, a.rope_theta).transpose(1, 2)
    v = v.transpose(1, 2)

    new_cache = None
    over_keys = mode == "decode" and isinstance(cache["k"], DTensor) \
        and sh.on_model(cache["k"]) == Shard(2)
    if not over_keys:
        q = sh.constrain(_pad_heads(q, n), ("batch", "heads", "seq", None))
    if mode == "decode":
        write = _write_cache_sharded if sharded else _write_cache
        write(cache["k"], k[:, :, 0], pos_b)
        write(cache["v"], v[:, :, 0], pos_b)
        new_cache = cache
        kv_len = (pos_b + 1).to(torch.int32)
        kc, vc = cache["k"].to(cd), cache["v"].to(cd)
        if over_keys:
            out = _decode_over_keys(q[:, :, 0], kc, vc, kv_len)
        else:
            out = _by_heads(q[:, :, 0], kc, vc, H // Hkv,
                            lambda ql, kl, vl: decode_attention(
                                ql, kl, vl, _local_rows(kc, kv_len)))
        out = out[:, :, None]
    else:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out = _by_heads(q, k, v, H // Hkv,
                        lambda ql, kl, vl: flash_attention(ql, kl, vl,
                                                           causal=causal))
        if mode == "prefill":
            new_cache = {"k": k, "v": v}
    if out.shape[1] != H:      # padding heads
        out = sh.with_placement(out, "model", Replicate())[:, :H]

    out = out.transpose(1, 2).reshape(B, S, H * hd)
    y = L.linear(p["wo"], out, cd)
    return sh.constrain(y, ("batch", "seq", "embed")), new_cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention)
# ---------------------------------------------------------------------------


def init_mla(gen: torch.Generator, cfg: ModelConfig) -> Params:
    a = cfg.attention
    dt = L.dtype_of(cfg.param_dtype)
    d = cfg.d_model
    qk_dim = a.qk_nope_head_dim + a.qk_rope_head_dim
    p: Params = {}
    if a.q_lora_rank:
        p["wq_a"] = L.init_linear(gen, d, a.q_lora_rank, dt)
        p["q_norm"] = L.init_norm(a.q_lora_rank, cfg.norm, dt, gen.device)
        p["wq_b"] = L.init_linear(gen, a.q_lora_rank, a.num_heads * qk_dim, dt)
    else:
        p["wq"] = L.init_linear(gen, d, a.num_heads * qk_dim, dt)
    p["wkv_a"] = L.init_linear(gen, d, a.kv_lora_rank + a.qk_rope_head_dim, dt)
    p["kv_norm"] = L.init_norm(a.kv_lora_rank, cfg.norm, dt, gen.device)
    p["wkv_b"] = L.init_linear(
        gen, a.kv_lora_rank, a.num_heads * (a.qk_nope_head_dim + a.v_head_dim),
        dt)
    p["wo"] = L.init_linear(gen, a.num_heads * a.v_head_dim, d, dt)
    return p


def mla_cache_spec(cfg: ModelConfig, batch: int, max_len: int
                   ) -> Dict[str, TensorSpec]:
    a = cfg.attention
    dt = L.dtype_of(cfg.compute_dtype)
    return {"ckv": TensorSpec((batch, max_len, a.kv_lora_rank), dt),
            "krope": TensorSpec((batch, max_len, a.qk_rope_head_dim), dt)}


def _mla_q(p: Params, x: torch.Tensor, a: AttentionConfig, cd
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q_nope, q_rope), (B, S, H, nope) and (B, S, H, rope), through the
    low-rank query (``wq_a``, ``q_norm``, ``wq_b``) or ``wq``."""
    B, S, _ = x.shape
    if "wq_a" in p:
        ql = L.apply_norm(p["q_norm"], L.linear(p["wq_a"], x, cd))
        q = L.linear(p["wq_b"], ql, cd)
    else:
        q = L.linear(p["wq"], x, cd)
    q = q.reshape(B, S, a.num_heads, a.qk_nope_head_dim + a.qk_rope_head_dim)
    return q[..., :a.qk_nope_head_dim], q[..., a.qk_nope_head_dim:]


def apply_mla(p: Params, x: torch.Tensor, cfg: ModelConfig, *, mode: str,
              cache: Optional[Params] = None, pos=None,
              causal: bool = True) -> Tuple[torch.Tensor, Optional[Params]]:
    """mode: 'train' | 'prefill' | 'decode'.  x: (B, S, D).

    Train and prefill expand the latent into per-head keys and values and
    run ``flash_attention`` at hd nope + rope and hd_v v_head_dim; prefill
    returns the latent cache {"ckv", "krope"} of the S positions.  Decode
    (S == 1, ``pos`` a scalar or (B,) int tensor) writes each row's latent
    at its own position, in place, and runs ``mla_decode`` over the cache
    with W_uk absorbed into the query and W_uv into the output.
    """
    a = cfg.attention
    cd = L.dtype_of(cfg.compute_dtype)
    B, S, _ = x.shape
    H, kv_lora = a.num_heads, a.kv_lora_rank
    nope, rope, vdim = a.qk_nope_head_dim, a.qk_rope_head_dim, a.v_head_dim

    if mode == "decode":
        if cache is None or S != 1:
            raise ValueError("decode takes a cache and one token per row")
        pos_b = torch.as_tensor(pos, device=x.device).reshape(-1).expand(B)
        positions = pos_b.reshape(B, 1)
    else:
        positions = torch.arange(S, device=x.device)[None, :]

    q_nope, q_rope = _mla_q(p, x, a, cd)
    q_rope = L.apply_rope(q_rope, positions, a.rope_theta)
    kv_a = L.linear(p["wkv_a"], x, cd)
    ckv = L.apply_norm(p["kv_norm"], kv_a[..., :kv_lora])
    krope = L.apply_rope(kv_a[..., kv_lora:][:, :, None, :], positions,
                         a.rope_theta)[:, :, 0, :]             # (B, S, rope)
    scale = 1.0 / math.sqrt(nope + rope)

    if mode == "decode":
        _write_cache(cache["ckv"], ckv[:, 0], pos_b, axis=1)
        _write_cache(cache["krope"], krope[:, 0], pos_b, axis=1)
        # W_uk and W_uv: strided views of wkv_b, (H, nope, L) and (H, L, v);
        # the products sum in f32 and round once to the compute dtype
        wkv_b = p["wkv_b"]["w"].to(cd).reshape(kv_lora, H, nope + vdim)
        w_uk = wkv_b[..., :nope].permute(1, 2, 0)
        w_uv = wkv_b[..., nope:].transpose(0, 1)
        q_abs = torch.matmul(q_nope[:, 0].transpose(0, 1), w_uk)   # (H, B, L)
        ctx = mla_decode(q_abs.transpose(0, 1).contiguous(),
                         q_rope[:, 0].contiguous(), cache["ckv"].to(cd),
                         cache["krope"].to(cd), (pos_b + 1).to(torch.int32),
                         scale)
        out = torch.matmul(ctx.transpose(0, 1), w_uv)              # (H, B, v)
        out = out.transpose(0, 1).reshape(B, 1, H * vdim)
        new_cache = cache
    else:
        # k_nope and v of every head from one product with wkv_b
        kv = L.linear(p["wkv_b"], ckv, cd).reshape(B, S, H, nope + vdim)
        k = torch.cat([kv[..., :nope],
                       krope[:, :, None, :].expand(B, S, H, rope)], dim=-1)
        q = torch.cat([q_nope, q_rope], dim=-1)
        q, k, v = (t.transpose(1, 2).contiguous()
                   for t in (q, k, kv[..., nope:]))
        out = flash_attention(q, k, v, causal=causal)          # (B, H, S, v)
        out = out.transpose(1, 2).reshape(B, S, H * vdim)
        new_cache = {"ckv": ckv, "krope": krope} if mode == "prefill" else None

    return L.linear(p["wo"], out, cd), new_cache


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


def init_attention(gen: torch.Generator, cfg: ModelConfig) -> Params:
    if cfg.attention.kind == "mla":
        return init_mla(gen, cfg)
    return init_gqa(gen, cfg)


def apply_attention(p, x, cfg, **kw):
    if cfg.attention.kind == "mla":
        if isinstance(x, DTensor):
            raise NotImplementedError(
                "MLA under a mesh is not ported yet (ROADMAP.md item 14b-2)")
        return apply_mla(p, x, cfg, **kw)
    return apply_gqa(p, x, cfg, **kw)


def attention_cache_spec(cfg: ModelConfig, batch: int, max_len: int):
    if cfg.attention.kind == "mla":
        return mla_cache_spec(cfg, batch, max_len)
    return gqa_cache_spec(cfg, batch, max_len)
