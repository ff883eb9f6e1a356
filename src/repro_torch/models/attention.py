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
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.config import AttentionConfig, ModelConfig
from repro_torch.kernels.decode_attention.ops import decode_attention
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


def apply_gqa(p: Params, x: torch.Tensor, cfg: ModelConfig, *, mode: str,
              cache: Optional[Params] = None, pos=None,
              causal: bool = True) -> Tuple[torch.Tensor, Optional[Params]]:
    """mode: 'train' | 'prefill' | 'decode'.  x: (B, S, D).

    Decode takes one token per row (S == 1) and ``pos``, a scalar or (B,)
    int tensor: the cache index each row writes and then attends up to.
    """
    a = cfg.attention
    cd = L.dtype_of(cfg.compute_dtype)
    B, S, _ = x.shape
    H, Hkv, hd = a.num_heads, a.num_kv_heads, a.head_dim

    q = L.linear(p["wq"], x, cd).reshape(B, S, H, hd)
    k = L.linear(p["wk"], x, cd).reshape(B, S, Hkv, hd)
    v = L.linear(p["wv"], x, cd).reshape(B, S, Hkv, hd)

    if mode == "decode":
        if cache is None or S != 1:
            raise ValueError("decode takes a cache and one token per row")
        pos_b = torch.as_tensor(pos, device=x.device).reshape(-1).expand(B)
        positions = pos_b.reshape(B, 1)
    else:
        positions = torch.arange(S, device=x.device)[None, :]
    q = L.apply_rope(q, positions, a.rope_theta)
    k = L.apply_rope(k, positions, a.rope_theta)
    q = q.transpose(1, 2)     # (B,H,S,hd)
    k = k.transpose(1, 2)
    v = v.transpose(1, 2)

    new_cache = None
    if mode == "decode":
        _write_cache(cache["k"], k[:, :, 0], pos_b)
        _write_cache(cache["v"], v[:, :, 0], pos_b)
        new_cache = cache
        kv_len = (pos_b + 1).to(torch.int32)
        out = decode_attention(q[:, :, 0].contiguous(), cache["k"].to(cd),
                               cache["v"].to(cd), kv_len)[:, :, None]
    else:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out = flash_attention(q, k, v, causal=causal)
        if mode == "prefill":
            new_cache = {"k": k, "v": v}

    out = out.transpose(1, 2).reshape(B, S, H * hd)
    return L.linear(p["wo"], out, cd), new_cache


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
        return apply_mla(p, x, cfg, **kw)
    return apply_gqa(p, x, cfg, **kw)


def attention_cache_spec(cfg: ModelConfig, batch: int, max_len: int):
    if cfg.attention.kind == "mla":
        return mla_cache_spec(cfg, batch, max_len)
    return gqa_cache_spec(cfg, batch, max_len)
