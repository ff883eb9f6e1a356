"""Attention mixers (PyTorch twin of ``repro.models.attention``): GQA with
RoPE and optional QKV bias.

Cache layout per layer: {"k": (B, Hkv, S_max, hd), "v": (B, Hkv, S_max, hd)}.
Attention runs through the port's kernels: ``flash_attention`` for train and
prefill, ``decode_attention`` for decode.  Decode writes the new K/V row into
the cache **in place** and returns the same cache tensors.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.config import ModelConfig
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import layers as L
from repro_torch.models.layers import Params

MLA_TODO = "MLA is not ported yet (ROADMAP.md, Queue 1 item 9)"


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


def _write_cache(cache: torch.Tensor, new: torch.Tensor, pos: torch.Tensor
                 ) -> None:
    """cache[b, :, pos[b]] = new[b] for every row b, in place.  Like the
    reference's dynamic_update_slice, an index past the end is clamped to
    the last position instead of faulting."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache[rows, :, pos.long().clamp(0, cache.shape[2] - 1)] = new.to(cache.dtype)


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
# dispatch
# ---------------------------------------------------------------------------


def apply_mla(*args, **kwargs):
    raise NotImplementedError(MLA_TODO)


def init_attention(gen: torch.Generator, cfg: ModelConfig) -> Params:
    if cfg.attention.kind == "mla":
        raise NotImplementedError(MLA_TODO)
    return init_gqa(gen, cfg)


def apply_attention(p, x, cfg, **kw):
    if cfg.attention.kind == "mla":
        return apply_mla(p, x, cfg, **kw)
    return apply_gqa(p, x, cfg, **kw)


def attention_cache_spec(cfg: ModelConfig, batch: int, max_len: int):
    if cfg.attention.kind == "mla":
        raise NotImplementedError(MLA_TODO)
    return gqa_cache_spec(cfg, batch, max_len)
