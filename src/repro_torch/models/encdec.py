"""Encoder-decoder transformer (PyTorch twin of ``repro.models.encdec``: the
seamless-m4t backbone, audio family).

The encoder takes precomputed frame embeddings (the speech frontend is a
stub) through bidirectional attention blocks; the decoder is a causal stack
whose blocks add cross-attention over the encoder output, without RoPE.
Encoder and decoder blocks are stacked on a leading layer axis, as the
reference's ``jax.vmap`` stacks them, so its param tree converts key for
key; the reference's ``lax.scan`` over that axis is a Python loop here.

Attention runs through the port's kernels: ``flash_attention`` for the
encoder (non-causal), the decoder's self-attention (causal) and the
cross-attention (non-causal, Sq != Sk) in train and prefill;
``decode_attention`` for the decoder's self- and cross-attention at decode.

Decode state: ``{"self": {"k", "v"}, "cross_k", "cross_v"}``, the self cache
(n_dec, B, Hkv, S, hd), written in place by decode, and the cross cache
(n_dec, B, Hkv, S_enc, hd), which prefill computes once, contiguous.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.config import ModelConfig
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import attention as ATT
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.models.layers import Params


def _cross_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    p = ATT.init_gqa(gen, cfg)
    p["norm"] = L.init_norm(cfg.d_model, cfg.norm,
                            L.dtype_of(cfg.param_dtype), gen.device)
    return p


def _cross_apply(p: Params, x: torch.Tensor,
                 kv: Tuple[torch.Tensor, torch.Tensor], cfg: ModelConfig,
                 kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x + cross-attention of x (B, S, D) over kv = (k, v), each (B, Hkv,
    S_enc, hd) and contiguous, from :func:`cross_kv`.  Without ``kv_len``
    through ``flash_attention``; with it (decode: S == 1, ``kv_len`` (B,)
    int32 the cross cache's length in every row) through
    ``decode_attention``."""
    a = cfg.attention
    cd = L.dtype_of(cfg.compute_dtype)
    B_, S, _ = x.shape
    h = L.apply_norm(p["norm"], x, cfg.norm_eps)
    q = L.linear(p["wq"], h, cd).reshape(B_, S, a.num_heads, a.head_dim)
    k, v = kv
    if kv_len is None:
        out = flash_attention(q.transpose(1, 2).contiguous(), k, v,
                              causal=False).transpose(1, 2)
    else:
        out = decode_attention(q.reshape(B_, a.num_heads, a.head_dim), k, v,
                               kv_len)
    out = out.reshape(B_, S, a.num_heads * a.head_dim)
    return x + L.linear(p["wo"], out, cd).to(x.dtype)


def cross_kv(p: Params, enc_out: torch.Tensor, cfg: ModelConfig
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-attention K and V of the encoder output, (B, Hkv, S_enc, hd)
    each, made contiguous here once (the kernels take no strided input)."""
    a = cfg.attention
    cd = L.dtype_of(cfg.compute_dtype)
    B_, S, _ = enc_out.shape
    k = L.linear(p["wk"], enc_out, cd).reshape(B_, S, a.num_kv_heads,
                                                a.head_dim)
    v = L.linear(p["wv"], enc_out, cd).reshape(B_, S, a.num_kv_heads,
                                                a.head_dim)
    return k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()


def init_params(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Random params on ``gen.device``, drawn from ``gen``; each stack drawn
    one block at a time into tensors allocated once."""
    dt = L.dtype_of(cfg.param_dtype)
    n_enc = cfg.encoder_layers or cfg.num_layers

    def dec_block():
        p = B.init_block(gen, cfg, "attn", "dense")
        p["cross"] = _cross_init(gen, cfg)
        return p

    return {
        "embed": L.init_embedding(gen, cfg.vocab_size, cfg.d_model, dt),
        "enc_in_norm": L.init_norm(cfg.d_model, cfg.norm, dt, gen.device),
        "encoder": B.init_stacked(
            n_enc, lambda: B.init_block(gen, cfg, "attn", "dense")),
        "enc_norm": L.init_norm(cfg.d_model, cfg.norm, dt, gen.device),
        "decoder": B.init_stacked(cfg.num_layers, dec_block),
        "final_norm": L.init_norm(cfg.d_model, cfg.norm, dt, gen.device),
        "lm_head": L.init_linear(gen, cfg.d_model, cfg.vocab_size, dt),
    }


def encode(p: Params, cfg: ModelConfig, frames: torch.Tensor,
           remat: str = "dots") -> torch.Tensor:
    """The encoder over frame embeddings (B, S_enc, D): bidirectional
    blocks, each under ``remat``."""
    cd = L.dtype_of(cfg.compute_dtype)
    x = L.apply_norm(p["enc_in_norm"], frames.to(cd), cfg.norm_eps)

    def body(x, blk):
        return B.apply_block(blk, x, cfg, "attn", "dense", mode="train",
                             causal=False)[0]

    body = B._remat_wrap(body, remat)
    for blk in B.unstack(p["encoder"]):
        x = body(x, blk)
    return L.apply_norm(p["enc_norm"], x, cfg.norm_eps)


def _decode_stack(p: Params, cfg: ModelConfig, x: torch.Tensor,
                  enc_out: torch.Tensor, remat: str = "dots") -> torch.Tensor:
    """The decoder over the whole sequence (train mode), each block with
    its cross-attention under ``remat``."""

    def body(x, blk, enc_out):
        x = B.apply_block(blk, x, cfg, "attn", "dense", mode="train",
                          causal=True)[0]
        return _cross_apply(blk["cross"], x,
                            cross_kv(blk["cross"], enc_out, cfg), cfg)

    body = B._remat_wrap(body, remat)
    for blk in B.unstack(p["decoder"]):
        x = body(x, blk, enc_out)
    return x


def forward(p: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor], *,
            mode: str = "train", remat: str = "dots",
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """batch: {"frames" (B, S_enc, D), "tokens" (B, S)}.  Returns (logits
    (B, S, V) f32, aux 0)."""
    cd = L.dtype_of(cfg.compute_dtype)
    enc_out = encode(p, cfg, batch["frames"], remat)
    x = L.embed(p["embed"], batch["tokens"], cd)
    x = _decode_stack(p, cfg, x, enc_out, remat)
    x = L.apply_norm(p["final_norm"], x, cfg.norm_eps)
    return (L.dot_f32(x, p["lm_head"]["w"], cd),
            torch.zeros((), dtype=torch.float32, device=x.device))


def loss_fn(p: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor], *,
            remat: str = "dots") -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross-entropy over the decoder tokens, a full log-softmax
    over the vocabulary as in the reference."""
    logits, aux = forward(p, cfg, batch, remat=remat)
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    targets = batch["tokens"][:, 1:, None].long()
    loss = -torch.gather(logp, -1, targets)[..., 0].mean()
    return loss, {"loss": loss, "aux": aux, "total": loss}


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def _self_spec(cfg: ModelConfig, batch: int, max_len: int) -> Params:
    return L.tree_map(
        lambda s: ATT.TensorSpec((cfg.num_layers,) + s.shape, s.dtype),
        ATT.gqa_cache_spec(cfg, batch, max_len))


def _zeros(spec: Params, device) -> Params:
    return L.tree_map(
        lambda s: torch.zeros(s.shape, dtype=s.dtype, device=device), spec)


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int) -> Params:
    """TensorSpec tree of the decode state; the cross cache is sized at
    ``max_len`` too, as in the reference."""
    a = cfg.attention
    cd = L.dtype_of(cfg.compute_dtype)
    kv = ATT.TensorSpec((cfg.num_layers, batch, a.num_kv_heads, max_len,
                         a.head_dim), cd)
    return {"self": _self_spec(cfg, batch, max_len), "cross_k": kv,
            "cross_v": kv}


def allocate_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                          device) -> Params:
    return _zeros(init_decode_state(cfg, batch, max_len), device)


def grow_decode_state(cfg: ModelConfig, state: Params, max_len: int
                      ) -> Params:
    """A prefill state with its self cache moved into the leading positions
    of one of ``max_len``; the cross cache stays at the frames' length."""
    ck = state["cross_k"]                            # (n_dec, B, ...)
    grown = _zeros(_self_spec(cfg, ck.shape[1], max_len), ck.device)
    L.tree_map(L.copy_into_leading, grown, state["self"])
    return {"self": grown, "cross_k": state["cross_k"],
            "cross_v": state["cross_v"]}


def prefill(p: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Params]:
    """Encode the frames and run the decoder over the prompt.  Returns (the
    last position's logits (B, V) f32, state): the self cache of the
    prompt's S positions and the cross cache of the frames'."""
    cd = L.dtype_of(cfg.compute_dtype)
    enc_out = encode(p, cfg, batch["frames"], remat="none")
    x = L.embed(p["embed"], batch["tokens"], cd)
    selfs, cross_k, cross_v = [], [], []
    for blk in B.unstack(p["decoder"]):
        x, c, _ = B.apply_block(blk, x, cfg, "attn", "dense", mode="prefill",
                                causal=True)
        k, v = cross_kv(blk["cross"], enc_out, cfg)
        x = _cross_apply(blk["cross"], x, (k, v), cfg)
        selfs.append(c["attn"])
        cross_k.append(k)
        cross_v.append(v)
    x = L.apply_norm(p["final_norm"], x, cfg.norm_eps)
    state = {"self": L.tree_map(lambda *xs: torch.stack(xs), *selfs),
             "cross_k": torch.stack(cross_k), "cross_v": torch.stack(cross_v)}
    return L.dot_f32(x[:, -1], p["lm_head"]["w"], cd), state


def decode_step(p: Params, cfg: ModelConfig, state: Params,
                tokens: torch.Tensor, pos: torch.Tensor
                ) -> Tuple[torch.Tensor, Params]:
    """One decoder step.  tokens: (B,) int; pos: scalar or per-row (B,) int,
    the self cache's write index.  The cross-attention reads every position
    of the cross cache.  Writes the self cache in place and returns (logits
    (B, V) f32, the same state)."""
    cd = L.dtype_of(cfg.compute_dtype)
    x = L.embed(p["embed"], tokens[:, None], cd)
    kv_len = torch.full((x.shape[0],), state["cross_k"].shape[3],
                        dtype=torch.int32, device=x.device)
    for blk, self_c, k, v in zip(B.unstack(p["decoder"]),
                                 B.unstack(state["self"]),
                                 state["cross_k"].unbind(0),
                                 state["cross_v"].unbind(0)):
        x = B.apply_block(blk, x, cfg, "attn", "dense", mode="decode",
                          cache={"attn": self_c}, pos=pos)[0]
        x = _cross_apply(blk["cross"], x, (k, v), cfg, kv_len)
    x = L.apply_norm(p["final_norm"], x, cfg.norm_eps)
    return L.dot_f32(x[:, 0], p["lm_head"]["w"], cd), state
