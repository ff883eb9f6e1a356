"""Decoder-only language model (PyTorch twin of ``repro.models.lm``).

Public surface (used by repro_torch.models.api):
  init_params, forward, hidden_states, chunked_xent, loss_fn,
  init_decode_state, allocate_decode_state, grow_decode_state, prefill,
  decode_step
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch import sharding as sh
from repro_torch.core.config import ModelConfig
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.models.layers import Params


def init_params(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Random params on ``gen.device``, drawn from ``gen``."""
    dt = L.dtype_of(cfg.param_dtype)
    p: Params = {
        "embed": L.init_embedding(gen, cfg.vocab_size, cfg.d_model, dt),
        "stack": B.init_stack(gen, cfg),
        "final_norm": L.init_norm(cfg.d_model, cfg.norm, dt, gen.device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = L.init_linear(gen, cfg.d_model, cfg.vocab_size, dt)
    return p


def _head(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    cd = L.dtype_of(cfg.compute_dtype)
    if cfg.tie_embeddings:
        return sh.constrain(
            L.logits_from_embedding(p["embed"], x, cfg.logit_softcap, cd),
            ("batch", "seq", "vocab"))
    logits = L.dot_f32(x, p["lm_head"]["w"], cd)
    if cfg.logit_softcap:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return sh.constrain(logits, ("batch", "seq", "vocab"))


def _embed_inputs(p: Params, cfg: ModelConfig,
                  batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The token embeddings, behind the batch's ``prefix_embeds`` (B, P, D)
    (the modality frontend's stub: precomputed patch embeddings, cast to the
    compute dtype) when the config has a frontend and the batch carries
    them; a text-only batch stays text-only."""
    cd = L.dtype_of(cfg.compute_dtype)
    x = L.embed(p["embed"], batch["tokens"], cd)
    if cfg.frontend is not None and cfg.frontend.kind != "none" \
            and "prefix_embeds" in batch:
        x = torch.cat([batch["prefix_embeds"].to(cd), x], dim=1)
    return sh.constrain(x, ("batch", "seq", "embed"))


def forward(p: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor], *,
            mode: str = "train", remat: str = "dots",
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence causal forward. Returns (logits (B, S, V) f32, aux)."""
    x, aux = hidden_states(p, cfg, batch, remat=remat)
    return _head(p, x, cfg), aux


def hidden_states(p: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
                  *, remat: str = "dots") -> Tuple[torch.Tensor, torch.Tensor]:
    """Final-norm hidden states (pre-head). Returns (h, aux f32 scalar)."""
    x = _embed_inputs(p, cfg, batch)
    x, _, aux = B.apply_stack(p["stack"], x, cfg, mode="train", remat=remat)
    if not isinstance(aux, torch.Tensor):      # a stack without MoE
        aux = torch.as_tensor(aux, dtype=torch.float32, device=x.device)
    return L.apply_norm(p["final_norm"], x, cfg.norm_eps), aux


def _chunk_nll(p: Params, cfg: ModelConfig, h: torch.Tensor,
               targets: torch.Tensor, mask: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    logits = _head(p, h, cfg).float()
    if isinstance(logits, DTensor):
        nll = _nll_sharded(logits, targets)
        return torch.sum(nll * mask), torch.sum(mask)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None].long())[..., 0]
    return torch.sum(nll * mask), torch.sum(mask)


def _nll_sharded(logits: DTensor, targets: DTensor) -> DTensor:
    """-log softmax(logits)[target] under a mesh, the logits (B, c, V) laid
    out with their vocab on "model": the max and the sum of exponentials
    are reduced over "model" (DTensor's pending max and sum) and each rank
    picks the targets within its own vocab rows, their sum reduced too; the
    logits are never gathered.  (B, c) f32, replicated over "model"."""
    m = logits.detach().amax(dim=-1, keepdim=True)
    m = sh.with_placement(m, "model", Replicate())
    lse = torch.log(sh.with_placement(
        torch.exp(logits - m).sum(dim=-1, keepdim=True), "model",
        Replicate())) + m
    vocab_sharded = sh.on_model(logits) == Shard(2)
    rows = logits.to_local().shape[-1]
    first = sh.model_rank(logits.device_mesh) * rows if vocab_sharded else 0

    def pick(lg, tg):
        idx = tg.long() - first
        hit = (idx >= 0) & (idx < rows)
        got = torch.gather(lg, -1, idx.clamp(0, rows - 1)[..., None])[..., 0]
        return got * hit

    md = sh.mesh_dim(logits.device_mesh, "model")
    place = list(targets.placements)
    if md is not None:
        place[md] = Partial() if vocab_sharded else Replicate()
    picked = sh.with_placement(sh.run_local(pick, place, logits, targets),
                               "model", Replicate())
    return lse[..., 0] - picked


def chunked_xent(p: Params, cfg: ModelConfig, h: torch.Tensor,
                 targets: torch.Tensor, mask: Optional[torch.Tensor] = None,
                 chunk: int = 512) -> torch.Tensor:
    """Mean cross-entropy without materialising the (B, S, V) logits: the
    head projection and log-softmax run per chunk of ``chunk`` positions
    under activation checkpointing, so the backward recomputes one chunk's
    logits at a time.  A ragged last chunk is taken as it is (the reference
    pads it and masks the padding out).  Under a mesh the chunks' sums
    stay pending over the batch shards and are reduced once, at the
    division."""
    Bz, S, _ = h.shape
    chunk = min(chunk, S)
    sharded = isinstance(h, DTensor)
    if mask is not None:
        mf = mask.float()
    elif sharded:                   # in the targets' layout
        mf = torch.ones_like(targets, dtype=torch.float32)
    else:
        mf = torch.ones((Bz, S), dtype=torch.float32, device=h.device)
    tot = cnt = None                # under a mesh: the first chunk's sums
    if not sharded:
        tot = torch.zeros((), dtype=torch.float32, device=h.device)
        cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for s0 in range(0, S, chunk):
        part = slice(s0, s0 + chunk)
        t, c = checkpoint(_chunk_nll, p, cfg, h[:, part], targets[:, part],
                          mf[:, part], use_reentrant=False)
        tot, cnt = (t, c) if tot is None else (tot + t, cnt + c)
    if sharded:
        whole = (Replicate(),) * h.device_mesh.ndim
        tot = tot.redistribute(h.device_mesh, whole)
        cnt = cnt.redistribute(h.device_mesh, whole)
    return tot / torch.clamp(cnt, min=1.0)


def loss_fn(p: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor], *,
            remat: str = "dots") -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross-entropy over the text positions (+ MoE aux); the
    chunked head and cross-entropy keep the (B, S, V) logits out of memory.
    Returns (total, {"loss", "aux", "total"})."""
    h, aux = hidden_states(p, cfg, batch, remat=remat)
    h = h[:, h.shape[1] - batch["tokens"].shape[1]:]    # drop the prefix
    targets = batch["tokens"][:, 1:]
    mask = batch.get("loss_mask")
    loss = chunked_xent(p, cfg, h[:, :-1], targets,
                        None if mask is None else mask[:, 1:])
    aux_coef = cfg.moe.aux_loss_coef if cfg.moe else 0.0
    if isinstance(loss, DTensor) and not isinstance(aux, DTensor):
        # a dense model under a mesh: no aux
        return loss, {"loss": loss, "aux": aux, "total": loss}
    total = loss + aux_coef * aux
    return total, {"loss": loss, "aux": aux, "total": total}


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int) -> Params:
    """TensorSpec tree for the decode cache (allocate with zeros)."""
    return B.stack_cache_spec(cfg, batch, max_len)


def allocate_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                          device) -> Params:
    spec = init_decode_state(cfg, batch, max_len)
    return L.tree_map(
        lambda s: torch.zeros(s.shape, dtype=s.dtype, device=device), spec)


def grow_decode_state(cfg: ModelConfig, cache: Params, max_len: int
                      ) -> Params:
    """A decode state of ``max_len`` positions holding the prefill ``cache``
    in its leading positions; a recurrent leaf is copied whole.  The
    reference has no such step: its prefill cache is decoded in place, and
    a write past its end is clamped to the last position."""
    leaf = next(L.leaves(cache["periods"]))          # (periods, B, ...)
    state = allocate_decode_state(cfg, leaf.shape[1], max_len, leaf.device)
    L.tree_map(L.copy_into_leading, state, cache)
    return state


def prefill(p: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            ) -> Tuple[torch.Tensor, Params]:
    """Process the full prompt (a modality prefix included); returns
    (last-position logits (B, 1, V), cache): attention caches hold exactly
    the prompt's S positions, Mamba and RWKV caches the recurrent state
    after the prompt's last token (:func:`grow_decode_state` moves the
    cache into one of more positions)."""
    x = _embed_inputs(p, cfg, batch)
    x, cache, _ = B.apply_stack(p["stack"], x, cfg, mode="prefill")
    x = L.apply_norm(p["final_norm"], x, cfg.norm_eps)
    return _head(p, x[:, -1:], cfg), cache


def decode_step(p: Params, cfg: ModelConfig, state: Params,
                tokens: torch.Tensor, pos: torch.Tensor,
                ) -> Tuple[torch.Tensor, Params]:
    """One decode step.  tokens: (B,) int; pos: scalar or per-slot (B,) int
    (attention's cache write index; row b attends to [0, pos[b]]; Mamba and
    RWKV layers carry their position in their state and do not read it).  Writes
    the cache in place and returns (logits (B, V) f32, the same state)."""
    cd = L.dtype_of(cfg.compute_dtype)
    x = L.embed(p["embed"], tokens[:, None], cd)
    x = sh.constrain(x, ("batch", None, "embed"))
    x, state, _ = B.apply_stack(p["stack"], x, cfg, mode="decode",
                                cache=state, pos=pos)
    x = L.apply_norm(p["final_norm"], x, cfg.norm_eps)
    return _head(p, x, cfg)[:, 0], state
