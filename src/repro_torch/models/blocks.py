"""Residual blocks and the stacked-period layer stack (PyTorch twin of
``repro.models.blocks``).

A model is ``prefix blocks + N repetitions of a period``, a period being the
minimal repeating list of (mixer_kind, ffn_kind) layer descriptors and the
prefix the dense blocks in front of an MoE stack (deepseek-v2's first
layer).  Period parameters are stacked on a leading axis, as in the JAX
package, so its param tree converts key for key; the reference's
``lax.scan`` over that axis is a Python loop here, and the prefix blocks
run unrolled before it.  The port runs attention (GQA or MLA) and Mamba
mixers with dense or MoE FFNs (granite-moe, jamba, deepseek-v2) and RWKV-6
("rwkv", "rwkv_cm") blocks.
"""
from __future__ import annotations

import functools
from typing import List, Optional, Tuple, Union

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.core.config import ModelConfig
from repro_torch.models import attention as ATT
from repro_torch.models import layers as L
from repro_torch.models import rwkv6 as R6
from repro_torch.models import ssm as SSM
from repro_torch.models.layers import Params

# the (mixer, ffn) blocks the port runs
PORTED_BLOCKS = (("attn", "dense"), ("attn", "moe"), ("ssm", "dense"),
                 ("ssm", "moe"), ("rwkv", "rwkv_cm"))


# ---------------------------------------------------------------------------
# Pattern
# ---------------------------------------------------------------------------


def layer_descriptors(cfg: ModelConfig) -> List[Tuple[str, str]]:
    mixers = cfg.layer_kinds()
    ffns = cfg.ffn_kinds()
    return [(m, "rwkv_cm" if m == "rwkv" else f) for m, f in zip(mixers, ffns)]


def block_pattern(cfg: ModelConfig) -> Tuple[List, List, int]:
    """Returns (prefix_descriptors, period_descriptors, n_periods)."""
    desc = layer_descriptors(cfg)
    n_prefix = cfg.moe.first_k_dense if cfg.moe else 0
    prefix, rest = desc[:n_prefix], desc[n_prefix:]
    n = len(rest)
    for p in range(1, n + 1):
        if n % p == 0 and rest == rest[:p] * (n // p):
            return prefix, rest[:p], n // p
    return prefix, rest, 1


def _ported_pattern(cfg: ModelConfig) -> Tuple[List, List, int]:
    prefix, period, n_periods = block_pattern(cfg)
    if any(d not in PORTED_BLOCKS for d in prefix + period):
        raise NotImplementedError(
            f"{cfg.name}: blocks {prefix + period} are not ported yet; the "
            f"port runs stacks of {PORTED_BLOCKS} (ROADMAP.md, Queue 1)")
    return prefix, period, n_periods


# ---------------------------------------------------------------------------
# One block
# ---------------------------------------------------------------------------


def init_block(gen: torch.Generator, cfg: ModelConfig, mixer: str, ffn: str
               ) -> Params:
    """One block of ``PORTED_BLOCKS``."""
    dt = L.dtype_of(cfg.param_dtype)
    p: Params = {"norm1": L.init_norm(cfg.d_model, cfg.norm, dt, gen.device)}
    if mixer == "attn":
        p["attn"] = ATT.init_attention(gen, cfg)
    elif mixer == "ssm":
        p["ssm"] = SSM.init_ssm(gen, cfg)
    else:
        p["rwkv_tm"] = R6.init_time_mix(gen, cfg)
    p["norm2"] = L.init_norm(cfg.d_model, cfg.norm, dt, gen.device)
    if ffn == "dense":
        d_ff = (cfg.moe.d_ff_dense if (cfg.moe and cfg.moe.d_ff_dense)
                else cfg.d_ff)
        p["ffn"] = L.init_ffn(gen, cfg.d_model, d_ff, cfg.act, dt)
    elif ffn == "moe":
        p["ffn_moe"] = L.init_moe(gen, cfg, dt)
    else:
        p["rwkv_cm"] = R6.init_channel_mix(gen, cfg)
    return p


def block_cache_spec(cfg: ModelConfig, mixer: str, ffn: str,
                     batch: int, max_len: int) -> Params:
    if mixer == "attn":
        return {"attn": ATT.attention_cache_spec(cfg, batch, max_len)}
    if mixer == "ssm":
        return {"ssm": SSM.ssm_cache_spec(cfg, batch)}
    # shift_t (time mix), shift_c (channel mix) and the wkv state
    return {"rwkv_tm": R6.rwkv_cache_spec(cfg, batch)}


def apply_block(p: Params, x: torch.Tensor, cfg: ModelConfig,
                mixer: str, ffn: str, *, mode: str,
                cache: Optional[Params] = None, pos=None,
                causal: bool = True,
                ) -> Tuple[torch.Tensor, Optional[Params], Union[torch.Tensor, float]]:
    """Returns (x, new_cache, aux_loss); the aux loss of a block without MoE
    is the number 0.0, which launches nothing on the device."""
    cd = L.dtype_of(cfg.compute_dtype)
    aux = 0.0
    new_cache: Params = {}
    h = L.apply_norm(p["norm1"], x, cfg.norm_eps)
    if mixer == "attn":
        y, c = ATT.apply_attention(p["attn"], h, cfg, mode=mode,
                                   cache=None if cache is None else cache["attn"],
                                   pos=pos, causal=causal)
        if c is not None:
            new_cache["attn"] = c
    elif mixer == "ssm":
        y, c = SSM.apply_ssm(p["ssm"], h, cfg, mode=mode,
                             cache=None if cache is None else cache["ssm"],
                             pos=pos)
        if c is not None:
            new_cache["ssm"] = c
    else:  # rwkv time mix
        y, c = R6.apply_time_mix(p["rwkv_tm"], h, cfg, mode=mode,
                                 cache=None if cache is None else cache["rwkv_tm"])
        if c is not None:
            new_cache["rwkv_tm"] = c
    x = x + y.to(x.dtype)
    h = L.apply_norm(p["norm2"], x, cfg.norm_eps)
    if ffn == "dense":
        y = L.apply_ffn(p["ffn"], h, cfg.act, cd)
    elif ffn == "moe":
        y, aux = L.apply_moe(p["ffn_moe"], h, cfg, compute_dtype=cd,
                             aux_loss=mode == "train")
    else:  # rwkv channel mix: its state joins the time mix's
        y, c = R6.apply_channel_mix(p["rwkv_cm"], h, cfg, mode=mode,
                                    cache=None if cache is None else cache["rwkv_tm"])
        if c is not None:
            new_cache.setdefault("rwkv_tm", {}).update(c)
    x = x + y.to(x.dtype)
    return x, (new_cache or None), aux


# ---------------------------------------------------------------------------
# Stack (stacked periods)
# ---------------------------------------------------------------------------


def init_stack(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """The prefix blocks, then the periods stacked on the period axis
    (:func:`init_stacked`)."""
    prefix, period, n_periods = _ported_pattern(cfg)
    params: Params = {}
    if prefix:
        params["prefix"] = {f"blk{i}": init_block(gen, cfg, m, f)
                            for i, (m, f) in enumerate(prefix)}
    params["periods"] = init_stacked(n_periods, lambda: {
        f"sub{j}": init_block(gen, cfg, m, f)
        for j, (m, f) in enumerate(period)})
    return params


def init_stacked(n: int, draw) -> Params:
    """``n`` trees from ``draw()`` stacked on a leading axis (the twin of
    the reference's ``jax.vmap`` over keys): tensors allocated at the first
    draw and filled one draw at a time, so init never holds a second copy
    of the weights; a single draw is a view."""
    draws = (draw() for _ in range(n))
    if n == 1:
        return L.tree_map(lambda t: t[None], next(draws))
    stacked = None
    for i, one in enumerate(draws):
        if stacked is None:
            stacked = L.tree_map(lambda t: t.new_empty((n,) + t.shape), one)
        L.tree_map(lambda dst, src: dst[i].copy_(src), stacked, one)
    return stacked


def stack_cache_spec(cfg: ModelConfig, batch: int, max_len: int) -> Params:
    prefix, period, n_periods = _ported_pattern(cfg)
    spec: Params = {}
    if prefix:
        spec["prefix"] = {f"blk{i}": block_cache_spec(cfg, m, f, batch, max_len)
                          for i, (m, f) in enumerate(prefix)}
    per = {f"sub{j}": block_cache_spec(cfg, m, f, batch, max_len)
           for j, (m, f) in enumerate(period)}
    spec["periods"] = L.tree_map(
        lambda s: ATT.TensorSpec((n_periods,) + s.shape, s.dtype), per)
    return spec


# the products whose outputs "dots" keeps (the reference's
# dots_with_no_batch_dims_saveable keeps the dot_generals without batch
# dimensions: the projections, which torch runs as these)
_SAVED_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                   torch.ops.aten.bmm.default)


def _save_products(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _SAVED_PRODUCTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_wrap(fn, remat: str):
    """``fn`` under activation checkpointing (the twin of the reference's
    ``_remat_wrap``): "none" stores every activation; "full" stores only
    ``fn``'s inputs and recomputes the rest in the backward; "dots" also
    keeps the outputs of the matrix products (selective checkpointing)."""
    if remat == "none":
        return fn
    if remat == "full":
        return functools.partial(ckpt.checkpoint, fn, use_reentrant=False)
    if remat == "dots":
        return functools.partial(
            ckpt.checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(
                ckpt.create_selective_checkpoint_contexts, _save_products))
    raise ValueError(f"remat must be 'none', 'dots' or 'full'; got {remat!r}")


def unstack(stacked: Params) -> List[Params]:
    """The trees along the leading (layer or period) axis of a stacked
    tree, as views.  Each leaf is unbound once: the backward of unbind
    stacks the layers' gradients in one op, where indexing each layer
    (t[i]) would give every layer a zero-filled gradient of the whole stack
    and add them up (quadratic in depth).  A tree without leaves (the empty
    period of a stack cut to its prefix blocks, such as deepseek's
    ``TRAIN_CARD``) holds no trees."""
    unbound = L.tree_map(lambda t: t.unbind(0), stacked)
    n = len(next(L.leaves(unbound), ()))
    return [L.tree_map(lambda views: views[i], unbound) for i in range(n)]


def apply_stack(params: Params, x: torch.Tensor, cfg: ModelConfig, *,
                mode: str, cache: Optional[Params] = None, pos=None,
                causal: bool = True, remat: str = "none",
                ) -> Tuple[torch.Tensor, Optional[Params], Union[torch.Tensor, float]]:
    """Run the prefix blocks, then the periods in order.  Returns (x,
    new_cache, total_aux): the cache is, in decode, the cache tensors
    themselves, updated in place; in prefill a new cache, the prefix
    blocks' under "prefix" and the periods' stacked on the period axis
    under "periods"; in train None.  The aux loss is 0.0 for a stack without
    MoE.  ``remat`` checkpoints each period in train mode (see
    :func:`_remat_wrap`; the prefix blocks run without, as in the
    reference); other modes ignore it."""
    prefix, period, _ = _ported_pattern(cfg)
    total_aux = 0.0
    per_period = []
    prefix_cache: Params = {}
    for i, (m, f) in enumerate(prefix):
        x, c, aux = apply_block(
            params["prefix"][f"blk{i}"], x, cfg, m, f, mode=mode,
            cache=None if cache is None else cache["prefix"][f"blk{i}"],
            pos=pos, causal=causal)
        total_aux = total_aux + aux
        if c is not None:
            prefix_cache[f"blk{i}"] = c

    def period_fn(x, p_params, p_cache):
        caches_out, aux_sum = {}, 0.0
        for j, (m, f) in enumerate(period):
            x, c, aux = apply_block(
                p_params[f"sub{j}"], x, cfg, m, f, mode=mode,
                cache=None if p_cache is None else p_cache[f"sub{j}"],
                pos=pos, causal=causal)
            aux_sum = aux_sum + aux
            if c is not None:
                caches_out[f"sub{j}"] = c
        return x, caches_out, aux_sum

    body = _remat_wrap(period_fn, remat if mode == "train" else "none")
    for i, p_params in enumerate(unstack(params["periods"])):
        p_cache = None if cache is None else \
            L.tree_map(lambda t: t[i], cache["periods"])
        x, caches_out, aux = body(x, p_params, p_cache)
        total_aux = total_aux + aux
        per_period.append(caches_out)
    if mode == "decode":
        return x, cache, total_aux
    if mode == "prefill":
        new_cache = {"prefix": prefix_cache} if prefix_cache else {}
        new_cache["periods"] = L.tree_map(lambda *xs: torch.stack(xs),
                                          *per_period) if per_period else {}
        return x, new_cache, total_aux
    return x, None, total_aux
