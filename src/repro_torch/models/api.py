"""Unified model API (PyTorch twin of ``repro.models.api``): family dispatch.

  init_params(gen, cfg)                       -> param tree on gen.device
  param_shapes(cfg)                           -> TensorSpec tree (allocates nothing)
  param_count(cfg, active_only=False)         -> int
  loss_fn(params, cfg, batch)                 -> (scalar, metrics)
  forward(params, cfg, batch)                 -> (logits, aux)
  prefill(params, cfg, batch)                 -> (logits, cache)
  decode_step(params, cfg, state, tokens, pos)-> (logits, state)
  init_decode_state(cfg, batch, max_len)      -> TensorSpec tree
  allocate_decode_state(cfg, batch, max_len, device) -> zeroed cache tree
  grow_decode_state(cfg, cache, max_len)      -> prefill cache, grown
  input_specs(cfg, shape)                     -> TensorSpec dict (allocates nothing)
  model_flops(cfg, shape)                     -> 6*N*D (or 6*N_active*D)
"""
from __future__ import annotations

import functools
import math

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import sharding as sh
from repro_torch.core.config import ModelConfig, ShapeConfig
from repro_torch.models import dilated_vgg as DVGG
from repro_torch.models import encdec as ED
from repro_torch.models import layers as L
from repro_torch.models import lm as LM
from repro_torch.models.attention import TensorSpec


_LM_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm")
_ENCDEC_FAMILIES = ("encdec", "audio")


# the families that run under a mesh (``repro_torch.sharding``)
MESH_FAMILIES = ("dense", "moe", "hybrid", "ssm")


def _mod(cfg: ModelConfig):
    if sh.active_mesh() is not None and cfg.family not in MESH_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} under a mesh is not ported "
            f"yet; the port shards {MESH_FAMILIES} (ROADMAP.md item 14b)")
    if cfg.family in _LM_FAMILIES:
        return LM
    if cfg.family in _ENCDEC_FAMILIES:
        return ED
    if cfg.family == "convnet":
        return DVGG
    raise ValueError(cfg.family)


def init_params(gen: torch.Generator, cfg: ModelConfig):
    return _mod(cfg).init_params(gen, cfg)


def param_shapes(cfg: ModelConfig):
    """The param tree's shapes and dtypes, from an init traced with fake
    tensors (the twin of the reference's ``jax.eval_shape``).  A new tree
    each call, the trace made once per config."""
    return L.tree_map(lambda s: s, _param_shapes(cfg))


@functools.lru_cache(maxsize=16)
def _param_shapes(cfg: ModelConfig):
    with FakeTensorMode():
        fake = init_params(torch.Generator(), cfg)
    return L.tree_map(lambda t: TensorSpec(tuple(t.shape), t.dtype), fake)


def _leaf_sizes_with_paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [item for k, v in tree.items()
                for item in _leaf_sizes_with_paths(v, f"{prefix}/{k}")]
    return [(prefix, math.prod(tree.shape))]


def param_count(cfg: ModelConfig, active_only: bool = False) -> int:
    total = 0
    for path, n in _leaf_sizes_with_paths(param_shapes(cfg)):
        if active_only and cfg.moe is not None and "ffn_moe/w_" in path:
            # routed experts: only top-k of E are active per token
            n = n * cfg.moe.num_experts_per_tok // cfg.moe.num_experts
        total += n
    return total


def loss_fn(params, cfg: ModelConfig, batch, **kw):
    return _mod(cfg).loss_fn(params, cfg, batch, **kw)


def forward(params, cfg: ModelConfig, batch, **kw):
    return _mod(cfg).forward(params, cfg, batch, **kw)


def prefill(params, cfg: ModelConfig, batch):
    return _mod(cfg).prefill(params, cfg, batch)


def decode_step(params, cfg: ModelConfig, state, tokens, pos):
    return _mod(cfg).decode_step(params, cfg, state, tokens, pos)


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int):
    return _mod(cfg).init_decode_state(cfg, batch, max_len)


def allocate_decode_state(cfg: ModelConfig, batch: int, max_len: int, device):
    return _mod(cfg).allocate_decode_state(cfg, batch, max_len, device)


def grow_decode_state(cfg: ModelConfig, cache, max_len: int):
    """A prefill cache in a decode state of ``max_len`` positions (an
    enc-dec's cross cache stays at the frames' length)."""
    return _mod(cfg).grow_decode_state(cfg, cache, max_len)


def input_specs(cfg: ModelConfig, shape: ShapeConfig):
    """Inputs for the step function selected by ``shape.mode``:
    train/prefill -> batch dict; decode -> {tokens, pos, state}."""
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    emb_dt = L.dtype_of(cfg.compute_dtype)
    _mod(cfg)                  # raises for an unknown family
    if cfg.family == "convnet":
        net = cfg.convnet
        h, w = net.in_hw
        return {"image": TensorSpec((B, h, w, net.in_ch), emb_dt),
                "labels": TensorSpec((B, h, w), i32)}
    if cfg.family in _ENCDEC_FAMILIES:
        s_enc, s_dec = S // 2, S // 2
        if shape.mode in ("train", "prefill"):
            return {"frames": TensorSpec((B, s_enc, cfg.d_model), emb_dt),
                    "tokens": TensorSpec((B, s_dec), i32)}
        return {"tokens": TensorSpec((B,), i32), "pos": TensorSpec((), i32),
                "state": init_decode_state(cfg, B, s_dec)}
    if shape.mode in ("train", "prefill"):
        batch = {}
        s_text = S
        if cfg.frontend is not None and cfg.frontend.kind != "none":
            npre = min(cfg.frontend.num_prefix, S // 2)
            s_text = S - npre
            batch["prefix_embeds"] = TensorSpec((B, npre, cfg.d_model),
                                                emb_dt)
        batch["tokens"] = TensorSpec((B, s_text), i32)
        return batch
    # decode: one new token against a cache of S positions
    return {"tokens": TensorSpec((B,), i32), "pos": TensorSpec((), i32),
            "state": init_decode_state(cfg, B, S)}


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE) for the step.

    train: D = tokens processed (fwd+bwd = 6 N per token)
    prefill: 2 N per token (fwd only)
    decode: 2 N per generated token (D = batch tokens).
    """
    if cfg.family == "convnet":
        return float("nan")
    n_active = param_count(cfg, active_only=True)
    seq = shape.seq_len
    if cfg.family in _ENCDEC_FAMILIES:
        # S/2 encoder frames + S/2 decoder tokens; each stack (about half
        # of N) sees S/2 tokens, so N * S/2 overall
        seq = seq // 2
    tokens = shape.global_batch * (1 if shape.mode == "decode" else seq)
    per_token = 6 * n_active if shape.mode == "train" else 2 * n_active
    return float(per_token) * float(tokens)
