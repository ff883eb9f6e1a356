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
  input_specs(cfg, shape)                     -> TensorSpec dict (allocates nothing)
  model_flops(cfg, shape)                     -> 6*N*D (or 6*N_active*D)
"""
from __future__ import annotations

import math

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.core.config import ModelConfig, ShapeConfig
from repro_torch.models import dilated_vgg as DVGG
from repro_torch.models import layers as L
from repro_torch.models import lm as LM
from repro_torch.models.attention import TensorSpec


# the decoder-only families the port runs ("vlm" waits for its prefix)
_LM_FAMILIES = ("dense", "moe", "ssm", "hybrid")


def _mod(cfg: ModelConfig):
    if cfg.family in _LM_FAMILIES:
        return LM
    if cfg.family == "convnet":
        return DVGG
    raise NotImplementedError(
        f"family {cfg.family!r} is not ported yet; the port runs "
        f"{_LM_FAMILIES + ('convnet',)} (ROADMAP.md, Queue 1 item 12)")


def init_params(gen: torch.Generator, cfg: ModelConfig):
    return _mod(cfg).init_params(gen, cfg)


def param_shapes(cfg: ModelConfig):
    """The param tree's shapes and dtypes, from an init traced with fake
    tensors (the twin of the reference's ``jax.eval_shape``)."""
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


def input_specs(cfg: ModelConfig, shape: ShapeConfig):
    """Inputs for the step function selected by ``shape.mode``:
    train/prefill -> batch dict; decode -> {tokens, pos, state}."""
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if cfg.family == "convnet":
        net = cfg.convnet
        h, w = net.in_hw
        return {"image": TensorSpec((B, h, w, net.in_ch),
                                    L.dtype_of(cfg.compute_dtype)),
                "labels": TensorSpec((B, h, w), i32)}
    _mod(cfg)                  # raises for a family the port does not run
    if cfg.frontend is not None and cfg.frontend.kind != "none":
        raise NotImplementedError("modality prefixes are not ported yet")
    if shape.mode in ("train", "prefill"):
        return {"tokens": TensorSpec((B, S), i32)}
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
    tokens = shape.global_batch * (1 if shape.mode == "decode"
                                   else shape.seq_len)
    per_token = 6 * n_active if shape.mode == "train" else 2 * n_active
    return float(per_token) * float(tokens)
