"""Unified model API (PyTorch twin of ``repro.models.api``): family dispatch.

  init_params(gen, cfg)                       -> param tree on gen.device
  forward(params, cfg, batch)                 -> (logits, aux)
  prefill(params, cfg, batch)                 -> (logits, cache)
  decode_step(params, cfg, state, tokens, pos)-> (logits, state)
  init_decode_state(cfg, batch, max_len)      -> TensorSpec tree
  allocate_decode_state(cfg, batch, max_len, device) -> zeroed cache tree
"""
from __future__ import annotations

import torch

from repro_torch.core.config import ModelConfig
from repro_torch.models import lm as LM


# the decoder-only families the port runs ("vlm" waits for its prefix)
_LM_FAMILIES = ("dense", "moe", "ssm", "hybrid")


def _mod(cfg: ModelConfig):
    if cfg.family in _LM_FAMILIES:
        return LM
    raise NotImplementedError(
        f"family {cfg.family!r} is not ported yet; the port runs "
        f"{_LM_FAMILIES} (ROADMAP.md, Queue 1 items 12-13)")


def init_params(gen: torch.Generator, cfg: ModelConfig):
    return _mod(cfg).init_params(gen, cfg)


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
