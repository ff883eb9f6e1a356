"""Step functions (PyTorch twin of ``repro.launch.steps``): prefill and
decode.  The training step comes with the training slice (ROADMAP.md,
Queue 1 item 6)."""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.config import ModelConfig
from repro_torch.models import api


def make_prefill_step(cfg: ModelConfig) -> Callable:
    @torch.no_grad()
    def prefill_step(params, batch):
        return api.prefill(params, cfg, batch)

    return prefill_step


def make_serve_step(cfg: ModelConfig) -> Callable:
    """One decode step: new token against an existing cache, written in
    place."""

    @torch.no_grad()
    def serve_step(params, state, tokens, pos):
        return api.decode_step(params, cfg, state, tokens, pos)

    return serve_step
