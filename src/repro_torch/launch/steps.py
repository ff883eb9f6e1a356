"""Step functions (PyTorch twin of ``repro.launch.steps``): train, prefill
and decode.  Under a mesh the caller runs a step inside
``sharding.activation_rules(mesh, seq_parallel=...)`` with its arguments
distributed (``sharding.distribute_tree`` of ``launch.mesh.shardings_for``),
as the reference's launchers do."""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.distributed.tensor import DTensor

from repro_torch.core.config import ModelConfig, OptimizerConfig, ShapeConfig
from repro_torch.models import api
from repro_torch.optim import adamw


def make_train_step(cfg: ModelConfig, opt_cfg: OptimizerConfig,
                    remat: str = "dots") -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the loss and its gradient with respect to every param leaf
    (``torch.autograd.grad``), then one AdamW step.  The params, ``m``,
    ``v`` and ``ef`` are updated in place and returned (the gradient is taken
    through detached aliases of the leaves, so the caller's tensors never
    require grad); metrics are the loss's and the optimizer's, as 0-d
    tensors on the params' device.  Under a mesh each gradient is laid out
    as its param (a sum still pending over the batch shards is reduced
    there: the data-parallel reduction of a replicated param)."""

    def train_step(params, opt_state, batch):
        items = adamw.named_leaves(params)
        alias = {path: leaf.detach().requires_grad_() for path, leaf in items}
        live = adamw.tree_like(params, alias)
        with torch.enable_grad():
            loss, metrics = api.loss_fn(live, cfg, batch, remat=remat)
            grads = torch.autograd.grad(loss, [alias[p] for p, _ in items])
        grads = adamw.tree_like(params, {
            path: g.redistribute(p.device_mesh, p.placements)
            if isinstance(g, DTensor) else g
            for (path, p), g in zip(items, grads)})
        params, opt_state, opt_metrics = adamw.adamw_update(
            params, grads, opt_state, opt_cfg)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(opt_metrics)
        return params, opt_state, metrics

    return train_step


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


def step_for_shape(cfg: ModelConfig, shape: ShapeConfig,
                   opt_cfg: Optional[OptimizerConfig] = None,
                   remat: str = "dots") -> Callable:
    """The step of a shape cell (the reference's returns its kind beside it,
    which nothing here reads):

    train  -> train_step(params, opt_state, batch)
    prefill-> prefill_step(params, batch)
    decode -> serve_step(params, state, tokens, pos)
    """
    if shape.mode == "train":
        return make_train_step(cfg, opt_cfg or OptimizerConfig(), remat=remat)
    if shape.mode == "prefill":
        return make_prefill_step(cfg)
    return make_serve_step(cfg)
