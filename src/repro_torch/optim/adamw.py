"""AdamW (decoupled weight decay), schedules, global-norm clipping and int8
gradient compression with error feedback (PyTorch twin of
``repro.optim.adamw``), over nested dicts of tensors.

Optimizer state is a tree parallel to params:
  {"m": f32 tree, "v": f32 tree, "step": int32 scalar, ("ef": f32 tree)}

The arithmetic is the reference's, in the reference's order, in plain tensor
ops (``torch.optim.AdamW`` clips and decays differently).  Leaves are
visited in sorted key order, as ``jax.tree.leaves`` does, so the global norm
sums them in the same order.  ``adamw_update`` writes the new params, ``m``,
``v`` and ``ef`` into the given tensors in place (no copy of the model or
its state per step) and returns them.

Under a mesh the leaves are DTensors: the global norm costs one scalar
all-reduce per mesh axis (:func:`global_norm`) and the update runs on each
rank's own shards, in place, with no other communication.
"""
from __future__ import annotations

import math
import re
from typing import Any, Dict, List, Tuple

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Shard

from repro_torch.core.config import OptimizerConfig

Params = Any


def named_leaves(tree, prefix="") -> List[Tuple[str, torch.Tensor]]:
    """(path, leaf) pairs in sorted key order, paths joined by "/"."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in named_leaves(tree[k], f"{prefix}/{k}")]
    return [(prefix, tree)]


def leaves(tree) -> List[torch.Tensor]:
    return [leaf for _, leaf in named_leaves(tree)]


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def lr_schedule(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (an int32 tensor), f32 on its device."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "constant":
        decay = 1.0
    else:
        frac = torch.clamp((step - cfg.warmup_steps)
                           / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
        if cfg.schedule == "linear":
            decay = 1.0 - frac
        else:  # cosine
            decay = 0.5 * (1.0 + torch.cos(math.pi * frac))
    return cfg.lr * warm * decay


def init_opt_state(params: Params, cfg: OptimizerConfig) -> Dict:
    def zeros32(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    device = leaves(params)[0].device
    state = {
        "m": _map(zeros32, params),
        "v": _map(zeros32, params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }
    if cfg.grad_compression == "int8_ef":
        state["ef"] = _map(zeros32, params)
    return state


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's own shard (its storage), or ``t`` itself."""
    return t.to_local() if isinstance(t, DTensor) else t


def _copies(t: DTensor) -> int:
    """How many ranks hold each element of ``t``: the sizes of the mesh
    axes it is not sharded over."""
    mesh = t.device_mesh
    return math.prod(mesh.shape[i] for i, p in enumerate(t.placements)
                     if not isinstance(p, Shard))


def global_norm(tree: Params) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf.  Over DTensor leaves each
    rank sums its own shards (a replicated element counted once over its
    copies) and the sums are all-reduced over the leaves' mesh, one axis
    at a time (only its ranks, also where the mesh is part of the world);
    the norm is a plain tensor, the same on every rank of the mesh."""
    total = 0
    mesh = None
    for leaf in leaves(tree):
        if isinstance(leaf, DTensor):
            mesh = leaf.device_mesh
            total = total + torch.sum(torch.square(
                leaf.to_local().float())) / _copies(leaf)
        else:
            total = total + torch.sum(torch.square(leaf.float()))
    for dim in range(mesh.ndim if mesh is not None else 0):
        if mesh.shape[dim] > 1:
            total = funcol.wait_tensor(funcol.all_reduce(
                total, "sum", (mesh, dim)))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def clip_by_global_norm(grads: Params, max_norm: float
                        ) -> Tuple[Params, torch.Tensor]:
    """The gradients scaled (each rank's own shards of DTensor leaves)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return _map(lambda g: _local(g).float() * scale, grads), norm


# ---------------------------------------------------------------------------
# int8 gradient compression with error feedback: quantize to int8 with a
# per-tensor scale, feed the residual back into the next step (the
# reference models the compressed all-reduce as quantize -> dequantize; so
# does the port, on one card).  torch.round rounds half to even, as
# jnp.round does.
# ---------------------------------------------------------------------------


def compress_decompress(g: torch.Tensor, ef: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    gf = g.float() + ef
    scale = torch.clamp(torch.max(torch.abs(gf)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127)
    deq = q * scale
    return deq, gf - deq


def apply_compression(grads: Params, state: Dict) -> Tuple[Params, Dict]:
    """Compressed grads, and the state with the new residuals written into
    ``state["ef"]`` in place."""
    if "ef" not in state:
        return grads, state
    out = {}
    for (path, g), (_, ef) in zip(named_leaves(grads), named_leaves(state["ef"])):
        deq, residual = compress_decompress(g, ef)
        ef.copy_(residual)
        out[path] = deq
    return tree_like(grads, out), state


def tree_like(tree, flat: Dict[str, torch.Tensor], prefix=""):
    """``tree``'s nesting with each leaf replaced by ``flat[its path]``."""
    if isinstance(tree, dict):
        return {k: tree_like(v, flat, f"{prefix}/{k}")
                for k, v in tree.items()}
    return flat[prefix]


_DECAY_EXEMPT = (r"norm", r"/scale$", r"/bias$", r"/b$", r"/mu_", r"/w0$",
                 r"/A_log$", r"/D$", r"/u$")


def _decay_mask(path: str) -> float:
    return 0.0 if any(re.search(t, path) for t in _DECAY_EXEMPT) else 1.0


@torch.no_grad()
def adamw_update(params: Params, grads: Params, state: Dict,
                 cfg: OptimizerConfig) -> Tuple[Params, Dict, Dict]:
    """One AdamW step, in place.  Returns (params, state, {"grad_norm",
    "lr"}).  DTensor leaves are updated on each rank's own shards."""
    if "ef" in state and isinstance(leaves(grads)[0], DTensor):
        raise NotImplementedError(
            "int8 gradient compression under a mesh is not ported yet "
            "(ROADMAP.md item 14b)")
    grads, state = apply_compression(grads, state)
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    step = _local(state["step"]) + 1
    lr = lr_schedule(cfg, step)
    b1, b2, eps = cfg.b1, cfg.b2, cfg.eps
    bc1 = 1.0 - b1 ** step.float()
    bc2 = 1.0 - b2 ** step.float()
    for (path, p), (_, g), (_, m), (_, v) in zip(
            named_leaves(params), named_leaves(grads), named_leaves(state["m"]),
            named_leaves(state["v"])):
        p, m, v = _local(p), _local(m), _local(v)
        gf = g.float()
        m_new = b1 * m + (1 - b1) * gf
        v_new = b2 * v + (1 - b2) * torch.square(gf)
        mhat = m_new / bc1
        vhat = v_new / bc2
        delta = mhat / (torch.sqrt(vhat) + eps)
        delta = delta + cfg.weight_decay * _decay_mask(path) * p.float()
        p.copy_(p.float() - lr * delta)
        m.copy_(m_new)
        v.copy_(v_new)
    _local(state["step"]).copy_(step)
    return params, state, {"grad_norm": gnorm, "lr": lr}
