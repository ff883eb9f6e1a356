"""Sharding rules: logical activation/parameter axes -> mesh axes (PyTorch
twin of ``repro.sharding``), over a ``torch.distributed`` ``DeviceMesh``.

Model code annotates activations with *logical* axis names via
:func:`constrain`; launchers install a rule set for the active mesh.  Rules
degrade gracefully: an axis whose size does not divide its mesh axis falls
back to replication (required because e.g. qwen2.5-14b has 8 KV heads on a
16-way model axis, and granite's vocab 49155 is odd).

Parameter sharding is name/shape based (:func:`param_pspecs`): 2-D matrices
are FSDP-sharded on d_in ("data") and tensor-parallel on d_out ("model")
when divisible; expert tensors put the expert dim on "model"; embeddings
shard vocab on "model" and d_model on "data".

A spec is a plain tuple, one entry a tensor dim: None, a mesh-axis name, or
a tuple of names sharing the dim (batch over ("pod", "data")), entry for
entry what the reference's ``PartitionSpec`` holds.  :func:`placements`
turns one into DTensor placements, one a mesh dim, and
:func:`distribute` a tree of tensors into DTensors.  Shards that do not
divide follow ``torch.chunk`` (40 heads on 16 ranks: 3 on rank 0), as the
reference's padding does.

Without a mesh :func:`constrain` is the identity and nothing here runs, so
every one-chip path is unchanged.
"""
from __future__ import annotations

import math
import re
from contextlib import contextmanager
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

Spec = Tuple[Any, ...]

# ---------------------------------------------------------------------------
# Logical axis rules
# ---------------------------------------------------------------------------

# logical name -> preferred mesh axes (first that divides wins; tuples mean
# use the product of axes jointly, e.g. batch over (pod, data)).
DEFAULT_RULES: Dict[str, Tuple] = {
    "batch": (("pod", "data"), ("data",)),
    "seq": (("model",),),          # sequence parallelism (long-context)
    "embed": (("model",),),
    "heads": (("model",),),
    "kv_heads": (("model",),),
    "mlp": (("model",),),
    "vocab": (("model",),),
    "expert": (("model",),),
    "kv_seq": (("model",),),       # decode KV-cache sequence dim
    "none": ((),),
}

_ACTIVE: Dict[str, Any] = {"mesh": None, "rules": DEFAULT_RULES,
                           "seq_parallel": False}


@contextmanager
def activation_rules(mesh, rules: Optional[Dict] = None,
                     seq_parallel: bool = False):
    prev = dict(_ACTIVE)
    _ACTIVE["mesh"] = mesh
    _ACTIVE["rules"] = rules or DEFAULT_RULES
    _ACTIVE["seq_parallel"] = seq_parallel
    try:
        yield
    finally:
        _ACTIVE.update(prev)


def active_mesh():
    """The mesh of the innermost :func:`activation_rules`, or None."""
    return _ACTIVE["mesh"]


def seq_parallel() -> bool:
    return bool(_ACTIVE["seq_parallel"])


def _mesh_axis_sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _resolve_axis(logical: Optional[str], dim_size: int,
                  sizes: Dict[str, int], used: set,
                  strict: bool = False) -> Optional[Any]:
    if logical is None or logical == "none":
        return None
    for cand in _ACTIVE["rules"].get(logical, ((),)):
        axes = [a for a in cand if a in sizes and a not in used]
        if not axes:
            continue
        total = math.prod(sizes[a] for a in axes)
        # activations (strict=False) take uneven shards, padded as
        # torch.chunk splits; arguments (strict=True) divide exactly
        ok = (dim_size % total == 0) if strict else (dim_size >= total)
        if total > 1 and ok:
            for a in axes:
                used.add(a)
            return tuple(axes) if len(axes) > 1 else axes[0]
    return None


def spec_for(logical_axes: Sequence[Optional[str]],
             shape: Sequence[int], mesh, strict: bool = False) -> Spec:
    sizes = _mesh_axis_sizes(mesh)
    used: set = set()
    return tuple(_resolve_axis(ax, d, sizes, used, strict)
                 for ax, d in zip(logical_axes, shape))


# ---------------------------------------------------------------------------
# Specs as DTensor placements
# ---------------------------------------------------------------------------


def placements(spec: Spec, mesh) -> Tuple:
    """One placement a mesh dim: ``Shard(d)`` where the spec puts tensor dim
    d on that mesh axis (each axis of a tuple entry), else ``Replicate()``."""
    out = [Replicate()] * mesh.ndim
    names = list(mesh.mesh_dim_names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            out[names.index(axis)] = Shard(d)
    return tuple(out)


def mesh_dim(mesh, name: str) -> Optional[int]:
    names = list(mesh.mesh_dim_names)
    return names.index(name) if name in names else None


def _chunk(size: int, n: int, i: int) -> Tuple[int, int]:
    """(offset, length) of piece ``i`` of ``torch.chunk`` of ``size`` into
    ``n``: pieces of ceil(size / n), the last ones short or empty."""
    per = -(-size // n) if size else 0
    start = min(i * per, size)
    return start, min(per, size - start)


def local_extent(shape: Sequence[int], place: Sequence, mesh,
                 coord: Optional[Sequence[int]] = None
                 ) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """(local shape, global offset) of the shard that mesh coordinate
    ``coord`` (this rank's by default) holds of a tensor of ``shape`` under
    ``place``, mesh dims applied in order as DTensor applies them."""
    coord = mesh.get_coordinate() if coord is None else coord
    size, off = list(shape), [0] * len(shape)
    for md, p in enumerate(place):
        if isinstance(p, Shard):
            d = p.dim % len(shape)
            start, size[d] = _chunk(size[d], mesh.shape[md], coord[md])
            off[d] += start
    return tuple(size), tuple(off)


def _contiguous_stride(shape: Sequence[int]) -> Tuple[int, ...]:
    stride, acc = [], 1
    for s in reversed(shape):
        stride.append(acc)
        acc *= max(s, 1)
    return tuple(reversed(stride))


def distribute(t: torch.Tensor, spec: Spec, mesh) -> DTensor:
    """``t`` (the whole tensor, the same on every rank) as a DTensor of
    ``spec``: each rank copies out its own shard, with no communication, so
    that an update in place never writes ``t``.  A ``meta`` tensor becomes
    a DTensor over a ``meta`` shard of this rank's local shape, for a dry
    run on a virtual group."""
    place = placements(spec, mesh)
    local, off = local_extent(t.shape, place, mesh)
    if t.device.type == "meta":
        shard = torch.empty(local, dtype=t.dtype, device="meta")
    else:
        shard = t[tuple(slice(o, o + n) for o, n in zip(off, local))].clone(
            memory_format=torch.contiguous_format)
    return DTensor.from_local(shard, mesh, place, run_check=False,
                              shape=t.shape,
                              stride=_contiguous_stride(t.shape))


def distribute_tree(tree, specs, mesh):
    """:func:`distribute` leaf by leaf over nested dicts (a spec tree of the
    same keys, as :func:`param_pspecs` builds)."""
    if isinstance(tree, dict):
        return {k: distribute_tree(v, specs[k], mesh) for k, v in tree.items()}
    return distribute(tree, specs, mesh)


def local_bytes(shapes, specs, mesh) -> int:
    """Bytes that rank 0 holds of a tree of shapes (anything with ``shape``
    and ``dtype``) sharded by ``specs``; nothing is allocated."""
    if isinstance(shapes, dict):
        return sum(local_bytes(v, specs[k], mesh) for k, v in shapes.items())
    local, _ = local_extent(shapes.shape, placements(specs, mesh), mesh,
                            coord=[0] * mesh.ndim)
    return math.prod(local) * torch.empty((), dtype=shapes.dtype).element_size()


def full(t):
    """The whole tensor of a DTensor (gathered), or ``t`` itself."""
    return t.full_tensor() if isinstance(t, DTensor) else t


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------


def constrain(x: torch.Tensor, logical_axes: Sequence[Optional[str]]
              ) -> torch.Tensor:
    """Lay an activation out by logical axes: redistributed to the spec's
    placements under a mesh (a pending sum reduces there), the identity
    without one."""
    mesh = _ACTIVE["mesh"]
    if mesh is None or len(logical_axes) != x.ndim:
        return x
    if not _ACTIVE["seq_parallel"]:
        logical_axes = [None if a in ("seq", "kv_seq") else a
                        for a in logical_axes]
    spec = spec_for(logical_axes, x.shape, mesh)
    return x.redistribute(mesh, placements(spec, mesh))


def with_placement(x: DTensor, mesh_axis: str, place) -> DTensor:
    """``x`` with ``place`` on one mesh axis and its other placements kept
    (the identity when it is already so)."""
    md = mesh_dim(x.device_mesh, mesh_axis)
    if md is None or x.placements[md] == place:
        return x
    new = list(x.placements)
    new[md] = place
    return x.redistribute(x.device_mesh, tuple(new))


def on_model(x: DTensor):
    """``x``'s placement on the "model" axis (Replicate without one)."""
    md = mesh_dim(x.device_mesh, "model")
    return Replicate() if md is None else x.placements[md]


def model_size(mesh) -> int:
    md = mesh_dim(mesh, "model")
    return 1 if md is None else mesh.shape[md]


def model_rank(mesh) -> int:
    md = mesh_dim(mesh, "model")
    return 0 if md is None else mesh.get_coordinate()[md]


def on_model_as(t: DTensor, place) -> Tuple:
    """``t``'s placements with ``place`` on the "model" axis."""
    md = mesh_dim(t.device_mesh, "model")
    return tuple(place if i == md else p for i, p in enumerate(t.placements))


def batch_grad(data: DTensor, w: DTensor, model: bool = False) -> Tuple:
    """Where the gradient of ``w`` is left, a rank having read it against
    its own batch rows (dim 0) of ``data`` (and, with ``model``, read only
    its own slice of ``w``): partial over the axes that shard the batch
    (and over "model"), laid out as ``w`` elsewhere."""
    md = mesh_dim(w.device_mesh, "model")
    return tuple(Partial() if d == Shard(0) or (model and i == md) else p
                 for i, (d, p) in enumerate(zip(data.placements,
                                                w.placements)))


def run_local(fn, out_placements: Sequence, *args, in_grad_placements=None):
    """``fn`` on each rank's shards of ``args`` (DTensors as they are laid
    out, anything else as it is), its tensor result a DTensor of
    ``out_placements`` (``local_map``; shards even, as ``local_map``
    infers the global shape from the local one); a tuple of results takes
    a sequence of placements, one a result.  ``in_grad_placements`` names
    where an input's gradient is left partial (a rank reads part of a
    replicated input)."""
    from torch.distributed.tensor.experimental import local_map
    mesh = next(a.device_mesh for a in args if isinstance(a, DTensor))
    in_pl = tuple(a.placements if isinstance(a, DTensor) else None
                  for a in args)
    if isinstance(out_placements[0], (tuple, list)):   # one a result
        out_placements = tuple(list(p) for p in out_placements)
    else:
        out_placements = list(out_placements)
    return local_map(fn, out_placements=out_placements,
                     in_placements=in_pl,
                     in_grad_placements=in_grad_placements,
                     device_mesh=mesh)(*args)


class _GradAs(torch.autograd.Function):
    """The identity, whose backward lays its gradient out as ``place``."""

    @staticmethod
    def forward(ctx, x, place):
        ctx.place = place
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.redistribute(grad.device_mesh, ctx.place), None


def grad_as(x: DTensor, place: Sequence) -> DTensor:
    """``x``, its gradient reduced to ``place`` where it enters it (a
    pending sum of a gradient meets ops that DTensor runs only after
    scattering it over the batch)."""
    return _GradAs.apply(x, tuple(place))


def gather_fsdp(w: DTensor) -> DTensor:
    """A weight gathered over every mesh axis but "model" (its FSDP shard
    over "data"), its "model" shard kept: what a product reads."""
    md = mesh_dim(w.device_mesh, "model")
    new = tuple(p if i == md else Replicate()
                for i, p in enumerate(w.placements))
    return w if new == tuple(w.placements) else \
        w.redistribute(w.device_mesh, new)


# ---------------------------------------------------------------------------
# Parameter sharding (name + shape based)
# ---------------------------------------------------------------------------

# Patterns are matched against '/'-joined param paths.  Axis names refer to
# trailing dims; leading stack dims (layers) are never sharded.
_PARAM_RULES = [
    # embeddings: (vocab, d_model)
    (r"embed.*/table$", ("vocab", "embed_fsdp")),
    (r"lm_head/w$", ("embed_fsdp", "vocab")),
    # MoE expert tensors: (E, d_in, d_out)
    (r"(moe|ffn_moe).*/w_(up|gate)$", ("expert", "fsdp", None)),
    (r"(moe|ffn_moe).*/w_down$", ("expert", None, "fsdp")),
    (r"(moe|ffn_moe).*/router/w$", (None, None)),
    # generic 2-D projections: FSDP in, TP out
    (r"/(w_up|w_gate|wq|wk|wv|in_proj|x_proj)/w$", ("fsdp", "tp")),
    (r"/(w_down|wo|out_proj|dt_proj)/w$", ("tp", "fsdp")),
    (r"/w$", ("fsdp", "tp")),
    # biases / norms / vectors: shard like the out dim when large
    (r"/b$", ("tp",)),
    (r".*", ()),
]

_LOGICAL_PARAM_AXES = {
    "vocab": ("model",),
    "embed_fsdp": ("data",),
    "expert": ("model",),
    "fsdp": ("data",),
    "tp": ("model",),
}


def _param_spec(path: str, shape: Tuple[int, ...], sizes: Dict[str, int]
                ) -> Spec:
    ndim = len(shape)
    for pat, axes in _PARAM_RULES:
        if re.search(pat, path):
            spec: list = [None] * ndim
            if not axes:
                return tuple(spec)
            n = len(axes)
            if ndim < n:
                return tuple(spec)
            used: set = set()
            offset = ndim - n          # leading dims = layer stacks
            for i, logical in enumerate(axes):
                if logical is None:
                    continue
                for a in _LOGICAL_PARAM_AXES.get(logical, ()):
                    # params are step arguments: exact divisibility
                    if a in sizes and a not in used and sizes[a] > 1 \
                            and shape[offset + i] % sizes[a] == 0:
                        spec[offset + i] = a
                        used.add(a)
                        break
            return tuple(spec)
    return (None,) * ndim


def param_pspecs(params_shapes, mesh):
    """Tree of specs matching a tree of tensors or ``TensorSpec``s."""
    sizes = _mesh_axis_sizes(mesh)

    def build(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: build(v, f"{prefix}/{k}") for k, v in tree.items()}
        return _param_spec(prefix, tuple(tree.shape), sizes)

    return build(params_shapes)


def input_pspec(shape: Tuple[int, ...], logical: Sequence[Optional[str]],
                mesh) -> Spec:
    # inputs are step arguments: strict divisibility
    return spec_for(logical, shape, mesh, strict=True)


# ---------------------------------------------------------------------------
# Decode-state (KV cache / SSM state) sharding — name + rank based
# ---------------------------------------------------------------------------

# Logical axes per cache leaf, selected by (path suffix, rank).  Leading
# stack dims (scan periods) are padded with None.
_STATE_RULES = [
    (r"attn/k$|attn/v$|cross_k$|cross_v$",
     ("batch", "kv_heads", "kv_seq", None)),
    (r"/ckv$", ("batch", "kv_seq", None)),
    (r"/krope$", ("batch", "kv_seq", None)),
    (r"ssm/conv$", ("batch", None, "mlp")),
    (r"ssm/state$", ("batch", "mlp", None)),
    (r"/wkv$", ("batch", "heads", None, None)),
    (r"/shift_t$|/shift_c$", ("batch", "embed")),
]


def _state_spec(path: str, shape: Tuple[int, ...], mesh,
                seq_parallel: bool = True) -> Spec:
    for pat, logical in _STATE_RULES:
        if re.search(pat, path):
            n_lead = len(shape) - len(logical)
            if n_lead < 0:
                break
            axes = list(logical)
            if not seq_parallel:
                axes = [None if a == "kv_seq" else a for a in axes]
            return spec_for([None] * n_lead + axes, shape, mesh, strict=True)
    return (None,) * len(shape)


def state_pspecs(state_shapes, mesh, seq_parallel: bool = True):
    def build(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: build(v, f"{prefix}/{k}") for k, v in tree.items()}
        return _state_spec(prefix, tuple(tree.shape), mesh, seq_parallel)

    return build(state_shapes)
