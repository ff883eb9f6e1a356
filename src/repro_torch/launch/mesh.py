"""Mesh construction + sharding assignment for the production topology
(PyTorch twin of ``repro.launch.mesh``), on ``torch.distributed``.

``make_production_mesh`` builds the meshes the dry run counts:
  single-pod:  (16, 16)        axes ("data", "model")   = 256 ranks
  multi-pod:   (2, 16, 16)     axes ("pod", "data", "model") = 512 ranks

A mesh needs a process group of its size.  :func:`virtual_group` opens one
on torch's ``"fake"`` backend at rank 0: collectives return at once and
move nothing, so one process traces rank 0's share of a step on ``meta``
tensors and counts its collectives at their local shapes.  A real run opens
its own group (NCCL on the card, gloo on the CPU) and builds the mesh the
same way.  Importing this module touches no process group.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch import sharding as sh
from repro_torch.core.config import ModelConfig, ShapeConfig

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


@contextmanager
def virtual_group(world_size: int):
    """A process group of ``world_size`` ranks on the ``"fake"`` backend,
    this process rank 0, for as long as the context lasts.  Refuses to open
    while a group is initialised."""
    if dist.is_initialized():
        raise RuntimeError("virtual_group: a process group is already "
                           "initialised in this process")
    # importing the module registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cpu") -> DeviceMesh:
    shape, axes = PRODUCTION_SHAPES[multi_pod]
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_elastic_mesh(num_devices: int, model_parallel: int = 16,
                      device_type: str = "cpu") -> DeviceMesh:
    """Best-effort (data, model) mesh over the first ranks of the group for
    an arbitrary surviving device count (elastic scaling after failures)."""
    while model_parallel > 1 and num_devices % model_parallel:
        model_parallel //= 2
    data = num_devices // model_parallel
    ranks = torch.arange(data * model_parallel).reshape(data, model_parallel)
    return DeviceMesh(device_type, ranks, mesh_dim_names=("data", "model"))


def mesh_name(mesh) -> str:
    return "x".join(str(s) for s in mesh.shape)


# ---------------------------------------------------------------------------
# Sharding assignment per step kind (specs; ``sh.distribute_tree`` applies
# them)
# ---------------------------------------------------------------------------


def batch_shardings(cfg: ModelConfig, batch_specs: Dict[str, Any],
                    mesh) -> Dict[str, Any]:
    out = {}
    for k, v in batch_specs.items():
        if k in ("tokens", "labels"):
            logical = ("batch",) + (None,) * (len(v.shape) - 1)
        elif k in ("prefix_embeds", "frames"):
            logical = ("batch", None, None)
        elif k == "image":
            logical = ("batch", None, None, None)
        elif k == "pos":
            logical = ()
        else:
            logical = (None,) * len(v.shape)
        out[k] = sh.input_pspec(v.shape, logical, mesh)
    return out


def shardings_for(cfg: ModelConfig, shape: ShapeConfig, mesh,
                  params_shapes, opt_shapes=None,
                  input_specs: Optional[Dict[str, Any]] = None,
                  seq_parallel: bool = False) -> Dict[str, Any]:
    """Spec trees of the step's arguments for this shape cell."""
    out: Dict[str, Any] = {"params": sh.param_pspecs(params_shapes, mesh)}
    if opt_shapes is not None:
        opt_sh = {"m": sh.param_pspecs(opt_shapes["m"], mesh),
                  "v": sh.param_pspecs(opt_shapes["v"], mesh),
                  "step": ()}
        if "ef" in opt_shapes:
            opt_sh["ef"] = sh.param_pspecs(opt_shapes["ef"], mesh)
        out["opt_state"] = opt_sh
    if input_specs is not None:
        if shape.mode == "decode":
            out["state"] = sh.state_pspecs(input_specs["state"], mesh,
                                           seq_parallel=seq_parallel)
            out["tokens"] = sh.input_pspec(input_specs["tokens"].shape,
                                           ("batch",), mesh)
            out["pos"] = ()
        else:
            out["batch"] = batch_shardings(cfg, input_specs, mesh)
    return out
