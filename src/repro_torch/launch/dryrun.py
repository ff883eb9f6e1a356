"""Dry run of the port (twin of ``repro.launch.dryrun``): for every
(architecture x input-shape) cell, trace the step once on ``meta`` tensors,
which hold no data, and count its FLOPs, bytes and peak memory
(``core.cost.analysis``), the hand-written kernels' shares included.
Nothing is allocated and nothing runs on any device.  Writes one JSON
artifact a cell with the reference's keys and ``trace_seconds`` in place of
``lower_seconds`` and ``compile_seconds``.

By default a cell is one chip (tag ``_1``).  ``--single-pod``,
``--multi-pod`` and ``--both-meshes`` count it instead on the production
meshes, (16, 16) ("data", "model") and (2, 16, 16) ("pod", "data",
"model") (tags ``_256`` and ``_512``), as rank 0 of a virtual process group
(``launch.mesh.virtual_group``): params, optimizer state and inputs laid
out by ``launch.mesh.shardings_for``, the step run on rank 0's shards, its
collectives counted by kind.  Decode shards the KV cache along its keys
(``seq_parallel``), as the reference's dry run does.  Families the mesh
does not run yet print as NOT PORTED.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b \\
        --shape decode_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--out DIR]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback
from typing import Dict, Optional

import torch

from repro_torch.core.config import (LM_SHAPES, ModelConfig, OptimizerConfig,
                                     ShapeConfig, get_arch, list_archs)
from repro_torch import sharding as sh
from repro_torch.core.cost.analysis import analyze_step
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps as steps_lib
from repro_torch.models import api
from repro_torch.models import layers as L
from repro_torch.optim import adamw


def empty_like_specs(tree, device):
    """A tree of uninitialised tensors of a TensorSpec tree's shapes and
    dtypes on ``device`` (``meta``: no memory at all)."""
    return L.tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                            device=device), tree)


def step_args(cfg: ModelConfig, shape: ShapeConfig, device="meta",
              opt_cfg: Optional[OptimizerConfig] = None, mesh=None,
              seq_parallel: bool = False) -> tuple:
    """The step's arguments for ``shape.mode`` on ``device``: (params,
    opt_state, batch), (params, batch) or (params, state, tokens, pos);
    with a ``mesh``, distributed as ``launch.mesh.shardings_for`` lays them
    out (on ``meta``: this rank's shards, nothing allocated)."""
    params = empty_like_specs(api.param_shapes(cfg), device)
    inputs = empty_like_specs(api.input_specs(cfg, shape), device)
    opt = adamw.init_opt_state(params, opt_cfg or OptimizerConfig()) \
        if shape.mode == "train" else None
    if mesh is not None:
        specs = mesh_lib.shardings_for(cfg, shape, mesh, params, opt, inputs,
                                       seq_parallel=seq_parallel)
        params = sh.distribute_tree(params, specs["params"], mesh)
        if opt is not None:
            opt = sh.distribute_tree(opt, specs["opt_state"], mesh)
        if shape.mode == "decode":
            inputs = {"state": sh.distribute_tree(inputs["state"],
                                                  specs["state"], mesh),
                      "tokens": sh.distribute(inputs["tokens"],
                                              specs["tokens"], mesh),
                      "pos": sh.distribute(inputs["pos"], specs["pos"], mesh)}
        else:
            inputs = sh.distribute_tree(inputs, specs["batch"], mesh)
    if shape.mode == "train":
        return params, opt, inputs
    if shape.mode == "prefill":
        return params, inputs
    return params, inputs["state"], inputs["tokens"], inputs["pos"]


def count_cell(cfg: ModelConfig, shape: ShapeConfig, remat: str = "full",
               device="meta", mesh=None, seq_parallel: bool = False) -> Dict:
    """``analyze_step``'s report of one step of ``shape`` on ``device``:
    ``meta`` for the dry run; a test passes fake CPU tensors' device under
    ``FakeTensorMode`` to count the plain versions instead.  With a
    ``mesh`` (of a group this process belongs to, e.g. a
    ``launch.mesh.virtual_group``) the count is one rank's: its shards,
    its kernels' calls and its collectives."""
    opt_cfg = OptimizerConfig()
    step_fn = steps_lib.step_for_shape(cfg, shape, opt_cfg, remat=remat)
    with sh.activation_rules(mesh, seq_parallel=seq_parallel):
        args = step_args(cfg, shape, device, opt_cfg, mesh, seq_parallel)
        return analyze_step(step_fn, *args)


def count_on_mesh(cfg: ModelConfig, shape: ShapeConfig, multi_pod: bool,
                  seq_parallel: Optional[bool] = None, remat: str = "full"
                  ) -> Dict:
    """:func:`count_cell` as rank 0 of a production mesh, inside a virtual
    group of its size; ``seq_parallel`` defaults to decode's (the
    reference's).  The report gains ``mesh``, ``chips``, ``multi_pod`` and
    ``seq_parallel``."""
    if seq_parallel is None:
        seq_parallel = shape.mode == "decode"
    dims, _ = mesh_lib.PRODUCTION_SHAPES[multi_pod]
    with mesh_lib.virtual_group(math.prod(dims)):
        mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod)
        report = count_cell(cfg, shape, remat=remat, mesh=mesh,
                            seq_parallel=seq_parallel)
        report.update({"mesh": mesh_lib.mesh_name(mesh),
                       "chips": mesh.size(), "multi_pod": multi_pod,
                       "seq_parallel": seq_parallel})
    return report


def dryrun_cell(arch_id: str, shape_name: str, remat: str = "full",
                verbose: bool = True, multi_pod: Optional[bool] = None,
                seq_parallel: Optional[bool] = None) -> Dict:
    """Count one cell on ``meta``; returns the roofline artifact dict: one
    chip when ``multi_pod`` is None, else rank 0 of the single-pod (False)
    or multi-pod (True) mesh.

    Baseline remat='full', as the reference's: recompute each period in the
    backward."""
    spec = get_arch(arch_id)
    cfg = spec.model
    shape = LM_SHAPES[shape_name]
    if multi_pod is None:
        report = count_cell(cfg, shape, remat=remat)
        report.update({"mesh": "1", "chips": 1, "multi_pod": False,
                       "seq_parallel": False})
    else:
        report = count_on_mesh(cfg, shape, multi_pod, seq_parallel, remat)
    report.update({
        "arch": arch_id, "shape": shape_name, "remat": remat,
        "model_flops": api.model_flops(cfg, shape),
        "param_count": api.param_count(cfg),
        "active_param_count": api.param_count(cfg, active_only=True),
    })
    if verbose:
        where = "one chip" if multi_pod is None else f"mesh {report['mesh']}"
        print(f"[{arch_id} | {shape_name} | {where}]")
        print(f"  trace {report['trace_seconds']:.1f}s")
        print(f"  per-device: flops={report['flops']:.3e} "
              f"hbm={report['hbm_bytes'] / 1e9:.2f}GB "
              f"coll={report['collective_bytes'] / 1e9:.3f}GB "
              f"peak_mem={report['peak_bytes'] / 1e9:.2f}GB "
              f"(arguments {report['argument_bytes'] / 1e9:.2f}GB)")
        if report["collective_breakdown"]:
            print("  collectives: " + ", ".join(
                f"{k} {v / 1e9:.4f}GB"
                for k, v in report["collective_breakdown"].items()))
    return report


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", type=str, default=None)
    p.add_argument("--shape", type=str, default=None)
    p.add_argument("--all", action="store_true")
    p.add_argument("--single-pod", action="store_true")
    p.add_argument("--multi-pod", action="store_true")
    p.add_argument("--both-meshes", action="store_true")
    p.add_argument("--out", type=str, default="runs/dryrun_torch")
    args = p.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    if args.all:
        cells = [(aid, s) for aid in list_archs()
                 for s in get_arch(aid).shapes
                 if s not in get_arch(aid).skip_shapes]
    else:
        if not args.arch or not args.shape:
            p.error("--arch and --shape required (or --all)")
        cells = [(args.arch, args.shape)]

    meshes = [None]                   # one chip
    if args.both_meshes:
        meshes = [False, True]
    elif args.single_pod or args.multi_pod:
        meshes = [False] * args.single_pod + [True] * args.multi_pod
    t0 = time.perf_counter()
    failures, not_ported = [], []
    for (aid, s), mp in ((c, m) for c in cells for m in meshes):
        tag = f"{aid}_{s}_{'1' if mp is None else '512' if mp else '256'}"
        try:
            rep = dryrun_cell(aid, s, multi_pod=mp)
            with open(os.path.join(args.out, tag + ".json"), "w") as f:
                json.dump(rep, f, indent=1)
        except NotImplementedError as e:
            # the card refuses the step the same way (blocks not ported)
            not_ported.append((tag, str(e)))
        except Exception as e:
            traceback.print_exc()
            failures.append((tag, str(e)))
    for tag, err in not_ported:
        print(f"NOT PORTED {tag}: {err[:200]}")
    if failures:
        print(f"\nFAILED {len(failures)} cells:")
        for tag, err in failures:
            print(f"  {tag}: {err[:200]}")
        sys.exit(1)
    print(f"\nOK: {len(cells) * len(meshes) - len(not_ported)} cells "
          f"({len(not_ported)} not ported) in "
          f"{time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
