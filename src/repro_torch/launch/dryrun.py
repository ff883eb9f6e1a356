"""Dry run of the port (twin of ``repro.launch.dryrun``): for every
(architecture x input-shape) cell, trace the step once on ``meta`` tensors,
which hold no data, and count its FLOPs, bytes and peak memory
(``core.cost.analysis``), the hand-written kernels' shares included.
Nothing is allocated and nothing runs on any device.  Writes one JSON
artifact a cell with the reference's keys: one chip, no collectives, and
``trace_seconds`` in place of ``lower_seconds`` and ``compile_seconds``.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b \\
        --shape decode_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--out DIR]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
from typing import Dict, Optional

import torch

from repro_torch.core.config import (LM_SHAPES, ModelConfig, OptimizerConfig,
                                     ShapeConfig, get_arch, list_archs)
from repro_torch.core.cost.analysis import analyze_step
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
              opt_cfg: Optional[OptimizerConfig] = None) -> tuple:
    """The step's arguments for ``shape.mode`` on ``device``: (params,
    opt_state, batch), (params, batch) or (params, state, tokens, pos)."""
    params = empty_like_specs(api.param_shapes(cfg), device)
    inputs = empty_like_specs(api.input_specs(cfg, shape), device)
    if shape.mode == "train":
        return params, adamw.init_opt_state(params, opt_cfg
                                            or OptimizerConfig()), inputs
    if shape.mode == "prefill":
        return params, inputs
    return params, inputs["state"], inputs["tokens"], inputs["pos"]


def count_cell(cfg: ModelConfig, shape: ShapeConfig, remat: str = "full",
               device="meta") -> Dict:
    """``analyze_step``'s report of one step of ``shape`` on ``device``:
    ``meta`` for the dry run; a test passes fake CPU tensors' device under
    ``FakeTensorMode`` to count the plain versions instead."""
    opt_cfg = OptimizerConfig()
    step_fn = steps_lib.step_for_shape(cfg, shape, opt_cfg, remat=remat)
    return analyze_step(step_fn, *step_args(cfg, shape, device, opt_cfg))


def dryrun_cell(arch_id: str, shape_name: str, remat: str = "full",
                verbose: bool = True) -> Dict:
    """Count one cell on ``meta``; returns the roofline artifact dict.

    Baseline remat='full', as the reference's: recompute each period in the
    backward."""
    spec = get_arch(arch_id)
    cfg = spec.model
    shape = LM_SHAPES[shape_name]
    report = count_cell(cfg, shape, remat=remat)
    report.update({
        "arch": arch_id, "shape": shape_name, "mesh": "1", "chips": 1,
        "multi_pod": False, "seq_parallel": False, "remat": remat,
        "model_flops": api.model_flops(cfg, shape),
        "param_count": api.param_count(cfg),
        "active_param_count": api.param_count(cfg, active_only=True),
    })
    if verbose:
        print(f"[{arch_id} | {shape_name} | one chip]")
        print(f"  trace {report['trace_seconds']:.1f}s")
        print(f"  per-device: flops={report['flops']:.3e} "
              f"hbm={report['hbm_bytes'] / 1e9:.2f}GB "
              f"peak_mem={report['peak_bytes'] / 1e9:.2f}GB "
              f"(arguments {report['argument_bytes'] / 1e9:.2f}GB)")
    return report


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", type=str, default=None)
    p.add_argument("--shape", type=str, default=None)
    p.add_argument("--all", action="store_true")
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

    t0 = time.perf_counter()
    failures, not_ported = [], []
    for aid, s in cells:
        tag = f"{aid}_{s}_1"
        try:
            rep = dryrun_cell(aid, s)
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
    print(f"\nOK: {len(cells) - len(not_ported)} cells "
          f"({len(not_ported)} not ported) in "
          f"{time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
