"""Roofline harness of the port (twin of ``repro.launch.perf``): count one
(arch x shape) cell on ``meta`` tensors (``launch/dryrun.py``) and turn the
count into the three roofline terms at one NVIDIA H100's rates
(``core.hw.h100_sxm``), with the top contributors by op and by kernel.
Appends each result to ``<out_dir>/<arch>_<shape>.jsonl``.

    PYTHONPATH=src python -m repro_torch.launch.perf --arch qwen1.5-0.5b \\
        --shape decode_32k --tag baseline
    PYTHONPATH=src python -m repro_torch.launch.perf --arch qwen2.5-14b \\
        --shape decode_32k --single-pod [--seq-parallel 0]
    PYTHONPATH=src python -m repro_torch.launch.perf \\
        --arch granite-moe-1b-a400m --shape train_4k --single-pod \\
        --capacity-factor 2.0

``--single-pod`` (16 x 16) or ``--multi-pod`` (2 x 16 x 16) counts the
cell as rank 0 of a production mesh (``launch.dryrun.count_on_mesh``),
``seq_parallel`` defaulting to decode's: the terms are per
device, the collective term from the counted collective bytes, and
``useful_flops`` is the step's over the mesh's ranks.  Sequence-parallel
train or prefill is not ported (``NotImplementedError``).
``--capacity-factor`` replaces an MoE config's (``<= 0``: dropless), as
the reference's harness does.

The plan's dtype is the model's compute dtype: the port runs an f32 model's
products on the CUDA cores and a bf16 model's on the tensor cores.  The
useful work that ``useful_ratio`` and ``roofline_fraction`` divide is
:func:`useful_flops`, the products the step runs, not ``api.model_flops``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
from typing import Optional

from repro_torch.core.config import LM_SHAPES, get_arch
from repro_torch.core.cost.analysis import top_contributors
from repro_torch.core.estimator.roofline import CompilePlan, roofline_terms
from repro_torch.core.hw import h100_sxm
from repro_torch.launch.dryrun import count_cell, count_on_mesh
from repro_torch.models import api

OUT_DIR = "runs/perf_torch"


def _product_params(cfg, skip=()) -> int:
    """Active params that a token's matrix products read: linear weights
    (leaves named ``w``, the router and an untied output head among them),
    the expert banks (top-k of E active, as ``api.param_count``) and RWKV's
    LoRA factors; not the embedding table (a lookup), norms, biases, decay
    and mixing vectors or convolution taps, nor leaves whose path holds one
    of ``skip``."""
    def walk(tree, path):
        if isinstance(tree, dict):
            return sum(walk(v, f"{path}/{k}") for k, v in tree.items())
        if any(part in path for part in skip):
            return 0
        n = math.prod(tree.shape)
        if "ffn_moe/w_" in path:
            return n * cfg.moe.num_experts_per_tok // cfg.moe.num_experts
        name = path.rsplit("/", 1)[1]
        return n if name == "w" or "lora" in name else 0

    return walk(api.param_shapes(cfg), "")


def useful_flops(cfg, shape) -> float:
    """The matrix products one step of ``shape`` needs, the numerator of
    ``useful_ratio`` and ``roofline_fraction``: 2 W a token (6 W in
    training, forward and backward), W being the weights of the stack's
    products (:func:`_product_params`, the output head left out), plus the
    head's 2 d V for each position that gets logits: every token in
    training, one a row in prefill and decode.  An encoder-decoder's decode
    step runs the decoder alone, its cross-attention reading the encoder's
    K and V from the cache.  ``api.model_flops`` (the
    reference's 2 N or 6 N a token, N every active param) also counts the
    embedding table, the norms and the head at every position, more than a
    prefill runs: divided by a count of the step it read up to 1.44 of the
    roofline.  NaN for a convnet, as ``api.model_flops``."""
    model = api.model_flops(cfg, shape)
    if cfg.family == "convnet":
        return model
    per = 6 if shape.mode == "train" else 2
    tokens = round(model / (per * api.param_count(cfg, active_only=True)))
    head = cfg.vocab_size * cfg.d_model
    skip = ("/encoder/", "/cross/wk/", "/cross/wv/") \
        if cfg.encoder_layers and shape.mode == "decode" else ()
    body = _product_params(cfg, skip) - (0 if cfg.tie_embeddings else head)
    logits = tokens if shape.mode == "train" else shape.global_batch
    return float(per * (body * tokens + head * logits))


def roofline(rep: dict, cfg, useful: float, system=None) -> dict:
    """The roofline fields of a count ``rep`` of one step of ``cfg`` on one
    chip of ``system`` (the H100 by default), ``useful`` FLOPs of it the
    step's useful work on that chip (:func:`useful_flops`, over the ranks
    of a mesh)."""
    system = system or h100_sxm()
    plan = CompilePlan(dtype=cfg.compute_dtype)
    t_c, t_m, t_i = roofline_terms(rep["flops"], rep["hbm_bytes"],
                                   rep["collective_bytes"], system, plan)
    peak_flops = system.chip.compute.flops_for(plan.dtype, matrix=True)
    bound = max(t_c, t_m, t_i)
    return {
        "t_compute_ms": t_c * 1e3, "t_memory_ms": t_m * 1e3,
        "t_collective_ms": t_i * 1e3, "bound_ms": bound * 1e3,
        "dominant": max(("compute", t_c), ("memory", t_m),
                        ("collective", t_i), key=lambda kv: kv[1])[0],
        "useful_ratio": useful / max(rep["flops"], 1),
        "peak_bytes_gb": rep.get("peak_bytes", 0) / 1e9,
        "roofline_fraction": (useful / peak_flops) / bound
        if bound > 0 else float("nan"),
    }


def run_cell(arch_id: str, shape_name: str, *, remat: str = "full",
             tag: str = "baseline", show_top: int = 8,
             out_dir: str = OUT_DIR, multi_pod: Optional[bool] = None,
             seq_parallel: Optional[bool] = None,
             capacity_factor: Optional[float] = None) -> dict:
    """One cell: one chip when ``multi_pod`` is None, else rank 0 of the
    single-pod (False) or multi-pod (True) mesh, ``seq_parallel``
    defaulting to decode's; ``capacity_factor``, if given, replaces an MoE
    config's."""
    cfg = get_arch(arch_id).model
    if capacity_factor is not None and cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
    shape = LM_SHAPES[shape_name]
    t0 = time.perf_counter()
    if multi_pod is None:
        rep = count_cell(cfg, shape, remat=remat)
        rep.update(mesh="1", chips=1, seq_parallel=False)
    else:
        rep = count_on_mesh(cfg, shape, multi_pod, seq_parallel, remat)
    wall = time.perf_counter() - t0
    out = {"tag": tag, "arch": arch_id, "shape": shape_name,
           "mesh": rep["mesh"], "chips": rep["chips"], "remat": remat,
           "seq_parallel": rep["seq_parallel"],
           "capacity_factor": cfg.moe.capacity_factor if cfg.moe else None,
           "model_flops": api.model_flops(cfg, shape), "flops": rep["flops"],
           "useful_flops": useful_flops(cfg, shape) / rep["chips"]}
    out.update(roofline(rep, cfg, out["useful_flops"]))
    out["trace_s"] = wall
    out["collective_breakdown"] = rep["collective_breakdown"]
    print(f"[{tag}] {arch_id}/{shape_name}  "
          f"t_comp={out['t_compute_ms']:.1f}ms  "
          f"t_mem={out['t_memory_ms']:.1f}ms  "
          f"t_coll={out['t_collective_ms']:.1f}ms  "
          f"bound={out['dominant']}  "
          f"roofline={out['roofline_fraction']:.1%} "
          f"peak_mem={out['peak_bytes_gb']:.1f}GB")
    if show_top:
        print("  top HBM contributors (per device, all calls):")
        for val, count, name in top_contributors(rep, show_top, "bytes"):
            print(f"    {val / 1e9:9.2f}GB x{count:5d} {name}")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{arch_id}_{shape_name}.jsonl"),
              "a") as f:
        f.write(json.dumps(out) + "\n")
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True)
    p.add_argument("--shape", required=True)
    p.add_argument("--tag", default="baseline")
    p.add_argument("--remat", default="full")
    p.add_argument("--out", default=OUT_DIR)
    mesh = p.add_mutually_exclusive_group()
    mesh.add_argument("--single-pod", action="store_true")
    mesh.add_argument("--multi-pod", action="store_true")
    p.add_argument("--seq-parallel", type=int, default=-1)
    p.add_argument("--capacity-factor", type=float, default=None)
    args = p.parse_args(argv)
    run_cell(args.arch, args.shape, remat=args.remat, tag=args.tag,
             out_dir=args.out,
             multi_pod=True if args.multi_pod else False if args.single_pod
             else None,
             seq_parallel=None if args.seq_parallel < 0
             else bool(args.seq_parallel),
             capacity_factor=args.capacity_factor)


if __name__ == "__main__":
    main()
