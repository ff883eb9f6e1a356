"""The reference walker's per-device count of a sharded smoke step, in a
process of its own: ``XLA_FLAGS`` must give JAX its CPU devices before
JAX starts, which the test process cannot do.  Steps are f32 (the walker
reads bf16 payloads on the CPU as f32) at the parity harness's sizes.

    python tests/_torch_mesh_walker.py qwen1.5-0.5b:train:2x2 ...

prints one JSON object, {"arch:mode:mesh": {"flops", "collective_breakdown"}}.
A hybrid arch's selective scan, and an RWKV arch's WKV scan, are stood in
for by elementwise functions.
"""
import json
import os
import sys

if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                               " --xla_force_host_platform_device_count=4"
                               ).strip()
    os.environ["JAX_PLATFORMS"] = "cpu"

import dataclasses  # noqa: E402

B = 4
SEQ = {"train": 32, "prefill": 64, "decode": 16}


def walker_count(arch: str, mode: str, dims) -> dict:
    import jax
    import numpy as np
    from jax.sharding import Mesh

    from repro.core.config import OptimizerConfig, ShapeConfig, get_arch
    from repro.core.hlo.analysis import analyze_compiled
    from repro.launch import mesh as mesh_lib
    from repro.launch import steps as steps_lib
    from repro.models import api
    from repro.optim import adamw
    from repro.sharding import activation_rules

    cfg = dataclasses.replace(get_arch(arch).smoke, param_dtype="float32",
                              compute_dtype="float32")
    if cfg.family == "hybrid":
        # the selective scan, whose chunked dots the port's K3 counts by
        # its own formula, stood in for by an elementwise function of the
        # same inputs (as tests/_torch_dryrun_parity.py does on one chip)
        from _torch_dryrun_parity import _jax_selective
        from repro.models import ssm
        ssm.selective_scan_chunked = _jax_selective
    if cfg.family == "ssm":
        # the WKV scan likewise (a decode step computes it inline)
        from _torch_dryrun_parity import _jax_wkv
        from repro.models import rwkv6
        rwkv6.wkv_chunked = _jax_wkv
    shape = ShapeConfig("parity", SEQ[mode], B, mode)
    mesh = Mesh(np.asarray(jax.devices()[:dims[0] * dims[1]]).reshape(dims),
                ("data", "model"))
    sp = mode == "decode"
    ps, ins = api.param_shapes(cfg), api.input_specs(cfg, shape)
    with activation_rules(mesh, seq_parallel=sp):
        if mode == "train":
            opt = OptimizerConfig()
            opt_shapes = jax.eval_shape(lambda: adamw.init_opt_state(
                jax.tree.map(lambda s: jax.ShapeDtypeStruct(s.shape, s.dtype),
                             ps), opt))
            sh = mesh_lib.shardings_for(cfg, shape, mesh, ps, opt_shapes, ins,
                                        seq_parallel=sp)
            fn, _ = steps_lib.step_for_shape(cfg, shape, opt, remat="none")
            lowered = jax.jit(fn, in_shardings=(
                sh["params"], sh["opt_state"], sh["batch"])).lower(
                    ps, opt_shapes, ins)
        elif mode == "prefill":
            sh = mesh_lib.shardings_for(cfg, shape, mesh, ps, None, ins)
            fn, _ = steps_lib.step_for_shape(cfg, shape)
            lowered = jax.jit(fn, in_shardings=(sh["params"], sh["batch"])
                              ).lower(ps, ins)
        else:
            sh = mesh_lib.shardings_for(cfg, shape, mesh, ps, None, ins,
                                        seq_parallel=sp)
            fn, _ = steps_lib.step_for_shape(cfg, shape)
            lowered = jax.jit(fn, in_shardings=(
                sh["params"], sh["state"], sh["tokens"], sh["pos"])).lower(
                    ps, ins["state"], ins["tokens"], ins["pos"])
    rep = analyze_compiled(lowered.compile())
    return {"flops": int(rep["flops"]),
            "collective_breakdown": rep["collective_breakdown"]}


if __name__ == "__main__":
    out = {}
    for cell in sys.argv[1:]:
        arch, mode, mesh = cell.split(":")
        out[cell] = walker_count(arch, mode,
                                 tuple(int(d) for d in mesh.split("x")))
    print(json.dumps(out))
