"""End-to-end trainer (PyTorch twin of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
        --steps 30 --batch 4 --seq 512                 # on the card
    PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-1.6b \\
        --steps 20 --batch 4 --seq 512                 # on the card
    PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-1.6b \\
        --smoke --device cpu                           # plain versions, CPU

Wires together: config registry -> synthetic data pipeline (prefetching) ->
train step (loss, ``torch.autograd.grad``, AdamW, in place) -> checkpoint
manager (async, atomic, auto-resume) -> supervisor heartbeats.  ``--smoke``
selects the reduced config; a caller of :func:`main` may pass a config of
its own (a cut of a registered one, such as jamba's ``TRAIN_CARD``).  One
device: there is no mesh and no activation sharding rules yet (ROADMAP.md,
Queue 1 item 14).  The decoder-only text families train, the recurrent ones
(RWKV-6, the Mamba hybrid) included; a VLM prefix and the audio / enc-dec
batches are not ported (``NotImplementedError``).  On the card the
attention of a training step runs through the flash-attention kernel and
its backward kernel, the WKV and selective scans through theirs.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.config import OptimizerConfig, get_arch
from repro_torch.core.device import resolve_device
from repro_torch.data.pipeline import (DataConfig, PrefetchIterator,
                                       SyntheticTokenPipeline)
from repro_torch.launch import steps as steps_lib
from repro_torch.models import api
from repro_torch.optim import adamw
from repro_torch.runtime.supervisor import Supervisor


def main(argv=None, cfg=None):
    """Train ``--arch`` (``--smoke``: its reduced config) or, if given, the
    ModelConfig ``cfg``, which ``--arch`` must name and which takes no
    ``--smoke`` (``--dtype`` still sets its param and compute dtypes).
    Returns the loss of every step."""
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True)
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--warmup", type=int, default=20)
    p.add_argument("--remat", default="none",
                   choices=["none", "dots", "full"])
    p.add_argument("--grad-compression", default="none",
                   choices=["none", "int8_ef"])
    p.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                      "repro_torch_ckpt"))
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--dtype", default="float32",
                   help="param/compute dtype")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    if cfg is None:
        spec = get_arch(args.arch)
        cfg = spec.smoke if args.smoke else spec.model
    elif args.smoke or cfg.name != args.arch:
        raise ValueError(f"train: the config given is {cfg.name!r}; --arch "
                         f"must name it (got {args.arch!r}) and --smoke, "
                         "which picks another config, is not taken with it")
    cfg = dataclasses.replace(cfg, param_dtype=args.dtype,
                              compute_dtype=args.dtype)
    if cfg.family == "vlm":
        raise NotImplementedError("VLM prefixes are not ported yet "
                                  "(ROADMAP.md, Queue 1 item 12)")
    if cfg.family in ("audio", "encdec"):
        raise NotImplementedError("enc-dec training is not ported yet "
                                  "(ROADMAP.md, Queue 1 item 12)")
    opt_cfg = OptimizerConfig(lr=args.lr, warmup_steps=args.warmup,
                              total_steps=args.steps,
                              grad_compression=args.grad_compression)

    device = resolve_device(args.device)
    print(f"device={device} arch={cfg.name} "
          f"params≈{api.param_count(cfg):,}")

    gen = torch.Generator(device=device).manual_seed(0)
    params = api.init_params(gen, cfg)
    opt_state = adamw.init_opt_state(params, opt_cfg)
    step_fn = steps_lib.make_train_step(cfg, opt_cfg, remat=args.remat)

    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                          global_batch=args.batch)
    pipeline = SyntheticTokenPipeline(data_cfg)
    ckpt = CheckpointManager(args.ckpt_dir)
    start_step = 0
    if args.resume and ckpt.latest_step() is not None:
        start_step, state = ckpt.restore(device=device)
        params, opt_state = state["params"], state["opt_state"]
        print(f"resumed from step {start_step}")

    sup = Supervisor(num_workers=1)
    prefetch = PrefetchIterator(pipeline, start_step=start_step)
    losses = []
    t_start = time.perf_counter()
    try:
        for _ in range(start_step, args.steps):
            step_i, host_batch = next(prefetch)
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in host_batch.items()}
            t0 = time.perf_counter()
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            sup.heartbeat(0, step_i, dt)
            losses.append(loss)
            if (step_i + 1) % args.log_every == 0:
                print(f"step {step_i + 1:5d}  loss {loss:8.4f}  "
                      f"gnorm {float(metrics['grad_norm']):7.3f}  "
                      f"lr {float(metrics['lr']):.2e}  {dt * 1e3:7.1f} ms")
            if (step_i + 1) % args.ckpt_every == 0:
                ckpt.save(step_i + 1,
                          {"params": params, "opt_state": opt_state})
    finally:
        prefetch.close()
        ckpt.wait()
    wall = time.perf_counter() - t_start
    if losses:
        print(f"done: {args.steps - start_step} steps in {wall:.1f}s; "
              f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    ckpt.save(args.steps, {"params": params, "opt_state": opt_state})
    ckpt.wait()
    return losses


if __name__ == "__main__":
    main()
