#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
Hopper card.

    python3 chip_smoke.py [--out results.json]

Phases, in order; any failed check ends the run with a non-zero exit:

1. build the CUDA kernels from ``src/repro_torch/csrc`` with nvcc (sm_90a);
2. hold each kernel against its plain PyTorch version on the card, in f32
   and bf16, at the main paths' shapes, and time the kernel, the plain
   version and, where there is one, a PyTorch library call that computes
   the same function: device time (each timed batch waits behind
   ``torch.cuda._sleep`` until the host has enqueued it) and, as ``wall_ms``,
   the time through the wrapper; the WKV scan also at many chunks (S up to
   4096), a ragged last chunk and both decay extremes, the selective scan
   at a 2048-token prompt and in place at the decode step; the flash-
   attention backward (fed the forward kernel's output and row log-sum-
   exps) against the plain backward and against autograd over the plain
   forward, bit-equal to itself and to the autograd path, at qwen's
   training shape in f32 and bf16 (its CUDA-core route timed beside the
   tensor cores), a GQA group of 2 at hd 128, a query offset, the ragged
   and small shapes of the CPU tests, jamba's attention and two head dims
   only the CUDA cores take; the WKV and selective scans' backwards (fed
   the forward kernels' kept states) against their plain backwards and
   autograd over their plain forwards, bit-equal to themselves and to the
   autograd path, at rwkv6's training shape (f32 and bf16, both decay
   extremes held to f64) and jamba's (u, B, C in bf16 and f32, a ragged
   last checkpoint interval); deepseek-v2's absorbed MLA decode (128
   heads, latent 512, rope 64) at B 1 and 4 over caches of 512, 4096 and
   32768 positions, ragged lengths, the served step's 4 slots in a cache
   of 128, the profiled 32k cache and the same keys in rows of one length
   (the split's balance), and a smoke-like shape (bf16 held elementwise
   and by relative RMS against the plain version's own rounding; the
   route, tensor cores or CUDA cores, and the µs of each launch beside
   each row), and flash attention at
   MLA's expanded shape (hd 192, hd_v 128, 128 heads) and at the smoke's
   (24, 16), each beside SDPA on the same function and the list of SDPA's
   backends that take it; and K2's backward at those widths: (192, 128)
   with 128 heads in bf16 (wgmma, the two-warpgroup dK/dV kernel) and f32
   (CUDA cores) at deepseek TRAIN_CARD's step (B 2, S 512), a ragged S 221
   and 64 queries over 300 keys, bf16 over 2 heads of 300 (the dK/dV walk
   split), and (24, 16) in f32 (3xTF32) and bf16 at 40 and 40 over 70;
3. serve 8 requests with the port's ``BatchedServer`` on qwen1.5-0.5b at
   full width (24 layers, d_model 1024, vocab 151,936, f32, random weights
   from a seed): every decode step must go through the decode kernel;
4. check that two requests decoded in one batch at different depths give
   the logits each gives alone;
5. prefill 4 prompts of 256 tokens through the flash-attention kernel and
   check the last logits and the cache against the decode path fed the
   same prompts;
   then train: (a) one train step of qwen1.5-0.5b cut to 2 layers at full
   width on the card, and the same step's loss and clipped gradient on the
   CPU, from the same params and batch (loss, grad norm, every gradient,
   and the params after the step against the CPU's AdamW on the card's
   gradient), and the same step under remat "dots" and "full"; (b) qwen1.5-0.5b at full width and depth in f32, batch 4 x
   512, 20 steps through ``launch/train.py``'s ``main`` with a checkpoint:
   the loss must fall, every step runs the flash-attention kernel and its
   backward once per layer, one step is profiled; (b2) the same in bf16
   (``--dtype bfloat16``), two steps and one profiled, the loss finite;
   (c) rwkv6 and jamba smoke in f32: the loss and every gradient on the
   card equal the CPU's, under remat "none", "dots" and "full", and
   flash-decode still refuses grad mode; (c2) one train step of rwkv6-1.6b
   cut to 2 layers at full width on the card and on the CPU, and the same
   step under remat "dots" and "full", and (c3) jamba's Mamba mixer at full width, every gradient
   within 2e-3 of the leaf's largest; (d) rwkv6-1.6b at full width, its
   first 12 of 24 layers, in f32, batch 4 x 512, 20 steps through
   ``main`` (the WKV scan
   and its backward once per layer a step; the loss must fall); (e)
   jamba-1.5-large-398b cut to its first layer (``TRAIN_CARD``: Mamba
   mixer and dense FFN at every published width) in bf16, batch 2 x 512,
   20 steps (the selective scan and its backward once a step; the loss
   finite and falling); (f) deepseek-v2 smoke in f32: the loss and every
   gradient on the card equal the CPU's under remat "none", "dots" and
   "full" (K2 and its backward at (24, 16)); (g) deepseek-v2 cut to its
   first layer (``TRAIN_CARD``: MLA and the dense FFN at every published
   width) in f32, one step of B 1 x 256 on the card and on the CPU (K2 and
   its backward at (192, 128) on the CUDA cores); (h) ``TRAIN_CARD`` in
   bf16 through ``main`` at lr 1e-4, B 2 x 512, 20 steps (K2 and its
   backward once a step on wgmma; the loss finite and falling; one step
   profiled, and the head's device ms at that shape), and the step counted
   by the dry run against the card (phase 13);
6. serve the same traffic on rwkv6-1.6b at full width (24 layers, d_model
   2048, vocab 65,536, f32, random weights from a seed): every admission
   prefills its prompt through the WKV scan kernel, once per layer;
7. on rwkv6-1.6b, check (a) prefill against token-by-token decode (last
   logits and the whole recurrent state) and (b) that each request served
   in a 2-slot batch gets, at every step, the logits it gets alone;
8. serve the same traffic on jamba-1.5-large-398b cut to its first 5 layers
   at full width (d_model 8192, Mamba d_inner 16384, 16 experts top-2 of
   d_ff 24,576, GQA 64/8 heads of 128, vocab 65,536, bf16 as the config
   declares, about 24 B random parameters from a seed): every admission
   prefills its prompt through the selective-scan kernel (4 Mamba layers)
   and flash attention (1 layer), and every decode step runs the scan
   kernel in each Mamba layer and flash-decode in the attention layer;
9. on that model, check prefill against token-by-token decode (a) with the
   products in f32 from the same weights, at the f32 tolerance, and (b) in
   bf16 as served, against the bf16 prefill's own distance from the f32
   one; and (c) that each request served in a 2-slot batch gets the
   logits it gets alone;
10. run DilatedVGG, the paper's network (``FULL``: 1024 x 2048, every
   published width, bf16, random weights from a seed), batch 1, through
   ``api.forward``: the forward's device ms and each layer's by its config
   name, beside their bounds, and one profiled forward's idle share; its
   bf16 logits against its f32 ones (2e-2 relative RMS); f32 on the card
   against the CPU at 128 x 256 (2e-3); three bf16 train steps through
   ``launch/steps.make_train_step`` (the loss finite) and one f32 step at
   128 x 256 against the CPU's (loss, every gradient, the params after
   it).  No kernel of the port is on this path: cuDNN convolves;
11. serve 8 requests (prompts of 16-64 tokens, 32 new tokens each, 4
   slots) on deepseek-v2-236b cut to its first 4 layers at full width
   (``CARD``: MLA with 128 heads over a 512-wide latent, a dense prefix
   layer and 3 MoE layers of 160 experts top-6, vocab 102,400, bf16, about
   13.3 B random parameters from a seed), admitted token by token: every
   decode call runs the MLA decode kernel in each layer and flash
   attention never; profile one decode step over the served cache and one
   over a 32,768-position cache of random latents, and time one MoE FFN;
   check prefill (flash attention at hd 192, hd_v 128) against
   token-by-token decode (dropless MoE) in bf16 against bf16's own
   rounding and, on the first 2 layers in f32, at 2e-3; and one MLA block
   (prefill, then 8 decode steps) at full width in f32 on the card against
   the CPU's plain versions at 2e-3;
12. internvl2-2b (a decoder behind 1,024 patch embeddings, 1.89 B params)
   and seamless-m4t-large-v2 (24 + 24 layers, cross-attention, 1.63 B
   params), each whole in bf16 from random weights: prefill 4 rows (1,024
   patches and 64 tokens; 1,024 frames and 16 tokens) through
   ``make_prefill_step`` (flash attention once a layer; the enc-dec's
   encoder, self- and cross-attention each once a layer), grow the self
   cache and take 32 greedy ``make_serve_step`` steps (flash-decode once a
   layer; the enc-dec's self- and cross-attention each once a layer);
   prefill and decode against one forward in bf16 against bf16's own
   rounding; the first 2 layers in f32 on the card against the CPU
   (forward, prefill, decode, one train step) at 2e-3; 3 bf16 steps of
   ``launch/train.py`` at half depth (12 layers; 12 + 12) (K2 and its
   backward as in the prefill).  Phase 2
   holds the kernels at these shapes too;
14. qwen2.5-14b whole (48 layers, GQA 40/8 heads of 128, QKV bias, vocab
   152,064, about 14.8 B params) and then mistral-large-123b cut to its
   first 16 layers (``CARD``: 96/8 heads of 128, d_ff 28,672, about 23 B
   params), each in bf16 from random weights: serve 4 requests (prompts
   of 16-64 tokens, 16 new tokens, 4 slots of 128 positions), admitted
   token by token (flash-decode once a layer a decode call, at GQA groups
   5 and 12); profile one decode step; check prefill (flash attention)
   against token-by-token decode in bf16 against bf16's own rounding and,
   for qwen2.5-14b on its first 2 layers in f32, at 2e-3; the first 2
   layers (mistral: 1) in f32 on the card against the CPU at 2e-3; and
   count qwen2.5-14b's decode step and a prefill of 4 x 128 by the dry run
   against the card (phase 13).  Phase 2 holds K1 and K2 at these shapes;
15. the mesh (``repro_torch.sharding``, ``launch/mesh.py``): (a) a real
   one-rank NCCL group (a ``HashStore``, no TCP) and a ("data", "model")
   mesh of (1, 1) on the card: qwen1.5-0.5b at full width and depth in
   f32, its params distributed by ``shardings_for``, prefills 4 x 128 and
   decodes 8 steps, then takes one train step at 2 x 256 in f32 and one
   with bf16 products (f32 params, AdamW at its full rate from step 1);
   each output equals the same call without a mesh (the tolerance
   printed), each param's move the same within lr / 100 in f32 (lr / 2
   with bf16 products), and K1, K2 and K2's backward launch as often; the
   host wall of a decode step with and without the mesh (DTensor's
   dispatch); granite-moe-1b-a400m whole in bf16, its experts on "model";
   jamba-1.5-large-398b ``CARD`` in bf16 (prefill 2 x 128, 8 decode steps;
   the mesh's DTensors over the same storage) and ``TRAIN_CARD`` in f32
   (one train step of 2 x 512 through K3's backward), its Mamba channels
   on "model", K1, K2, K3 and K3's backward counted; (b)
   K1's log-sum-exp against its plain version at phase 2's K1 shape and
   at qwen2.5-14b's (bf16, 40/8 heads of 128), and K1 over the cache cut
   along its keys into 2 and 16 shards (one holding no valid key), merged
   by log-sum-exp, against K1 over the whole cache; (c) qwen1.5-0.5b's
   and granite's decode_32k and jamba's long_500k counted as rank 0 of the
   (16, 16) mesh in a virtual group: per-device GFLOP, GB, collective GB
   by kind and ``t_collective``.

The last line is ``{"ok": true, "device": {...}}``; ``--out`` also writes
every number of the run to a JSON file.  The script needs a CUDA
card and the repository's ``src/`` beside it; it exits non-zero without
either.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# the port's kernels, by the name of their __global__ function (each is
# defined at the start of a line of src/repro_torch/csrc/*.cu), and the
# source (stem) that defines each
KERNEL_SOURCE = {
    name: src.stem
    for src in (ROOT / "src" / "repro_torch" / "csrc").glob("*.cu")
    for name in re.findall(r"^(\w+_kernel)\(", src.read_text(), re.M)}
PORT_KERNELS = set(KERNEL_SOURCE)
# tests/test_kernels.py's tolerances
TOL = {"float32": dict(atol=3e-5, rtol=0.0),
       "bfloat16": dict(atol=3e-2, rtol=1e-2)}
# mla_decode in bf16: TOL["bfloat16"]'s rtol with about a quarter of its
# atol.  The context is a softmax average of ~0.1-0.5 (RMS); on an H100 at
# phase 2's shapes no element passed 1e-2 |want| by more than 4.7e-3 (the
# served shape; the output's rounding, and P's at another running max), and
# 8e-3 holds about twice the typical row's (each row records its
# excess_over_rtol).  Besides, the relative RMS against the plain version
# stays within twice the plain version's own from the same function in f32
# (measured: 0.92-1.31 times it)
MLA_BF16_TOL = dict(atol=8e-3, rtol=1e-2)
MLA_BF16_RMS = 2.0
# the flash-attention backward: tests/test_kernels.py's atol with its rtol
# of 1e-2 in f32 too (a gradient sums products over every visible key)
BWD_TOL = {"float32": dict(atol=3e-5, rtol=1e-2),
           "bfloat16": dict(atol=3e-2, rtol=1e-2)}
# tests/test_kernels.py's tolerance for the WKV scan (out and state): all of
# its arithmetic is f32 whatever the dtype of r, k, v
K4_TOL = dict(atol=1e-3, rtol=0.0)
# tests/test_kernels.py's tolerance for the selective scan (y and h), f32
# arithmetic whatever the dtype of u, B, C
K3_TOL = dict(atol=1e-3, rtol=0.0)
# the scans' backwards: f32 gradients within K4_TOL's atol plus this share of
# the gradient's largest value (tests/test_torch_train_recurrent.py's
# emulation of K4's backward in f32 is up to 4.3e-6 of it off f64 at logw =
# -1e-6, where the sums reach 1e3-1e4)
SCAN_BWD_REL = 1e-5
# full-width consistency checks: prefill = decode at 2e-3 for a model
# computed in f32 (tests/test_models.py); the same function at another batch
# (ragged = solo, 2-slot server = solo) at 1e-4, in f32 or bf16
PREFILL_TOL = dict(atol=2e-3, rtol=2e-3)
SOLO_TOL = dict(atol=1e-4, rtol=0.0)
# the scans' plain versions step through the sequence one launch at a time
# (up to 0.6 s a call at phase 2's longest shapes): one warm-up and one
# timed call each, with and without the sleep
SCAN_PLAIN_REPS = (1, 1, 1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


T_START = time.perf_counter()
# host seconds spent in each kind of phase 2's cases, by function name
CASE_S: dict = {}


def section(title: str) -> None:
    """Print a phase's header with the seconds since the script started."""
    print(f"{title} [{time.perf_counter() - T_START:.1f} s]", flush=True)


def timed_case(fn):
    """``fn`` adding its seconds to ``CASE_S[fn.__name__]``."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            CASE_S[fn.__name__] = (CASE_S.get(fn.__name__, 0.0)
                                   + time.perf_counter() - t0)
    return run


@functools.lru_cache(maxsize=None)
def _cycles_per_ms(torch) -> float:
    """Device clock cycles per ms of ``torch.cuda._sleep``, read once."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(20_000_000)
    end.record()
    end.synchronize()
    return 20_000_000 / start.elapsed_time(end)


def time_ms(torch, fn, reps: int = 7, inner: int = 10,
            warmup: int = 3) -> tuple:
    """(device ms, wall ms) of one call: medians over ``reps`` of the mean
    of ``inner`` back-to-back calls, by CUDA events, after ``warmup`` calls.

    The device figure enqueues each batch behind ``torch.cuda._sleep`` long
    enough to cover the host's enqueue of the batch (twice the time the host
    took for one batch, plus 0.2 ms), so the events time the device's work
    alone.  The wall figure has no sleep: below ~0.05 ms a call it reads the
    host's time per call (checks, allocation, the launch); it is the only
    figure this script gave before it timed the device."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(inner):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    cycles = int((2 * host_ms + 0.2) * _cycles_per_ms(torch))
    out = []
    for sleep in (True, False):
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            if sleep:
                torch.cuda._sleep(cycles)
            start.record()
            for _ in range(inner):
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / inner)
        out.append(sorted(times)[len(times) // 2])
    return tuple(out)


def _timings(torch, kernel, plain, library, plain_reps=(7, 10)) -> dict:
    """Device and wall ms of the kernel, its plain version and the library
    call (None where there is none); ``plain_reps`` are ``time_ms``'s reps,
    inner calls and, optionally, warm-up calls for the plain version."""
    ms, wall = time_ms(torch, kernel)
    plain_ms, plain_wall = time_ms(torch, plain, *plain_reps)
    lib_ms, lib_wall = time_ms(torch, library) if library else (None, None)
    return dict(ms=ms, wall_ms=wall, plain_ms=plain_ms, plain_wall_ms=plain_wall,
                library_ms=lib_ms, library_wall_ms=lib_wall)


def launch_us(torch, fn, n: int = 20) -> dict:
    """Device µs per launch of each CUDA kernel that ``fn`` launches (by
    name and template arguments), by torch.profiler over ``n`` calls after
    warm-up, averaged over the launches it recorded."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return {key.split("::")[-1].split("(")[0]: us / count
            for key, (us, count) in device_kernels(prof).items()}


# record_function ranges of this script: the profiler also lists each as a
# device-side span, which is no kernel
RANGES = ("adamw_update",)


def device_kernels(prof) -> dict:
    """{kernel: (device µs, launches)} of each CUDA kernel that a
    torch.profiler run recorded with device time."""
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or 0
        if us > 0 and e.device_type.name == "CUDA" and e.key not in RANGES:
            out[e.key] = (us, e.count)
    return out


def range_kernels(prof, name: str):
    """(device µs, launches) of the device work inside the device-side span
    of record_function range ``name``, or None if the profiler kept no such
    span."""
    dev = [e for e in prof.events() if e.device_type.name == "CUDA"]
    span = [e.time_range for e in dev if e.name == name]
    if not span:
        return None
    t0, t1 = span[0].start, span[0].end
    inside = [e.time_range for e in dev if e.name not in RANGES
              and t0 <= e.time_range.start and e.time_range.end <= t1]
    return sum(r.end - r.start for r in inside), len(inside)


def _kernel_name(mangled: str) -> str:
    """A kernel's name and template arguments from its mangled symbol, e.g.
    ``wg_dkdv_kernel<64>``, ``dkdv_kernel<bf16,128>``."""
    rest = re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]+\d+", "", mangled)
    m = re.match(r"(\w+?_kernel)(?:I(.*?E)E|E)", rest)
    if not m:
        return rest.split("EEv")[0]
    args = [t[1] or ("bf16" if t[0].startswith("13") else "float")
            for t in re.finditer(r"13__nv_bfloat16|Li(\d+)E|f", m[2] or "")]
    return m[1] + (f"<{','.join(args)}>" if args else "")


def _ptxas_summary(log: str) -> list:
    """(kernel, "N registers, S bytes spill stores") per kernel that
    ``nvcc -Xptxas -v`` reported."""
    out, kernel, spill = [], None, ""
    for line in log.splitlines():
        if "Function properties for" in line:
            kernel = _kernel_name(line.rsplit(" ", 1)[-1])
        elif "spill stores" in line:
            spill = line.split(",")[1].strip()
        elif "registers" in line and kernel:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out.append((kernel, f"{regs} registers, {spill}"))
            kernel = None
    return out


def _tensor_core_ops(so: Path) -> dict:
    """{kernel: {op: [count, how many wait for their group's end (gsb0),
    first]}} of the tensor-core SASS instructions (HGMMA, HMMA) of each
    kernel of a built library, by cuobjdump.  Only a group's last HGMMA
    waits unless ptxas serialized the group."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    res = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                         text=True, timeout=300)
    check(res.returncode == 0, f"cuobjdump failed: {res.stderr.strip()}")
    out, kernel = {}, None
    for line in res.stdout.splitlines():
        if "Function :" in line:
            kernel = _kernel_name(line.split("Function :", 1)[1].strip())
            continue
        for op in ("HGMMA", "HMMA"):
            if f" {op}." in line and kernel:
                instr = line.split("*/", 1)[1].split(";")[0].strip()
                row = out.setdefault(kernel, {}).setdefault(op, [0, 0, instr])
                row[0] += 1
                row[1] += "gsb0" in instr
    return out


def gpu_name_and_power_limit() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def _excess(torch, got, want, tol):
    """(max abs error of ``got`` against ``want``, whether some element is
    non-finite or beyond atol + rtol * |want|)."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    bad = bool((err > tol["atol"] + tol["rtol"] * want.abs()).any()) \
        or not bool(torch.isfinite(got).all())
    return err.max().item(), bad


def _rel_rms(got, want) -> float:
    """||got - want|| / ||want|| over all elements, in f32."""
    got, want = got.float(), want.float()
    return ((got - want).norm() / want.norm().clamp_min(1e-30)).item()


def _within(torch, got, want, tol) -> float:
    """Max abs error of ``got`` against ``want`` (a kernel against its plain
    version, or two paths of a model); fails beyond atol + rtol * |want|."""
    err, bad = _excess(torch, got, want, tol)
    check(not bad, f"disagrees with its reference: max err {err} (atol "
          f"{tol['atol']}, rtol {tol['rtol']})")
    return err


@timed_case
def decode_case(torch, F, dops, B, Hq, Hkv, S, hd, kv_len, dtype, gen):
    """One flash-decode check + timings.  Returns the row for the table."""
    dt = getattr(torch, dtype)
    q = torch.randn(B, Hq, hd, device="cuda", generator=gen).to(dt)
    k = torch.randn(B, Hkv, S, hd, device="cuda", generator=gen).to(dt)
    v = torch.randn(B, Hkv, S, hd, device="cuda", generator=gen).to(dt)
    lens = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    got = dops.decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    err = _within(torch, got, dops.decode_attention_ref(q, k, v, lens),
                  TOL[dtype])

    mask = (torch.arange(S, device="cuda")[None, :] < lens[:, None])
    mask = mask[:, None, None, :]
    qs = q[:, :, None]

    def library():
        return F.scaled_dot_product_attention(qs, k, v, attn_mask=mask,
                                              enable_gqa=Hq != Hkv)

    # the kernel's cost formula at the keys kv_len covers
    flops, nbytes = dops.cost(q, k, v, lens,
                              keys=sum(min(max(n, 0), S) for n in kv_len))
    return dict(
        shape=f"B={B} Hq={Hq} Hkv={Hkv} S={S} hd={hd} kv_len={kv_len}",
        dtype=dtype, max_abs_err=err,
        **_timings(torch, lambda: dops.decode_attention(q, k, v, lens),
                   lambda: dops.decode_attention_ref(q, k, v, lens), library),
        **_bound(nbytes, flops, dtype))


def sdpa_backends(torch, library) -> dict:
    """Which of SDPA's backends take the call ``library`` makes: "ok", or
    the first line of the error with which one refused it."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    out = {}
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([backend]):
                library()
            torch.cuda.synchronize()
            out[backend.name] = "ok"
        except RuntimeError as e:
            out[backend.name] = "refused: " + str(e).strip().splitlines()[0][:120]
    return out


@timed_case
def flash_case(torch, F, fops, B, Hq, Hkv, Sq, Sk, hd, causal, q_offset,
               dtype, gen, hd_v=None):
    """One flash-attention check + timings; ``hd_v`` (V's and the output's
    width, MLA's 128 beside hd 192) defaults to hd."""
    hd_v = hd if hd_v is None else hd_v
    dt = getattr(torch, dtype)
    q = torch.randn(B, Hq, Sq, hd, device="cuda", generator=gen).to(dt)
    k = torch.randn(B, Hkv, Sk, hd, device="cuda", generator=gen).to(dt)
    v = torch.randn(B, Hkv, Sk, hd_v, device="cuda", generator=gen).to(dt)
    kw = dict(causal=causal, q_offset=q_offset)
    got = fops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    err = _within(torch, got, fops.attention_ref(q, k, v, **kw), TOL[dtype])

    q_pos = q_offset + torch.arange(Sq, device="cuda")
    k_pos = torch.arange(Sk, device="cuda")
    mask = (q_pos[:, None] >= k_pos[None, :]) if causal else None

    def library():
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                              enable_gqa=Hq != Hkv)

    def library_causal():   # SDPA's own causal path: the same function here
        return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                              enable_gqa=Hq != Hkv)

    # the kernel's cost formula at the visible (query, key) pairs
    flops, nbytes = fops.cost(q, k, v, pairs=visible_pairs(Sq, Sk, causal,
                                                            q_offset))
    row = dict(
        shape=(f"B={B} Hq={Hq} Hkv={Hkv} Sq={Sq} Sk={Sk} hd={hd} "
               + (f"hd_v={hd_v} " if hd_v != hd else "")
               + f"causal={causal} q_offset={q_offset}"),
        dtype=dtype, max_abs_err=err,
        **_timings(torch, lambda: fops.flash_attention(q, k, v, **kw),
                   lambda: fops.attention_ref(q, k, v, **kw), library),
        library_causal_ms=(time_ms(torch, library_causal)[0]
                           if causal and q_offset == 0 and Sq == Sk else None),
        **_bound(nbytes, flops, dtype))
    if hd_v != hd:
        row["sdpa"] = sdpa_backends(torch, library)
    return row


@timed_case
def mla_case(torch, F, mops, B, H, L, R, T, kv_len, dtype, gen):
    """One absorbed-MLA-decode check + timings.  The library call is SDPA on
    the same function: the heads as the query rows of one KV head, q =
    [q_abs | q_rope], k = [ckv | krope], v = ckv, the scale given and a
    boolean mask (the concatenations made before the timing)."""
    dt = getattr(torch, dtype)
    q_abs = torch.randn(B, H, L, device="cuda", generator=gen).to(dt)
    q_rope = torch.randn(B, H, R, device="cuda", generator=gen).to(dt)
    ckv = torch.randn(B, T, L, device="cuda", generator=gen).to(dt)
    krope = torch.randn(B, T, R, device="cuda", generator=gen).to(dt)
    lens = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    scale = 1.0 / math.sqrt(192)          # deepseek-v2: nope 128 + rope 64
    args = (q_abs, q_rope, ckv, krope, lens, scale)
    got = mops.mla_decode(*args)
    again = mops.mla_decode(*args)
    torch.cuda.synchronize()
    want = mops.mla_decode_ref(*args)
    tol = TOL[dtype] if dtype == "float32" else MLA_BF16_TOL
    err = _within(torch, got, want, tol)
    excess = ((got.float() - want.float()).abs()
              - tol["rtol"] * want.float().abs()).max().item()
    check(torch.equal(got, again), "mla_decode differs from itself")
    rms = {}
    if dtype != "float32":
        # the plain version's own bf16 rounding: its distance from the same
        # function on the inputs cast to f32 (P unrounded)
        want32 = mops.mla_decode_ref(*(a.float() if torch.is_tensor(a) and
                                       a.is_floating_point() else a
                                       for a in args))
        rms = dict(rel_rms=_rel_rms(got, want),
                   plain_vs_f32=_rel_rms(want, want32))
        check(rms["rel_rms"] <= MLA_BF16_RMS * rms["plain_vs_f32"],
              f"mla_decode: relative RMS {rms['rel_rms']:.3e} against the "
              f"plain version, beyond {MLA_BF16_RMS} x its own bf16 rounding "
              f"{rms['plain_vs_f32']:.3e}")

    q = torch.cat([q_abs, q_rope], dim=-1)[:, None]          # (B, 1, H, L+R)
    k = torch.cat([ckv, krope], dim=-1)[:, None]             # (B, 1, T, L+R)
    v = ckv[:, None]
    mask = (torch.arange(T, device="cuda")[None, :] < lens[:, None])
    mask = mask[:, None, None, :]

    def library():
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                              scale=scale)

    # the kernel's cost formula at the keys kv_len covers
    flops, nbytes = mops.cost(*args[:5],
                              keys=sum(min(max(n, 0), T) for n in kv_len))
    big = B * T >= 4 * 32768
    # the bound takes the card's peak for the inputs' type (bf16 on the
    # tensor cores); a route that multiplies on the CUDA cores in f32 has
    # their bound beside it
    route = mops.route(dt, L, R)
    rate = ("bfloat16 tensor cores (wgmma)" if route == "wgmma"
            else "float32 FMA")
    cores = ({} if route == "wgmma" else dict(bound_cuda_cores_ms=_bound(
        nbytes, flops, "float32")["bound_ms"]))
    return dict(
        shape=f"B={B} H={H} L={L} R={R} T={T} kv_len={kv_len}",
        dtype=dtype, max_abs_err=err, excess_over_rtol=excess, **rms,
        **_timings(torch, lambda: mops.mla_decode(*args),
                   lambda: mops.mla_decode_ref(*args), library,
                   plain_reps=(3, 3) if big else (7, 10)),
        sdpa=sdpa_backends(torch, library),
        launch_us=launch_us(torch, lambda: mops.mla_decode(*args)),
        blocks=mops.grid_blocks(B, H, T, torch.cuda.get_device_properties(
            0).multi_processor_count, *mops.ROUTES[route]),
        route=route, rate=rate, **cores, **_bound(nbytes, flops, dtype))


@timed_case
def flash_bwd_case(torch, F, fops, bops, B, Hq, Hkv, Sq, Sk, hd, causal,
                   q_offset, dtype, gen, compare=False, profile=False,
                   hd_v=None, via=None):
    """One check of the flash-attention backward kernel + timings.  The
    forward kernel's row log-sum-exps are held to the plain version's; the
    backward kernel, fed the forward kernel's output and lse, to the plain
    backward fed the same, and to autograd over the plain forward; the
    autograd path (``flash_attention`` under grad) and a second call must
    give the kernel's gradients bit for bit.  ``compare``: the CUDA-core
    route too, checked and timed beside the tensor-core one; ``profile``:
    each launch timed by the profiler (``launch_us``).  The bound takes the
    rate of the arithmetic the route runs (bf16 wgmma, 3xTF32 or f32 FMA).
    ``hd_v`` (V's, the output's and dO's width) defaults to hd; ``via``
    names the route the row expects its widths to take."""
    hd_v = hd if hd_v is None else hd_v
    dt = getattr(torch, dtype)
    q, k, v, do = (torch.randn(*shape, device="cuda", generator=gen).to(dt)
                   for shape in ((B, Hq, Sq, hd), (B, Hkv, Sk, hd),
                                 (B, Hkv, Sk, hd_v), (B, Hq, Sq, hd_v)))
    kw = dict(causal=causal, q_offset=q_offset)
    out, lse = fops.flash_attention_fwd(q, k, v, **kw)
    got = bops.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    lse_ref = fops.ref.attention_lse_ref(q, k, **kw)
    lse_err = _within(torch, lse, lse_ref, TOL["float32"] if dtype ==
                      "float32" else dict(atol=3e-2, rtol=0.0))
    want = fops.ref.attention_bwd_ref(q, k, v, out, lse, do, **kw)
    err = max(_within(torch, g, w, BWD_TOL[dtype]) for g, w in zip(got, want))
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    auto = torch.autograd.grad(fops.ref.attention_ref(*leaves, **kw), leaves,
                               do)
    err_auto = max(_within(torch, g, w, BWD_TOL[dtype])
                   for g, w in zip(got, auto))
    path = torch.autograd.grad(fops.flash_attention(*leaves, **kw), leaves, do)
    check(all(torch.equal(g, p) for g, p in zip(got, path)),
          "the autograd path's gradients differ from the kernel's")
    again = bops.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    check(all(torch.equal(g, a) for g, a in zip(got, again)),
          "two calls on the same inputs differ")
    route = bops.route(dt, hd, hd_v)
    check(via is None or route == via, f"the backward at {dtype} ({hd}, "
          f"{hd_v}) takes the {route}, not the {via}")

    lib_in = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    if causal and q_offset == 0 and Sq == Sk:
        lib_out = F.scaled_dot_product_attention(*lib_in, is_causal=True,
                                                 enable_gqa=Hq != Hkv)
    else:
        q_pos = q_offset + torch.arange(Sq, device="cuda")
        mask = q_pos[:, None] >= torch.arange(Sk, device="cuda")[None, :] \
            if causal else None
        lib_out = F.scaled_dot_product_attention(*lib_in, attn_mask=mask,
                                                 enable_gqa=Hq != Hkv)

    def library():   # SDPA's backward alone, on the same tensors
        return torch.autograd.grad(lib_out, lib_in, do, retain_graph=True)

    extra = {}
    if hd_v != hd:   # the SDPA backends whose forward and backward take it
        def sdpa_fwd_bwd():
            out = F.scaled_dot_product_attention(
                *lib_in, attn_mask=None if not causal else (
                    q_offset + torch.arange(Sq, device="cuda"))[:, None]
                >= torch.arange(Sk, device="cuda")[None, :],
                enable_gqa=Hq != Hkv)
            return torch.autograd.grad(out, lib_in, do)
        extra["sdpa"] = sdpa_backends(torch, sdpa_fwd_bwd)
    if compare and route == "tensor_cores":
        simt = functools.partial(bops.flash_attention_bwd, q, k, v, out, lse,
                                 do, **kw, via="cuda_cores")
        extra["cuda_cores_err"] = max(_within(torch, g, w, BWD_TOL[dtype])
                                      for g, w in zip(simt(), want))
        extra["cuda_cores_ms"] = time_ms(torch, simt)[0]
    if profile:
        extra["launch_us"] = launch_us(torch, lambda: bops.flash_attention_bwd(
            q, k, v, out, lse, do, **kw))

    # the kernel's cost formula at the visible (query, key) pairs: seven
    # products (S and dP in both passes, dV, dK, dQ); the gradient needs five
    # (S and dP once: 3 hd + 2 hd_v a pair), the bound's count
    pairs = visible_pairs(Sq, Sk, causal, q_offset)
    design = bops.cost(q, k, v, out, lse, do, pairs=pairs)
    flops, nbytes = 2 * B * Hq * pairs * (3 * hd + 2 * hd_v), design[1]
    rate = "float32" if route == "cuda_cores" else \
        "tf32x3" if dtype == "float32" else "bfloat16"
    return dict(
        shape=(f"B={B} Hq={Hq} Hkv={Hkv} Sq={Sq} Sk={Sk} hd={hd} "
               + (f"hd_v={hd_v} " if hd_v != hd else "")
               + f"causal={causal} q_offset={q_offset}"),
        dtype=dtype, route=route, rate=rate, max_abs_err=err,
        err_vs_autograd=err_auto, lse_err=lse_err, **extra,
        **_timings(torch,
                   lambda: bops.flash_attention_bwd(q, k, v, out, lse, do, **kw),
                   lambda: fops.ref.attention_bwd_ref(q, k, v, out, lse, do,
                                                      **kw), library),
        **_bound(nbytes, flops, rate, design))


def mla_bwd_rows(torch, F, fops, bops, gen) -> list:
    """K2's backward at MLA's widths.  (192, 128) with 128 heads: bf16 on
    wgmma (the two-warpgroup dK/dV kernel; its CUDA-core route timed beside)
    and f32 on the CUDA cores, at TRAIN_CARD's step (B 2, S 512, causal), a
    ragged prompt (S 221) and 64 queries over 300 keys at offset 236 (the dQ
    walk split over blocks); bf16 at B 1, 2 heads, S 300, where the dK/dV
    walk splits.  The smoke's (24, 16): f32 on 3xTF32 and bf16 on wgmma,
    at 40 queries and at 40 over 70 keys.  Each route is checked to be the
    one its widths take."""
    rows = []
    for dtype, via in (("bfloat16", "tensor_cores"), ("float32", "cuda_cores")):
        for B, Sq, Sk, off in ((2, 512, 512, 0), (1, 221, 221, 0),
                               (1, 64, 300, 236)):
            rows.append(flash_bwd_case(
                torch, F, fops, bops, B, 128, 128, Sq, Sk, 192, True, off,
                dtype, gen, compare=B == 2 and dtype == "bfloat16",
                profile=B == 2, hd_v=128, via=via))
    rows.append(flash_bwd_case(torch, F, fops, bops, 1, 2, 2, 300, 300, 192,
                               True, 0, "bfloat16", gen, hd_v=128,
                               via="tensor_cores"))
    for dtype in ("float32", "bfloat16"):
        for Sq, Sk, off in ((40, 40, 0), (40, 70, 30)):
            rows.append(flash_bwd_case(torch, F, fops, bops, 2, 4, 4, Sq, Sk,
                                       24, True, off, dtype, gen, hd_v=16,
                                       via="tensor_cores"))
    return rows


def _wkv_f64(torch, r, k, v, logw, u, state0):
    """The plain version's sequential recurrence evaluated in f64: the
    yardstick where the f32 plain version's own rounding is what the
    comparison would read (a state that grows without decay)."""
    rf, kf, vf = (t.double() for t in (r, k, v))
    wf, uf, s = logw.double().exp(), u.double()[:, :, None], state0.double()
    ys = []
    for t in range(r.shape[1]):
        kv = kf[:, t, :, None] * vf[:, t, None, :]
        ys.append(torch.einsum("nk,nkv->nv", rf[:, t], s + uf * kv))
        s = wf[:, t, :, None] * s + kv
    return torch.stack(ys, dim=1), s


@timed_case
def rwkv_case(torch, kops, N, S, hd, dtype, gen, logw_value=None, f64=False,
              profile=False):
    """One WKV-scan check + timings, inputs drawn as in
    tests/test_kernels.py, or with logw = ``logw_value`` at every step.
    Held to the plain version, or with ``f64`` to the same recurrence in
    f64 (the f32 plain version's distance from it is reported as
    ``plain_err``); ``profile``: each of its launches timed by the profiler
    (``launch_us``).  No single PyTorch call computes WKV6."""
    dt = getattr(torch, dtype)
    r, k, v = (torch.randn(N, S, hd, device="cuda", generator=gen).to(dt)
               for _ in range(3))
    z = torch.randn(N, S, hd, device="cuda", generator=gen)
    logw = torch.clamp(-torch.exp(0.5 * z - 1), -8.0, -1e-6) \
        if logw_value is None else torch.full_like(z, logw_value)
    u = 0.1 * torch.randn(N, hd, device="cuda", generator=gen)
    s0 = 0.1 * torch.randn(N, hd, hd, device="cuda", generator=gen)
    args = (r, k, v, logw, u, s0)
    out, state = kops.rwkv6_scan(*args)
    torch.cuda.synchronize()
    want_out, want_state = kops.rwkv6_scan_ref(*args)
    extra = {}
    if f64:
        exact_out, exact_state = _wkv_f64(torch, *args)
        extra = dict(plain_err=max(
            (want_out - exact_out).abs().max().item(),
            (want_state - exact_state).abs().max().item()),
            err_vs_plain=max((out - want_out).abs().max().item(),
                             (state - want_state).abs().max().item()))
        want_out, want_state = exact_out, exact_state
    err = max(_within(torch, out, want_out, K4_TOL),
              _within(torch, state, want_state, K4_TOL))
    if profile:
        extra["launch_us"] = launch_us(
            torch, lambda: kops.rwkv6_scan(*args))
    # the kernel's cost formula (chunked products; inputs, out and state);
    # the function needs the sequential form's read-out and update, one FMA
    # each per state element and step, the bound's count
    design = kops.cost(*args, (out, state))
    flops, nbytes = 4 * N * S * hd * hd, design[1]
    shape = f"N={N} S={S} hd={hd}" \
        + (f" logw={logw_value:g}" if logw_value is not None else "") \
        + (" (vs f64)" if f64 else "")
    return dict(
        shape=shape, dtype=dtype, max_abs_err=err, **extra,
        **_timings(torch, lambda: kops.rwkv6_scan(*args),
                   lambda: kops.rwkv6_scan_ref(*args), None,
                   plain_reps=SCAN_PLAIN_REPS),
        **_bound(nbytes, flops, "float32", design))


@timed_case
def ssm_case(torch, sops, Bz, S, di, ds, dtype, gen, h0_random=True,
             in_place=False, profile=False):
    """One selective-scan check + timings: u, B, C in ``dtype`` and dt in
    f32 as ``apply_ssm`` passes them, A_log the S4D-real init, dt = softplus
    (N(0,1) - 1) as in tests/test_kernels.py; h0 random, or zeros as at a
    prefill.  ``in_place``: the state is written into h0 (``h_out=h0``, as
    the Mamba decode step calls it), which must give the out-of-place
    result to the bit; that call is the one timed.  ``profile``: its launch
    timed by the profiler (``launch_us``).  No single PyTorch call computes
    a selective scan."""
    dt_ = getattr(torch, dtype)
    u = torch.randn(Bz, S, di, device="cuda", generator=gen).to(dt_)
    dt = torch.nn.functional.softplus(
        torch.randn(Bz, S, di, device="cuda", generator=gen) - 1)
    A = torch.log(torch.arange(1, ds + 1, dtype=torch.float32,
                               device="cuda")).repeat(di, 1)
    B = torch.randn(Bz, S, ds, device="cuda", generator=gen).to(dt_)
    C = torch.randn(Bz, S, ds, device="cuda", generator=gen).to(dt_)
    D = torch.randn(di, device="cuda", generator=gen)
    h0 = 0.1 * torch.randn(Bz, di, ds, device="cuda", generator=gen) \
        if h0_random else torch.zeros(Bz, di, ds, device="cuda")
    args = (u, dt, A, B, C, D, h0)
    y, h = sops.ssm_scan(*args)
    torch.cuda.synchronize()
    want_y, want_h = sops.ssm_scan_ref(*args)
    err = max(_within(torch, y, want_y, K3_TOL),
              _within(torch, h, want_h, K3_TOL))
    kernel = functools.partial(sops.ssm_scan, *args)
    if in_place:
        state = h0.clone()
        y2, h2 = sops.ssm_scan(*args[:6], state, h_out=state)
        torch.cuda.synchronize()
        check(h2 is state and torch.equal(y2, y) and torch.equal(state, h),
              "ssm_scan with h_out=h0 differs from the out-of-place call")
        kernel = functools.partial(sops.ssm_scan, *args[:6], state, h_out=state)
    extra = {"launch_us": launch_us(torch, kernel)} if profile else {}
    # the kernel's cost formula (its products; inputs, y and h)
    flops, nbytes = sops.cost(*args, y, h)
    return dict(
        shape=f"Bz={Bz} S={S} di={di} ds={ds} h0={'random' if h0_random else 0}"
        + (" h_out=h0" if in_place else ""),
        dtype=dtype, max_abs_err=err, **extra,
        **_timings(torch, kernel,
                   lambda: sops.ssm_scan_ref(*args), None,
                   plain_reps=SCAN_PLAIN_REPS),
        **_bound(nbytes, flops, "float32"))


def _grad_within(torch, got, want, dtype) -> float:
    """Max abs error of a gradient against its yardstick: bf16 outputs to
    TOL["bfloat16"] (their own rounding), f32 ones to atol 1e-3 plus 1e-5 of
    the largest |want| (SCAN_BWD_REL: a gradient of a scan sums over every
    later step, and at logw = -1e-6 nothing decays)."""
    if dtype == torch.bfloat16:
        return _within(torch, got, want, TOL["bfloat16"])
    atol = K4_TOL["atol"] + SCAN_BWD_REL * want.float().abs().max().item()
    return _within(torch, got, want, dict(atol=atol, rtol=0.0))


def _bwd_checks(torch, got, want, auto, path, again, dtypes) -> tuple:
    """(error against the plain backward, error against autograd over the
    plain forward) of a scan's gradients, each held to ``_grad_within``;
    the autograd path and a second call must give them bit for bit."""
    err = max(_grad_within(torch, g, w, d) for g, w, d in
              zip(got, want, dtypes))
    err_auto = max(_grad_within(torch, g, w, d) for g, w, d in
                   zip(got, auto, dtypes))
    check(all(torch.equal(g, p) for g, p in zip(got, path)),
          "the autograd path's gradients differ from the kernel's")
    check(all(torch.equal(g, a) for g, a in zip(got, again)),
          "two calls on the same inputs differ")
    return err, err_auto


@timed_case
def rwkv_bwd_case(torch, kops, kbops, N, S, hd, dtype, gen, logw_value=None,
                  f64=False, profile=False):
    """One check of the WKV-scan backward kernel + timings, inputs drawn as
    ``rwkv_case``'s, with random gradients of out and of the final state.
    The kernel, fed the forward kernel's states, is held to the plain
    backward (or with ``f64`` to the same recurrence in f64, the f32 plain
    version's distance from it reported as ``plain_err``) and to autograd
    over the plain forward (in f64 too with ``f64``); the autograd path
    (``rwkv6_scan`` under grad) and a second call must give its gradients
    bit for bit.  No single PyTorch call computes WKV6's gradient."""
    dt = getattr(torch, dtype)
    r, k, v = (torch.randn(N, S, hd, device="cuda", generator=gen).to(dt)
               for _ in range(3))
    z = torch.randn(N, S, hd, device="cuda", generator=gen)
    logw = torch.clamp(-torch.exp(0.5 * z - 1), -8.0, -1e-6) \
        if logw_value is None else torch.full_like(z, logw_value)
    u = 0.1 * torch.randn(N, hd, device="cuda", generator=gen)
    s0 = 0.1 * torch.randn(N, hd, hd, device="cuda", generator=gen)
    dout = torch.randn(N, S, hd, device="cuda", generator=gen)
    dstate = torch.randn(N, hd, hd, device="cuda", generator=gen)
    args = (r, k, v, logw, u, s0)
    _, _, states = kops.rwkv6_scan_fwd(*args)

    def kernel():
        return kbops.rwkv6_scan_bwd(*args, dout, dstate, states=states)

    got = kernel()
    torch.cuda.synchronize()
    want = kbops.ref.rwkv6_scan_bwd_ref(*args, dout, dstate)
    extra, cot = {}, (dout, dstate)
    leaves = [t.detach().clone().requires_grad_() for t in args]
    if f64:
        exact = kbops.ref.rwkv6_scan_bwd_ref(
            *(t.double() for t in args + cot))
        extra["plain_err"] = max((w - e).abs().max().item()
                                 for w, e in zip(want, exact))
        want = exact
        wide = [t.detach().double().requires_grad_() for t in args]
        auto = torch.autograd.grad(kops.rwkv6_scan_ref(*wide), wide,
                                   tuple(t.double() for t in cot))
    else:
        auto = torch.autograd.grad(kops.rwkv6_scan_ref(*leaves), leaves, cot)
    path = torch.autograd.grad(kops.rwkv6_scan(*leaves), leaves, cot)
    dtypes = (dt, dt, dt, torch.float32, torch.float32, torch.float32)
    err, err_auto = _bwd_checks(torch, got, want, auto, path, kernel(), dtypes)
    if profile:
        extra["launch_us"] = launch_us(torch, kernel)
    # the kernel's cost formula (chunked products; the forward's entering
    # states read besides the inputs, the gradients written).  The function
    # reads state0, not the chunks' states, and needs the sequential form's
    # six FMAs per state element and step (S_{t-1} recomputed, G updated,
    # S_{t-1} dy, G v, k G, G o S_{t-1}): the bound's count
    design = kbops.cost((r, k, v, logw, u, dout, states, dstate), got)
    flops = 12 * N * S * hd * hd
    nbytes = design[1] - 4 * states.numel() + 4 * N * hd * hd
    shape = f"N={N} S={S} hd={hd}" \
        + (f" logw={logw_value:g}" if logw_value is not None else "") \
        + (" (vs f64)" if f64 else "")
    return dict(
        shape=shape, dtype=dtype, max_abs_err=err, err_vs_autograd=err_auto,
        **extra,
        **_timings(torch, kernel,
                   lambda: kbops.ref.rwkv6_scan_bwd_ref(*args, dout, dstate),
                   None, plain_reps=SCAN_PLAIN_REPS),
        **_bound(nbytes, flops, "float32", design))


@timed_case
def ssm_bwd_case(torch, sops, sbops, Bz, S, di, ds, dtype, gen,
                 profile=False):
    """One check of the selective-scan backward kernel + timings, inputs
    drawn as ``ssm_case``'s (h0 random), with random gradients of y and of
    the final state.  The kernel, fed the forward kernel's checkpoints, is
    held to the plain backward and to autograd over the plain forward; the
    autograd path (``ssm_scan`` under grad) and a second call must give its
    gradients bit for bit.  No single PyTorch call computes a selective
    scan's gradient."""
    dt_ = getattr(torch, dtype)
    u = torch.randn(Bz, S, di, device="cuda", generator=gen).to(dt_)
    dt = torch.nn.functional.softplus(
        torch.randn(Bz, S, di, device="cuda", generator=gen) - 1)
    A = torch.log(torch.arange(1, ds + 1, dtype=torch.float32,
                               device="cuda")).repeat(di, 1)
    B = torch.randn(Bz, S, ds, device="cuda", generator=gen).to(dt_)
    C = torch.randn(Bz, S, ds, device="cuda", generator=gen).to(dt_)
    D = torch.randn(di, device="cuda", generator=gen)
    h0 = 0.1 * torch.randn(Bz, di, ds, device="cuda", generator=gen)
    dy = torch.randn(Bz, S, di, device="cuda", generator=gen)
    dh = torch.randn(Bz, di, ds, device="cuda", generator=gen)
    args = (u, dt, A, B, C, D, h0)
    _, _, ckpt = sops.ssm_scan_fwd(*args)

    def kernel():
        return sbops.ssm_scan_bwd(*args, dy, dh, ckpt=ckpt)

    got = kernel()
    torch.cuda.synchronize()
    want = sbops.ref.ssm_scan_bwd_ref(*args, dy, dh)
    leaves = [t.detach().clone().requires_grad_() for t in args]
    auto = torch.autograd.grad(sops.ssm_scan_ref(*leaves), leaves, (dy, dh))
    path = torch.autograd.grad(sops.ssm_scan(*leaves), leaves, (dy, dh))
    f32 = torch.float32
    dtypes = (dt_, f32, f32, dt_, dt_, f32, f32)
    err, err_auto = _bwd_checks(torch, got, want, auto, path, kernel(), dtypes)
    extra = {"launch_us": launch_us(torch, kernel)} if profile else {}
    # the kernel's cost formula (its products; the inputs it reads, the
    # checkpoints among them, and the gradients it writes).  The function
    # reads h0, not the checkpoints, which are the design's own traffic and
    # are reported apart: the bound's count
    ckpt_bytes = 4 * math.prod(sbops.checkpoint_shape(Bz, S, di, ds))
    design = sbops.cost((u, dt, A, B, C, D, ckpt, dy, dh), got, ds)
    flops, nbytes = design[0], design[1] - ckpt_bytes + 4 * h0.numel()
    return dict(
        shape=f"Bz={Bz} S={S} di={di} ds={ds}", dtype=dtype, max_abs_err=err,
        err_vs_autograd=err_auto, checkpoint_mb=ckpt_bytes / 1e6, **extra,
        **_timings(torch, kernel,
                   lambda: sbops.ref.ssm_scan_bwd_ref(*args, dy, dh), None,
                   plain_reps=SCAN_PLAIN_REPS),
        **_bound(nbytes, flops, "float32", design))


def visible_pairs(Sq: int, Sk: int, causal: bool, q_offset: int) -> int:
    """(query, key) pairs a causal mask leaves visible, or all of them."""
    if not causal:
        return Sq * Sk
    return sum(min(Sk, max(0, q_offset + i + 1)) for i in range(Sq))


def card_rates() -> tuple:
    """(HBM bytes/s, {arithmetic: FLOP/s}) of the card, from
    ``repro_torch.core.hw.h100_sxm``: f32 FMA on the CUDA cores, bf16 on the
    tensor cores, and f32 as three TF32 products on the tensor cores."""
    from repro_torch.core.hw import h100_sxm
    chip = h100_sxm().chip
    return chip.memory.bandwidth, {
        "float32": chip.compute.flops_for("float32"),
        "bfloat16": chip.compute.flops_for("bfloat16"),
        "tf32x3": chip.compute.flops_for("tensorfloat32") / 3}


def _bound(nbytes: float, flops: float, dtype: str, design=None) -> dict:
    """The least time of the function's own work, ``nbytes`` moved and
    ``flops`` at the rate of ``dtype``.  ``design``: the kernel wrapper's
    ``cost`` (FLOPs, bytes), the dry run's count, where the kernel's form
    does more than the function needs; its bound stands beside as
    ``design_bound_ms``."""
    hbm, peak = card_rates()
    t_bytes = nbytes / hbm * 1e3
    t_ops = flops / peak[dtype] * 1e3
    row = dict(bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations")
    if design is not None:
        row["design_bound_ms"] = max(design[1] / hbm, design[0] / peak[dtype]) \
            * 1e3
    return row


def _print_row(name, row):
    lib = row["library_ms"]
    lib = "none" if lib is None else f"{lib:.4f}/{row['library_wall_ms']:.4f}"
    print(f"  {name:17s} {row['dtype']:8s} {row['shape']:60s} "
          f"err={row['max_abs_err']:.2e} ms={row['ms']:.4f} "
          f"wall_ms={row['wall_ms']:.4f} plain_ms={row['plain_ms']:.4f}/"
          f"{row['plain_wall_ms']:.4f} library_ms={lib} "
          + (f"library_causal_ms={row['library_causal_ms']:.4f} "
             if row.get("library_causal_ms") else "")
          + (f"err_vs_autograd={row['err_vs_autograd']:.2e} "
             if "err_vs_autograd" in row else "")
          + (f"lse_err={row['lse_err']:.2e} " if "lse_err" in row else "")
          + (f"route={row['route']} ({row['rate']}) " if "route" in row
             else "")
          + (f"cuda_cores_ms={row['cuda_cores_ms']:.4f} cuda_cores_err="
             f"{row['cuda_cores_err']:.2e} " if "cuda_cores_ms" in row else "")
          + (f"err_vs_plain={row['err_vs_plain']:.2e} "
             if "err_vs_plain" in row else "")
          + (f"checkpoint_mb={row['checkpoint_mb']:.1f} (not in bound_ms) "
             if "checkpoint_mb" in row else "")
          + (f"plain_err={row['plain_err']:.2e} " if "plain_err" in row
             else "")
          + ("launch_us=" + ",".join(f"{k}:{v:.2f}" for k, v in
                                     row["launch_us"].items()) + " "
             if "launch_us" in row else "")
          + (f"rel_rms={row['rel_rms']:.2e} (plain vs f32 "
             f"{row['plain_vs_f32']:.2e}) " if "rel_rms" in row else "")
          + (f"bound_cuda_cores_ms={row['bound_cuda_cores_ms']:.5f} "
             if "bound_cuda_cores_ms" in row else "")
          + (f"design_bound_ms={row['design_bound_ms']:.5f} "
             if "design_bound_ms" in row else "")
          + f"bound_ms={row['bound_ms']:.5f} ({row['bound_by']})", flush=True)


# ---------------------------------------------------------------------------
# Phases 3-7: the port's main paths at full width
# ---------------------------------------------------------------------------


def reset_counts(kernels):
    """Zero every kernel's launch count and every plain version's calls."""
    for ops in kernels.values():
        ops.launches = 0
        ops.ref.calls = 0


def launches_of(kernels) -> dict:
    return {name: ops.launches for name, ops in kernels.items()}


def phase_serve(torch, np, cfg, params, device, kernels, serve, slots=4,
                max_len=512, n_requests=8, max_new=32, prompt_range=(16, 257)):
    """Serve requests of seeded prompt lengths through BatchedServer.
    Returns each kernel's launches in the run and the decode calls; the
    caller checks them against the model's path."""
    server = serve.BatchedServer(cfg, batch_slots=slots, max_len=max_len,
                                 device=device)
    server.load(params)
    decode_calls = 0
    inner = server.decode

    def counted(*args):
        nonlocal decode_calls
        decode_calls += 1
        return inner(*args)

    server.decode = counted
    rng = np.random.default_rng(0)
    prompt_lens = rng.integers(*prompt_range, size=n_requests)
    t0 = time.perf_counter()
    queue = [serve.Request(i, rng.integers(0, cfg.vocab_size, size=int(n)),
                           max_new=max_new, t_arrive=t0)
             for i, n in enumerate(prompt_lens)]
    reset_counts(kernels)
    steps_run = serve.run(server, queue)
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launches_of(kernels)
    check(all(r.done for r in queue), "not every request finished")
    check(all(len(r.out) == max_new for r in queue), "a request stopped early")
    check(all(0 <= t < cfg.vocab_size for r in queue for t in r.out),
          "token outside the vocabulary")
    check(all(ops.ref.calls == 0 for ops in kernels.values()),
          "the plain versions ran on the card")
    toks = sum(len(r.out) for r in queue)
    admission = ("prefill per request" if server.prefill is not None
                 else "token-by-token prefill")
    print(f"prompt lengths {prompt_lens.tolist()}; served {len(queue)} "
          f"requests, {toks} tokens in {wall:.2f} s ({toks / wall:.1f} tok/s, "
          f"{steps_run} decode steps, {decode_calls} decode calls, "
          f"admission by {admission}); launches {launches}")
    print(serve.serve_summary(queue), flush=True)
    return dict(launches=launches, tok_s=toks / wall, wall_s=wall,
                steps=steps_run, decode_calls=decode_calls,
                ttft_s=[r.ttft for r in queue], tpot_s=[r.tpot for r in queue])


# ---------------------------------------------------------------------------
# 13. the count against the card
# ---------------------------------------------------------------------------

# The dry run's temp bytes (its peak less the step's arguments) are held to
# the allocator's own peak of requested bytes over the same step on the card
# (``requested_bytes``: the sizes asked for, before the caching allocator
# rounds a block up or hands out a cached block whole).  The two differ only
# by what the kernels allocate after their meta route returns: their split
# scratch, sized by the SM count, which a dry run cannot read.  One call's
# scratch is freed before the next call, so the allowance of a cell is the
# largest scratch one call of its kernels allocates (each wrapper's
# ``scratch_bytes`` at the cell's shapes; 0 where no kernel splits), plus
# one allocator block, ``SCALAR_SLACK``, for 0-d tensors whose lifetime
# differs by device: the autograd engine runs a CUDA backward on a thread
# of its own (qwen's train step peaked 4 bytes higher on the card than on
# meta, and equal to the card's own count).  The growth of
# max_memory_allocated, which holds the allocator's rounding, is printed
# beside and must not be below the requested peak.
SCALAR_SLACK = 512


def meta_like(torch, tree):
    """``tree`` with every tensor replaced by an empty ``meta`` tensor of its
    shape, strides and dtype (the dry run's arguments)."""
    if isinstance(tree, dict):
        return {k: meta_like(torch, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(meta_like(torch, v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return torch.empty_strided(tree.shape, tree.stride(),
                                   dtype=tree.dtype, device="meta")
    return tree


def phase_cost_cell(torch, name, cfg, shape, step, args, kernels, want,
                    scratch=0, reps=5):
    """One cell of phase 13.  ``step(*args)`` on the card is counted by
    ``core.cost.analysis`` on ``meta`` copies of ``args`` (the dry run) and
    on ``args`` themselves (kernels launched); the two counts must agree to
    the integer, each kernel must launch as often as it was counted (each
    of ``want`` at least once), and the roofline bound at the H100's rates
    (``launch/perf.roofline``) must not exceed the step's device time
    (CUDA events, median of ``reps`` runs after one warm-up).  The dry
    run's temp bytes must lie within ``scratch`` (+ ``SCALAR_SLACK``)
    bytes under the growth of the allocator's requested bytes over one more
    run (see above)."""
    from repro_torch.core.cost.analysis import analyze_step, top_contributors
    from repro_torch.launch.perf import roofline, useful_flops

    t0 = time.perf_counter()
    dry = analyze_step(step, *meta_like(torch, args))
    step(*args)                                   # warm-up, no counter
    torch.cuda.synchronize()
    reset_counts(kernels)
    card = analyze_step(step, *args)
    torch.cuda.synchronize()
    launched = launches_of(kernels)
    times = []
    for _ in range(reps):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        step(*args)
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    measured = sorted(times)[len(times) // 2]
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats()
    torch.cuda.reset_peak_memory_stats()
    result = step(*args)
    torch.cuda.synchronize()
    after = torch.cuda.memory_stats()
    del result
    growth = after["allocated_bytes.all.peak"] \
        - before["allocated_bytes.all.current"]
    requested = after["requested_bytes.all.peak"] \
        - before["requested_bytes.all.current"]
    rl = roofline(dry, cfg, useful_flops(cfg, shape))
    top = top_contributors(dry, 5, "bytes")
    counted = {k: dry["by_op"].get(k, {}).get("count", 0) for k in kernels}
    row = dict(cell=name, flops=dry["flops"], hbm_bytes=dry["hbm_bytes"],
               card_flops=card["flops"], card_hbm_bytes=card["hbm_bytes"],
               measured_ms=measured, times_ms=times,
               ratio=measured / rl["bound_ms"],
               peak_bytes=dry["peak_bytes"], temp_bytes=dry["temp_bytes"],
               argument_bytes=dry["argument_bytes"], growth_bytes=growth,
               requested_bytes=requested, scratch_bytes=scratch,
               card_temp_bytes=card["temp_bytes"],
               launches=launched, counted=counted,
               top=[dict(bytes=b, count=n, op=op) for b, n, op in top],
               trace_s=dry["trace_seconds"], **rl)
    print(f"  [{name}] count {dry['flops']:,} FLOP, {dry['hbm_bytes']:,} B "
          f"(card {card['flops']:,}, {card['hbm_bytes']:,}); t_compute "
          f"{rl['t_compute_ms']:.4f} ms, t_memory {rl['t_memory_ms']:.4f} ms,"
          f" bound {rl['bound_ms']:.4f} ms ({rl['dominant']}), measured "
          f"{measured:.4f} ms ({row['ratio']:.2f}x), roofline fraction "
          f"{rl['roofline_fraction']:.4f}; peak {dry['peak_bytes'] / 1e9:.4f}"
          f" GB (temp {dry['temp_bytes']:,} B) vs requested growth "
          f"{requested:,} B (scratch allowance {scratch:,}; counted on the "
          f"card {card['temp_bytes']:,}), allocated "
          f"growth {growth:,} B; launches "
          f"{ {k: n for k, n in launched.items() if n} }", flush=True)
    for b, n, op in top:
        print(f"    {b / 1e9:10.4f} GB {n:6d}x {op}")
    same = (dry["flops"], dry["hbm_bytes"]) == (card["flops"],
                                                 card["hbm_bytes"])
    if not same:
        for op in sorted(set(dry["by_op"]) | set(card["by_op"])):
            a, b = dry["by_op"].get(op), card["by_op"].get(op)
            if a != b:
                print(f"    differs: {op} meta {a} card {b}")
    check(same, f"{name}: the dry run counts {dry['flops']} FLOP and "
          f"{dry['hbm_bytes']} B, the card's run {card['flops']} and "
          f"{card['hbm_bytes']}")
    check(rl["bound_ms"] <= measured, f"{name}: bound {rl['bound_ms']} ms "
          f"over the measured {measured} ms: the count is wrong")
    check(0 <= requested - dry["temp_bytes"] <= scratch + SCALAR_SLACK,
          f"{name}: dry-run temp bytes {dry['temp_bytes']} against the card's "
          f"requested growth {requested} (scratch allowance {scratch})")
    check(growth >= requested, f"{name}: allocated growth {growth} below the "
          f"requested {requested}")
    for k in kernels:
        check(launched[k] == counted[k]
              == card["by_op"].get(k, {}).get("count", 0),
              f"{name}: {k} launched {launched[k]} times, counted "
              f"{counted[k]}")
    for k in want:
        check(launched[k] > 0, f"{name}: {k} never launched")
    row["phase_s"] = time.perf_counter() - t0
    return row


def phase_profile(torch, cfg, params, device, steps, api, slots=4,
                  max_len=512, n=10, pos=(300, 200, 100, 50),
                  random_cache=False, n_prof=3):
    """Where one decode step's time goes: host wall time per step over ``n``
    steps without the profiler, and device kernel time per step over
    ``n_prof`` steps from torch.profiler (device activity only: the host's
    side of the step is the wall time).  The slots decode at ``pos`` in a
    cache of ``max_len`` positions, zeros or (``random_cache``) normal
    draws."""
    decode = steps.make_serve_step(cfg)
    st = api.allocate_decode_state(cfg, slots, max_len, device)
    if random_cache:
        gen = torch.Generator(device=device).manual_seed(4)
        for leaf in _leaves(st):
            leaf.copy_(torch.randn(leaf.shape, generator=gen, device=device))
    tokens = torch.arange(1, slots + 1, dtype=torch.int32, device=device)
    pos = torch.tensor(pos[:slots], dtype=torch.int32, device=device)

    def step():
        nonlocal st
        lg, st = decode(params, st, tokens, pos)
        return lg.argmax(dim=-1).cpu()     # the server's one sync per step

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    step_ms = (time.perf_counter() - t0) / n * 1e3
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n_prof):
            step()
        torch.cuda.synchronize()
    kernels = {key: (us / n_prof / 1e3, count / n_prof)
               for key, (us, count) in device_kernels(prof).items()}
    device_ms = sum(ms for ms, _ in kernels.values())
    launches = sum(c for _, c in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]
    # the port's own kernels: the __global__ functions of csrc/*.cu
    port = {}
    for name, value in kernels.items():
        m = re.match(r"(?:void )?\(anonymous namespace\)::(\w+)[<(]", name)
        if m and m[1] in PORT_KERNELS:
            port[name] = value
    if device_ms > 0:
        print(f"decode step (B={slots}): {step_ms:.2f} ms host wall, "
              f"{device_ms:.3f} ms device kernel time, {launches:.0f} device "
              f"ops/step; device idle {1 - device_ms / step_ms:.1%}")
        for name, (ms, count) in top:
            print(f"  {ms:8.4f} ms/step {count:6.0f}x  {name[:90]}")
        for name, (ms, count) in port.items():
            print(f"  port kernel {name.split('::')[1][:60]}: {ms:.4f} ms/step, "
                  f"{count:.0f} launches/step, {ms / count * 1e3:.2f} us each")
    else:
        print(f"decode step (B={slots}): {step_ms:.2f} ms host wall; device "
              "time not measured (the profiler recorded no device kernels)")
    return dict(step_ms=step_ms, device_ms=device_ms or None,
                device_ops_per_step=launches,
                top=[(name, ms, count) for name, (ms, count) in top],
                port=[(name, ms, count) for name, (ms, count) in port.items()])


def phase_ragged(torch, cfg, params, device, steps, api):
    """Two requests decoded in one batch at different depths give the logits
    each gives alone."""
    decode = steps.make_serve_step(cfg)
    vocab = cfg.vocab_size
    tok_a = [3, 11, 4, 8, 1000 % vocab, 151_000 % vocab]
    tok_b = [6, 2, 77]

    def solo(tokens):
        st = api.allocate_decode_state(cfg, 1, 16, device)
        outs = []
        for p, t in enumerate(tokens):
            lg, st = decode(params, st, torch.tensor([t], device=device),
                            torch.tensor([p], dtype=torch.int32, device=device))
            outs.append(lg[0])
        return outs

    want = {0: solo(tok_a), 1: solo(tok_b)}
    st = api.allocate_decode_state(cfg, 2, 16, device)
    pos, seen = [0, 0], {0: [], 1: []}
    for members in [(0,), (0,), (0,), (0, 1), (0, 1), (0, 1)]:
        tokens = [tok_a[pos[0]] if 0 in members else 0,
                  tok_b[pos[1]] if 1 in members else 0]
        lg, st = decode(params, st, torch.tensor(tokens, device=device),
                        torch.tensor(pos, dtype=torch.int32, device=device))
        for s in members:
            seen[s].append(lg[s])
            pos[s] += 1
    err = 0.0
    for s in (0, 1):
        for w, h in zip(want[s], seen[s]):
            check(bool(torch.isfinite(h).all()), "non-finite logits")
            err = max(err, (w - h).abs().max().item())
    check(err <= 1e-4, f"ragged vs solo logits differ by {err}")
    print(f"max |ragged - solo| logit = {err:.3e} (atol 1e-4)", flush=True)
    return err


def _prompts(torch, np, cfg, device, batch, length):
    rng = np.random.default_rng(1)
    return torch.from_numpy(
        rng.integers(0, cfg.vocab_size, size=(batch, length))).to(device)


def _decode_prompts(torch, cfg, params, prompts, steps, api, device):
    """Feed ``prompts`` (B, L) token by token through the decode step;
    returns (the last logits, the cache)."""
    batch, length = prompts.shape
    decode = steps.make_serve_step(cfg)
    st = api.allocate_decode_state(cfg, batch, length, device)
    for p in range(length):
        lg, st = decode(params, st, prompts[:, p],
                        torch.full((batch,), p, dtype=torch.int32,
                                   device=device))
    return lg, st


def phase_prefill(torch, np, cfg, params, device, kernels, want, steps,
                  api, batch=4, length=256, tol=PREFILL_TOL):
    """Prefill through the kernels ``want`` names, each launched the given
    number of times and no other; the last logits and every leaf of the
    returned cache match the decode path fed the same prompts token by
    token, within ``tol``."""
    prompts = _prompts(torch, np, cfg, device, batch, length)
    prefill = steps.make_prefill_step(cfg)
    reset_counts(kernels)
    t0 = time.perf_counter()
    last, cache = prefill(params, {"tokens": prompts})
    if device.type == "cuda":
        torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    launches = launches_of(kernels)
    check(launches == {name: want.get(name, 0) for name in kernels}
          and all(ops.ref.calls == 0 for ops in kernels.values()),
          f"prefill launched {launches}, want {want} and nothing else")
    lg, st = _decode_prompts(torch, cfg, params, prompts, steps, api, device)
    err, bad = _excess(torch, last[:, 0], lg, tol)
    state_err = 0.0
    pre_leaves, dec_leaves = dict(_paths(cache)), dict(_paths(st))
    check(pre_leaves.keys() == dec_leaves.keys(),
          f"cache keys {sorted(pre_leaves)} vs {sorted(dec_leaves)}")
    leaf_errs = {}
    for path, pre in pre_leaves.items():
        dec = dec_leaves[path]
        check(pre.shape == dec.shape, f"{path}: cache shape "
              f"{tuple(pre.shape)} vs {tuple(dec.shape)}")
        e, b = _excess(torch, pre, dec, tol)
        state_err, bad = max(state_err, e), bad or b
        leaf_errs[path] = (e, dec.float().abs().max().item(),
                           _rel_rms(pre, dec))
        print(f"  cache {path:24s} max err {e:.3e} (max |value| "
              f"{leaf_errs[path][1]:.3e}, relative RMS err "
              f"{leaf_errs[path][2]:.3e})")
    rms = lg.float().square().mean().sqrt().item()
    print(f"prefill {batch} x {length} tokens {prefill_s * 1e3:.1f} ms (first "
          f"call); max |prefill - decode| last logit = {err:.3e} (logit RMS "
          f"{rms:.3f}), cache = {state_err:.3e} (atol {tol['atol']}, rtol "
          f"{tol['rtol']})", flush=True)
    check(not bad, "prefill and decode disagree beyond the tolerance")
    return dict(launches=launches, err=err, state_err=state_err,
                logit_rms=rms, leaf_errs=leaf_errs,
                first_call_ms=prefill_s * 1e3)


def phase_prefill_bf16(torch, np, cfg, params, device, steps, api, batch=2,
                       length=256):
    """Prefill = decode for a model computed in bf16 (``cfg``), held to what
    bf16 rounding accounts for: the last logits and each cache leaf of
    prefill and of token-by-token decode differ (relative RMS) by no more
    than twice the distance of the bf16 prefill from the same prefill with
    the products in f32, plus 1e-3.  An elementwise bound does not apply: a
    rounding that moves an MoE router across a near-tie sends a token to
    another expert, and the layers after it see another input there."""
    prompts = _prompts(torch, np, cfg, device, batch, length)
    prefill = steps.make_prefill_step(cfg)
    last, cache = prefill(params, {"tokens": prompts})
    last32, cache32 = steps.make_prefill_step(dataclasses.replace(
        cfg, compute_dtype="float32"))(params, {"tokens": prompts})
    lg, st = _decode_prompts(torch, cfg, params, prompts, steps, api, device)
    got = {"logits": last[:, 0], **dict(_paths(cache))}
    f32 = {"logits": last32[:, 0], **dict(_paths(cache32))}
    dec = {"logits": lg, **dict(_paths(st))}
    check(got.keys() == dec.keys(), f"cache keys {sorted(got)} vs {sorted(dec)}")
    rows, bad = {}, []
    for path in got:
        check(bool(torch.isfinite(got[path]).all()
                   and torch.isfinite(dec[path]).all()), f"{path}: non-finite")
        err = _rel_rms(got[path], dec[path])
        rounding = _rel_rms(got[path], f32[path])
        rows[path] = dict(rel_rms=err, bf16_vs_f32=rounding,
                          max_err=(got[path].float() - dec[path].float())
                          .abs().max().item())
        print(f"  {path:24s} prefill vs decode: relative RMS {err:.3e}, max "
              f"{rows[path]['max_err']:.3e}; bf16 vs f32 prefill: relative "
              f"RMS {rounding:.3e}")
        if err > 2 * rounding + 1e-3:
            bad.append(path)
    check(not bad, f"prefill and decode differ beyond bf16 rounding: {bad}")
    print(f"prefill {batch} x {length} tokens = decode within twice bf16's own "
          "rounding, logits and every cache leaf", flush=True)
    return rows


def phase_server_solo(torch, np, cfg, params, device, serve, max_len=512,
                      tol=SOLO_TOL):
    """Each request served in a 2-slot batch gets, at every step, the logits
    it gets alone in a fresh 1-slot server, within ``tol``.  A decodes while B is admitted
    into the other slot; C is admitted into the slot A freed.  The tokens
    fed are fixed lists, not the greedy ones, so the streams cannot part on
    a near tie."""
    rng = np.random.default_rng(2)
    lens, news = {0: 40, 1: 100, 2: 64}, {0: 4, 1: 8, 2: 6}
    prompts = {i: rng.integers(0, cfg.vocab_size, size=n)
               for i, n in lens.items()}
    fed = {i: [int(prompts[i][-1])] + rng.integers(
        0, cfg.vocab_size, size=news[i] - 1).tolist() for i in lens}

    def server_of(slots):
        server = serve.BatchedServer(cfg, slots, max_len, device=device)
        server.load(params)
        seen = {i: [] for i in lens}
        inner = server.decode

        def fixed_tokens(p, state, tokens, pos):
            tokens = tokens.clone()
            live = [(s, r) for s, r in enumerate(server.slot_req) if r]
            for s, r in live:
                tokens[s] = fed[r.rid][len(r.out)]
            logits, state = inner(p, state, tokens, pos)
            for s, r in live:
                seen[r.rid].append(logits[s].clone())
            return logits, state

        server.decode = fixed_tokens
        return server, seen

    def request(i):
        return serve.Request(i, prompts[i], max_new=news[i])

    want = {}
    for i in lens:
        server, seen = server_of(1)
        server.admit(request(i))
        while server.slot_req[0] is not None:
            server.step()
        want[i] = seen[i]
    server, got = server_of(2)
    reqs = {0: request(0), 1: request(1), 2: request(2)}
    server.admit(reqs[0])
    server.step()
    server.step()
    check(server.admit(reqs[1]), "B was not admitted")    # while A decodes
    while not all(r.done for r in reqs.values()):
        if reqs[0].done and reqs[2].t_admit == 0.0:
            check(server.admit(reqs[2]) and server.slot_req[0] is reqs[2]
                  and not reqs[1].done, "C was not admitted into A's slot "
                  "while B decodes")
        server.step()
    err, bad = 0.0, False
    for i in lens:
        check(len(got[i]) == len(want[i]) == news[i],
              f"request {i}: {len(got[i])} steps, want {news[i]}")
        for w, h in zip(want[i], got[i]):
            e, b = _excess(torch, h, w, tol)
            err, bad = max(err, e), bad or b
    print(f"max |2-slot server - solo| logit = {err:.3e} over "
          f"{sum(news.values())} steps (atol {tol['atol']}, rtol "
          f"{tol['rtol']})", flush=True)
    check(not bad, "2-slot server and solo disagree beyond the tolerance")
    return err


# ---------------------------------------------------------------------------
# Training: qwen1.5-0.5b through K2 and its backward
# ---------------------------------------------------------------------------


def _to(torch, tree, device):
    return {k: _to(torch, v, device) for k, v in tree.items()} \
        if isinstance(tree, dict) else tree.to(device, copy=True)


def _grads_of(adamw, state, b1):
    """{path: gradient} that one AdamW step from zero moments saw: ``m`` is
    then (1 - b1) times the clipped gradient."""
    return {path: m / (1 - b1) for path, m in adamw.named_leaves(state["m"])}


def _leaf_errs(got, want):
    """{path: max |got - want| over max |want|} of two {path: tensor},
    taken where ``got`` lies (``want`` is moved there: the same numbers)."""
    out = {}
    for path, w in want.items():
        w = w.to(got[path].device)
        scale = w.abs().max().item()
        err = (got[path] - w).abs().max().item()
        out[path] = err / scale if scale > 0 else (0.0 if err == 0 else
                                                    float("inf"))
    return out


def phase_train_step_vs_cpu(torch, cfg, device, kernels, steps, api, adamw,
                            OptimizerConfig, pipeline, want, batch=2, seq=256,
                            remat_modes=("dots", "full"), batch_of=None):
    """One train step on the card, and its loss and clipped gradient on the
    CPU (``api.loss_fn``, autograd and ``adamw.clip_by_global_norm``, as the
    step computes them), from the same params (drawn on the card) and batch
    (f32).  The gradient of every leaf (on the card ``m`` after one step
    from zero moments, which is 0.1 times it) agrees to 2e-3 of the leaf's
    largest value (tests/test_models.py's bound), and so do the loss and
    grad norm.  The card's params after the step equal the CPU's AdamW
    applied to the card's own gradient to 1e-6: comparing them with a CPU
    step instead could not fail, since Adam's first step moves each element
    by about lr whatever its gradient's size.  The card's step must launch the kernels
    ``want`` names, each the given number of times, and no other.  Then the
    same step under each of ``remat_modes`` on the card gives every leaf's
    gradient to 1e-5.  ``batch_of(tokens)`` makes the step's batch (on the
    CPU) from the pipeline's tokens; by default the tokens alone."""
    opt_cfg = OptimizerConfig(lr=3e-4, warmup_steps=5, total_steps=30)
    # drawn on the card: a CPU generator takes ~10 s a billion draws
    cpu_params = _to(torch, api.init_params(
        torch.Generator(device=device).manual_seed(0), cfg),
        torch.device("cpu"))
    data = pipeline.SyntheticTokenPipeline(pipeline.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch))
    tokens = torch.from_numpy(data.batch_at(0)["tokens"])
    batch_cpu = (batch_of or (lambda t: {"tokens": t}))(tokens)
    results = {}
    params = _to(torch, cpu_params, device)
    step = steps.make_train_step(cfg, opt_cfg, remat="none")
    reset_counts(kernels)
    t0 = time.perf_counter()
    params, state, metrics = step(params, adamw.init_opt_state(
        params, opt_cfg), {k: v.to(device) for k, v in batch_cpu.items()})
    results["cuda"] = dict(params=params, loss=float(metrics["loss"]),
                           s=time.perf_counter() - t0,
                           grads=_grads_of(adamw, state, opt_cfg.b1),
                           grad_norm=float(metrics["grad_norm"]),
                           launches=launches_of(kernels),
                           plain_calls=sum(ops.ref.calls
                                           for ops in kernels.values()))
    # the CPU's half of the same step: the update it would apply after the
    # clip is not compared (AdamW runs on the CPU once, below, on the card's
    # gradient)
    t0 = time.perf_counter()
    loss, grads = _loss_and_grads(torch, api, adamw, cfg, cpu_params,
                                  batch_cpu)
    clipped, norm = adamw.clip_by_global_norm(
        adamw.tree_like(cpu_params, grads), opt_cfg.grad_clip)
    results["cpu"] = dict(loss=loss, s=time.perf_counter() - t0,
                          grads=dict(adamw.named_leaves(clipped)),
                          grad_norm=float(norm))
    del grads, clipped
    gpu, cpu = results["cuda"], results["cpu"]
    # the CPU's gradients compared on the card: the same differences, with
    # no pass of the host over a model's worth of floats
    cpu["grads"] = {path: g.to(device) for path, g in cpu["grads"].items()}
    check(gpu["launches"] == {name: want.get(name, 0) for name in kernels}
          and gpu["plain_calls"] == 0,
          f"the card's train step launched {gpu['launches']}, want {want}")
    loss_rel = abs(gpu["loss"] - cpu["loss"]) / abs(cpu["loss"])
    gn_rel = abs(gpu["grad_norm"] - cpu["grad_norm"]) / cpu["grad_norm"]
    grad_errs = _leaf_errs(gpu["grads"], cpu["grads"])
    worst = max(grad_errs, key=grad_errs.get)
    # the clipped gradients' norms in f64: where the f32 grad norms read the
    # same, this shows how far apart the sums under them are
    norm64 = {where: sum(g.double().square().sum().item() for g in
                         results[where]["grads"].values()) ** 0.5
              for where in results}
    norm64_rel = abs(norm64["cuda"] - norm64["cpu"]) / norm64["cpu"]
    # the CPU's AdamW on the card's gradient (clipped already: the second
    # clip scales by 1 to within rounding) from the same params
    ref = _to(torch, cpu_params, torch.device("cpu"))
    adamw.adamw_update(ref, adamw.tree_like(ref, {
        path: g.cpu() for path, g in gpu["grads"].items()}),
        adamw.init_opt_state(ref, opt_cfg), opt_cfg)
    p_err = max((a - b.to(a.device)).abs().max().item() for a, b in
                zip(adamw.leaves(gpu["params"]), adamw.leaves(ref)))
    print(f"one step, {cfg.num_layers} layers at full width, B={batch} "
          f"S={seq}: loss card {gpu['loss']!r} / CPU {cpu['loss']!r} "
          f"(rel {loss_rel:.2e}); grad norm {gpu['grad_norm']!r} / "
          f"{cpu['grad_norm']!r} (rel {gn_rel:.2e}); clipped gradient's norm "
          f"in f64 {norm64['cuda']!r} / {norm64['cpu']!r} (rel "
          f"{norm64_rel:.2e}); gradient leaf by leaf, "
          f"max |card - CPU| / max |CPU|: worst {worst} {grad_errs[worst]:.3e}"
          f"; params after the step against the CPU's AdamW on the card's "
          f"gradient: max |diff| {p_err:.3e}; card {gpu['s']:.2f} s (first "
          f"call), CPU {cpu['s']:.2f} s", flush=True)
    for path, err in sorted(grad_errs.items(), key=lambda kv: -kv[1]):
        print(f"  grad {path}: {err:.3e} (max |g| "
              f"{cpu['grads'][path].abs().max().item():.3e})")
    check(loss_rel <= 2e-3 and gn_rel <= 2e-3 and grad_errs[worst] <= 2e-3,
          "the card's gradient and the CPU's disagree")
    check(p_err <= 1e-6, "the card's AdamW step and the CPU's disagree")
    remat = {}
    for mode in remat_modes:
        params = _to(torch, cpu_params, device)
        step = steps.make_train_step(cfg, opt_cfg, remat=mode)
        _, state, metrics = step(params, adamw.init_opt_state(
            params, opt_cfg), {k: v.to(device) for k, v in batch_cpu.items()})
        errs = _leaf_errs(_grads_of(adamw, state, opt_cfg.b1), gpu["grads"])
        remat[mode] = dict(loss=float(metrics["loss"]),
                           grad_norm=float(metrics["grad_norm"]),
                           grad_err=max(errs.values()))
        print(f"  remat {mode!r} on the card: loss {remat[mode]['loss']!r}, "
              f"grad norm {remat[mode]['grad_norm']!r}, worst leaf's "
              f"gradient against 'none' {remat[mode]['grad_err']:.2e}")
        check(remat[mode]["grad_err"] <= 1e-5,
              f"remat {mode!r} changes the step")
    return dict(loss=(gpu["loss"], cpu["loss"]), loss_rel=loss_rel,
                grad_norm=(gpu["grad_norm"], cpu["grad_norm"]),
                grad_norm_rel=gn_rel, grad_norm64=norm64,
                grad_norm64_rel=norm64_rel, grad_errs=grad_errs,
                adamw_err=p_err, card_s=gpu["s"], cpu_s=cpu["s"], remat=remat)


def phase_train(torch, np, cfg, kernels, steps, train, adamw, per_step,
                n_steps=30, batch=4, seq=512, profile_at=10, dtype="float32",
                converge=True, arch="qwen1.5-0.5b", model_cfg=None, lr=3e-4):
    """``launch/train.py``'s own ``main`` on the card (``--arch arch --dtype
    dtype --lr lr``, with ``model_cfg`` passed as its config when given):
    ``n_steps`` steps of the synthetic pipeline, checkpointing into a
    temporary directory.  Each step is timed on the host clock, ending in a
    synchronise; step ``profile_at`` is profiled for its device kernel time
    (K2's forward and backward kernels apart), with its AdamW update in a
    range of its own (its kernels' device time and count, and its span
    between two CUDA events).  The loss must be finite and, with
    ``converge``, fall by tests/test_system.py's criterion; every step must
    launch the kernels ``per_step`` names, each the given number of times,
    and no other kernel of the port."""
    import tempfile
    from torch.profiler import ProfilerActivity, profile, record_function

    times, prof_out, opt_span = [], {}, []
    make, update = steps.make_train_step, adamw.adamw_update

    def traced_update(*a, **kw):
        if len(times) != profile_at:
            return update(*a, **kw)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        with record_function("adamw_update"):
            out = update(*a, **kw)
        ev[1].record()
        leaves = adamw.leaves(a[0])
        opt_span.append((ev, len(leaves), sum(t.numel() for t in leaves)))
        return out

    def timed_factory(*a, **kw):
        fn = make(*a, **kw)

        def timed(params, opt_state, batch_):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if len(times) == profile_at:
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    out = fn(params, opt_state, batch_)
                    torch.cuda.synchronize()
                prof_out["kernels"] = device_kernels(prof)
                prof_out["adamw"] = range_kernels(prof, "adamw_update")
            else:
                out = fn(params, opt_state, batch_)
                torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            return out

        return timed

    steps.make_train_step, adamw.adamw_update = timed_factory, traced_update
    try:
        with tempfile.TemporaryDirectory() as ckpt_dir:
            reset_counts(kernels)
            t0 = time.perf_counter()
            losses = train.main(["--arch", arch, "--steps",
                                 str(n_steps), "--batch", str(batch),
                                 "--seq", str(seq), "--warmup", "5",
                                 "--dtype", dtype, "--lr", str(lr),
                                 "--ckpt-dir", ckpt_dir, "--ckpt-every",
                                 "1000", "--log-every", "10"], cfg=model_cfg)
            wall = time.perf_counter() - t0
            launches = launches_of(kernels)
            saved = sorted(os.listdir(ckpt_dir))
    finally:
        steps.make_train_step, adamw.adamw_update = make, update
    want = {name: per_step.get(name, 0) * n_steps for name in kernels}
    check(launches == want and all(ops.ref.calls == 0
                                   for ops in kernels.values()),
          f"training launched {launches}, want {want}")
    check(len(losses) == n_steps and bool(np.isfinite(losses).all()),
          f"losses {losses}")
    first5, last5 = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    check(not converge or last5 < first5 - 0.05, f"the loss did not fall: "
          f"first five {first5:.4f}, last five {last5:.4f}")
    check(f"step_{n_steps:09d}" in saved, f"no checkpoint of the last step "
          f"in {saved}")
    steady = sorted(t for i, t in enumerate(times) if i not in (0, profile_at))
    step_ms = steady[len(steady) // 2] * 1e3
    kern = prof_out.get("kernels", {})
    device_ms = sum(us for us, _ in kern.values()) / 1e3
    top = sorted(kern.items(), key=lambda kv: -kv[1][0])[:8]
    # the port's kernels of the path in the profiled step: (ms, launches)
    found = port_kernels_of(kern)
    port = {stem: found.get(stem, (0.0, 0)) for stem, calls in
            per_step.items() if calls}
    tok_s = batch * seq / (step_ms / 1e3)
    print(f"trained {n_steps} steps of B={batch} x S={seq} in {dtype} in "
          f"{wall:.1f} s (checkpoint included); loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f} (first five {first5:.4f}, last five "
          f"{last5:.4f}); step "
          f"{step_ms:.1f} ms median host wall (first {times[0] * 1e3:.1f} "
          f"ms), {tok_s:.0f} tokens/s; calls a step: "
          + ", ".join(f"{name} {launches[name] / n_steps:.0f}"
                      for name in port), flush=True)
    if device_ms > 0:
        print(f"profiled step {profile_at}: {device_ms:.2f} ms device kernel "
              f"time against {step_ms:.1f} ms a step: device idle "
              f"{1 - device_ms / step_ms:.1%}; "
              + ", ".join(f"{stem} {ms:.3f} ms in {count:.0f} launches"
                          for stem, (ms, count) in port.items()))
        for name, (us, count) in top:
            print(f"  {us / 1e3:8.3f} ms {count:5d}x  {name[:90]}")
    else:
        print("profiled step: device time not measured (the profiler "
              "recorded no device kernels)")
    opt_us, opt_launches = prof_out.get("adamw") or (0, 0)
    opt_ms = opt_us / 1e3
    check(len(opt_span) == 1, "the profiled step ran no AdamW update")
    (ev0, ev1), n_leaves, n_params = opt_span[0]
    span_ms = ev0.elapsed_time(ev1)
    # read p, g, m, v and write p, m, v once each, f32
    opt_bound = n_params * 4 * 7 / card_rates()[0] * 1e3
    if opt_ms > 0:
        print(f"  AdamW update of {n_leaves} leaves in that step: "
              f"{opt_ms:.2f} ms device kernel time in {opt_launches} "
              f"launches, {span_ms:.2f} ms between its CUDA events (device "
              f"idle in it {1 - opt_ms / span_ms:.1%}); bound (bytes) "
              f"{opt_bound:.2f} ms", flush=True)
    else:
        print(f"  AdamW update: device time not measured (the profiler "
              f"attributed no kernel to it); {span_ms:.2f} ms between its "
              f"CUDA events; bound (bytes) {opt_bound:.2f} ms", flush=True)
    return dict(losses=losses, step_ms=step_ms, step_s=times,
                tokens_per_s=tok_s, wall_s=wall, launches=launches,
                launches_per_step={k: v / n_steps for k, v in launches.items()},
                device_ms=device_ms or None,
                idle=(1 - device_ms / step_ms) if device_ms else None,
                kernel_device_ms=port,
                top=[(name, us / 1e3, count) for name, (us, count) in top],
                optimizer=dict(device_ms=opt_ms or None,
                               launches=opt_launches or None,
                               span_ms=span_ms, leaves=n_leaves,
                               bound_ms=opt_bound))


def head_device_ms(torch, cfg, params, batch, seq) -> float:
    """Device ms of the LM head and its cross-entropy (``lm.chunked_xent``:
    the head projection and log-softmax a chunk of positions at a time,
    recomputed in the backward), forward and backward, at a train step's
    shape from random hidden states: ``time_ms``'s CUDA events, each call
    behind a sleep that covers its enqueue (a profiler session here, late
    in a long run, recorded no kernel)."""
    from repro_torch.models import lm
    gen = torch.Generator(device="cuda").manual_seed(5)
    h = torch.randn(batch, seq - 1, cfg.d_model, device="cuda",
                    generator=gen).to(getattr(torch, cfg.compute_dtype))
    h.requires_grad_()
    targets = torch.randint(0, cfg.vocab_size, (batch, seq - 1),
                            device="cuda", generator=gen)
    w = params["lm_head"]["w"].detach().requires_grad_()

    def run():
        loss = lm.chunked_xent({"lm_head": {"w": w}}, cfg, h, targets)
        return torch.autograd.grad(loss, [h, w])

    return time_ms(torch, run, reps=3, inner=1)[0]


def _loss_and_grads(torch, api, adamw, cfg, params, batch, remat="none"):
    """(loss, {path: gradient}) of ``api.loss_fn`` through detached aliases
    of the param leaves, as the train step takes them."""
    named = adamw.named_leaves(params)
    alias = {path: t.detach().requires_grad_() for path, t in named}
    with torch.enable_grad():
        loss, _ = api.loss_fn(adamw.tree_like(params, alias), cfg, batch,
                              remat=remat)
        grads = torch.autograd.grad(loss, [alias[p] for p, _ in named])
    return float(loss.detach()), {p: g for (p, _), g in zip(named, grads)}


def phase_grad_check(torch, device, api, adamw, get_arch, pipeline, kernels,
                     dops, batch=2, seq=70,
                     archs=("rwkv6-1.6b", "jamba-1.5-large-398b")):
    """The smoke models' gradients on the card: by default rwkv6 smoke (K4
    and its backward) and jamba smoke (K3 and its backward, K2 and its
    backward) in f32, from the same params and batch as on the CPU, give
    the loss and every leaf's gradient within tests/test_torch_train.py's
    TOL (atol and rtol 2e-3); S = 70 leaves a ragged last chunk for both
    scans.  So they do under each remat mode, where the backward reruns
    each period's forward (its kernels twice a step; prefix blocks, such as
    deepseek's dense first layer, once) and the scans' autograd Functions
    keep their checkpoints only through the rerun.  Then, given
    ``dops``, K1, whose decode needs no backward, still refuses grad mode."""
    out = {}
    for arch in archs:
        cfg = dataclasses.replace(get_arch(arch).smoke, param_dtype="float32",
                                  compute_dtype="float32")
        params = api.init_params(torch.Generator().manual_seed(0), cfg)
        data = pipeline.SyntheticTokenPipeline(pipeline.DataConfig(
            vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch))
        tokens = torch.from_numpy(data.batch_at(0)["tokens"])
        cpu_loss, cpu_grads = _loss_and_grads(torch, api, adamw, cfg, params,
                                              {"tokens": tokens})
        kinds = cfg.layer_kinds()
        # the prefix blocks (deepseek's dense first layer) run without remat,
        # as the reference's: only the periods' forwards run again
        periods = kinds[cfg.moe.first_k_dense if cfg.moe else 0:]
        card_params = _to(torch, params, device)
        out[cfg.name] = {}
        for remat in ("none", "dots", "full"):
            reset_counts(kernels)
            loss, grads = _loss_and_grads(
                torch, api, adamw, cfg, card_params,
                {"tokens": tokens.to(device)}, remat=remat)
            launches = launches_of(kernels)
            def runs(kind):
                return kinds.count(kind) + (periods.count(kind)
                                            if remat != "none" else 0)

            want = {"rwkv6_scan": runs("rwkv"),
                    "rwkv6_scan_bwd": kinds.count("rwkv"),
                    "ssm_scan": runs("ssm"), "ssm_scan_bwd": kinds.count("ssm"),
                    "flash_attention": runs("attn"),
                    "flash_attention_bwd": kinds.count("attn")}
            check(launches == {name: want.get(name, 0) for name in kernels}
                  and all(ops.ref.calls == 0 for ops in kernels.values()),
                  f"{cfg.name}'s gradient (remat {remat!r}) launched "
                  f"{launches}, want {want}")
            worst, worst_path = 0.0, None
            for path, want_g in cpu_grads.items():
                err, bad = _excess(torch, grads[path].cpu(), want_g,
                                   dict(atol=2e-3, rtol=2e-3))
                check(not bad, f"{cfg.name}: gradient of {path} (remat "
                      f"{remat!r}) off the CPU's by {err} (atol 2e-3, rtol "
                      "2e-3)")
                if err >= worst:
                    worst, worst_path = err, path
            check(abs(loss - cpu_loss) <= 2e-3 + 2e-3 * abs(cpu_loss),
                  f"{cfg.name}: loss {loss} on the card (remat {remat!r}), "
                  f"{cpu_loss} on the CPU")
            print(f"  {cfg.name} B={batch} S={seq} remat {remat!r}: loss card "
                  f"{loss!r} / CPU {cpu_loss!r}; {len(grads)} leaves, worst "
                  f"|card - CPU| {worst:.3e} ({worst_path}); launches "
                  f"{ {k: v for k, v in launches.items() if v} }", flush=True)
            out[cfg.name][remat] = dict(loss=(loss, cpu_loss), worst_err=worst,
                                        worst_leaf=worst_path,
                                        launches=launches)
    if dops is None:
        return out
    q = torch.randn(1, 2, 16, device=device, requires_grad=True)
    kv = torch.randn(1, 2, 8, 16, device=device)
    msg = ""
    try:
        dops.decode_attention(q, kv, kv, torch.tensor(
            [8], dtype=torch.int32, device=device))
    except RuntimeError as e:
        msg = str(e)
    check("decode_attention: the backward" in msg,
          "decode_attention under grad did not raise the grad guard")
    with torch.no_grad():     # the guard lets no-grad callers through
        dops.decode_attention(q, kv, kv, torch.tensor(
            [8], dtype=torch.int32, device=device))
    print(f"  decode_attention: raised under grad: {msg[:100]}...")
    out["decode_attention_refused"] = msg
    return out


def phase_mixer_vs_cpu(torch, cfg, device, kernels, adamw, batch=1,
                       seq=128):
    """jamba's Mamba mixer at full width (``apply_ssm`` of ``cfg``, f32) on
    the card and on the CPU from the same params, input and output
    gradient: every param's gradient and the input's agree to 2e-3 of the
    leaf's largest value (tests/test_models.py's bound).  The card runs K3
    and its backward once each."""
    from repro_torch.models import ssm

    params = ssm.init_ssm(torch.Generator().manual_seed(0), cfg)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(batch, seq, cfg.d_model, generator=gen)
    cot = torch.randn(batch, seq, cfg.d_model, generator=gen)
    grads, secs = {}, {}
    for where in ("cuda", "cpu"):
        dev = device if where == "cuda" else torch.device("cpu")
        here = _to(torch, params, dev)
        alias = {path: t.requires_grad_()
                 for path, t in adamw.named_leaves(here)}
        tree = adamw.tree_like(here, alias)
        xin = x.to(dev).requires_grad_()
        reset_counts(kernels)
        t0 = time.perf_counter()
        with torch.enable_grad():
            y, _ = ssm.apply_ssm(tree, xin, cfg, mode="train")
            gs = torch.autograd.grad(y, list(alias.values()) + [xin],
                                     cot.to(dev))
        if dev.type == "cuda":
            torch.cuda.synchronize()
            launches = launches_of(kernels)
            want = {"ssm_scan": 1, "ssm_scan_bwd": 1}
            check(launches == {name: want.get(name, 0) for name in kernels}
                  and all(ops.ref.calls == 0 for ops in kernels.values()),
                  f"the mixer's gradient launched {launches}, want {want}")
        secs[where] = time.perf_counter() - t0
        grads[where] = dict(zip(list(alias) + ["x"], gs))
    errs = _leaf_errs(grads["cuda"], grads["cpu"])
    worst = max(errs, key=errs.get)
    print(f"  Mamba mixer d_model {cfg.d_model} d_inner "
          f"{cfg.ssm.expand * cfg.d_model} B={batch} S={seq}: gradient leaf by "
          f"leaf, max |card - CPU| / max |CPU|: worst {worst} "
          f"{errs[worst]:.3e}; card {secs['cuda']:.2f} s (first call), CPU "
          f"{secs['cpu']:.2f} s", flush=True)
    for path, err in sorted(errs.items(), key=lambda kv: -kv[1]):
        print(f"  grad {path}: {err:.3e}")
    check(errs[worst] <= 2e-3, "the mixer's gradients on the card and the "
          "CPU disagree")
    return dict(grad_errs=errs, card_s=secs["cuda"], cpu_s=secs["cpu"])


# ---------------------------------------------------------------------------
# Phase 10: DilatedVGG, the paper's network, at 1024 x 2048
# ---------------------------------------------------------------------------


def layer_costs(cfg, batch: int = 1, itemsize: int = 2) -> list:
    """[(layer, output (C, H, W), operations, bytes)] of each layer of a
    convnet at its input size.  Operations: a convolution's multiply-adds
    (two each) at every output, the padded taps included; the pools and the
    resize count by their bytes.  Bytes: the layer's input and params read
    once, its output written once."""
    net = cfg.convnet
    (h, w), c = net.in_hw, net.in_ch
    out = []
    for lay in net.layers:
        conv = lay.kind in ("conv", "dense")
        if lay.kind == "upsample":
            oh, ow = h * lay.stride, w * lay.stride
        else:
            oh, ow = -(-h // lay.stride), -(-w // lay.stride)
        oc = lay.out_ch if conv else c
        flops = 2 * batch * oh * ow * oc * c * lay.kernel ** 2 if conv else 0
        n_params = (lay.kernel ** 2 * c + 1) * oc if conv else 0
        nbytes = itemsize * (batch * (h * w * c + oh * ow * oc) + n_params)
        out.append((lay, (oc, oh, ow), flops, nbytes))
        h, w, c = oh, ow, oc
    return out


def profiled_kernels(torch, fn, n: int) -> dict:
    """{kernel: (device µs, launches)} over ``n`` calls of ``fn`` by
    torch.profiler, after one call under the profiler that is not counted:
    a session can miss the device's first kernels.  Each call is a
    ``ProfilerStep`` range, which is no kernel."""
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=n),
                 acc_events=True) as prof:
        for _ in range(n + 1):
            fn()
            torch.cuda.synchronize()
            prof.step()
    return {k: v for k, v in device_kernels(prof).items()
            if not k.startswith("ProfilerStep")}


def _short(kernel: str, n: int = 70) -> str:
    """A kernel's profiler name without its namespaces, cut to ``n``
    characters (enough to tell PyTorch's elementwise functors apart)."""
    return re.sub(r"void |at::native::|\(anonymous namespace\)::|c10::", "",
                  kernel)[:n]


def _relu_masks(torch, DVGG, cfg, params, image):
    """Each convolution's pre-activation and relu pattern (``z > 0``) in a
    forward of ``image`` through the port's layers, on the params' device."""
    masks, pre = [], []
    with torch.no_grad():
        h = image.to(getattr(torch, cfg.compute_dtype)).permute(0, 3, 1, 2)
        for lay in cfg.convnet.layers:
            if lay.kind in ("conv", "dense"):
                z = DVGG._conv(h, params[lay.name]["w"], params[lay.name]["b"],
                               lay.stride, lay.dilation)
                masks.append(z > 0)
                pre.append(z)
                h = torch.relu(z)
            else:
                h = DVGG.apply_layer(params, lay, h)
    return masks, pre


def _pinned_loss_and_grads(torch, DVGG, cfg, params, image, labels, masks):
    """The convnet's loss, its gradient ({path: tensor}) and each
    convolution's pre-activation, in f64 on the CPU, with each relu taking
    the on/off pattern ``masks`` in place of its own.  relu's gradient jumps
    at 0: where a pre-activation lies within rounding of it, two correct
    evaluations may take it apart, and the gradient of each leaf then moves
    by that pixel's whole share.  Pinning the pattern leaves a smooth
    function to compare."""
    p = {name: {k: t.detach().cpu().double().requires_grad_()
                for k, t in leaf.items()} for name, leaf in params.items()}
    h = image.cpu().double().permute(0, 3, 1, 2)
    pre, i = [], 0
    for lay in cfg.convnet.layers:
        if lay.kind in ("conv", "dense"):
            z = DVGG._conv(h, p[lay.name]["w"], p[lay.name]["b"], lay.stride,
                           lay.dilation)
            pre.append(z.detach())
            h = z * masks[i].cpu()
            i += 1
        else:
            h = DVGG.apply_layer(p, lay, h)
    logp = torch.log_softmax(h.permute(0, 2, 3, 1), dim=-1)
    loss = -logp.gather(-1, labels.cpu().long()[..., None]).mean()
    names = [(name, k) for name in p for k in p[name]]
    grads = torch.autograd.grad(loss, [p[name][k] for name, k in names])
    return (loss.item(), {f"/{name}/{k}": g for (name, k), g in
                          zip(names, grads)}, pre)


def phase_dilated_vgg(torch, cfg, device, api, steps, adamw, OptimizerConfig,
                      kernels, reps=7, small_hw=(128, 256), train_steps=3):
    """DilatedVGG (``cfg``: FULL, bf16) through the port's entry points on
    the card, random params from seed 0 (biases drawn too: the init's are
    zero), batch 1.  (a) ``api.forward``: device ms of the whole forward
    (each timed batch behind ``torch.cuda._sleep``) and of each layer
    (CUDA events around ``apply_layer``, every pass enqueued behind a sleep
    that covers it), each beside its bound; the kernels each layer
    launches; profiled forwards' device ops and idle share.  (b) the
    bf16 logits within 2e-2 relative RMS of the same params' f32 forward.
    (c) f32 on the card and on the CPU at ``small_hw`` (every channel
    width) to 2e-3.  (d) ``train_steps`` bf16 train steps at full size
    and two more, the last profiled, the loss finite; one f32 step at
    ``small_hw`` on the card and on the CPU: the losses agree, the card's
    gradient agrees leaf by leaf (2e-3 of the leaf's largest) with the
    CPU's in f64 under the card's relu pattern (every relu the two take
    apart lies within 1e-4 of its layer's largest pre-activation: a tie,
    not an error), and the card's params after the step equal the CPU's
    AdamW on the card's gradient to 1e-6.  No kernel of the port runs."""
    from repro_torch.models import dilated_vgg as DVGG

    net = cfg.convnet
    H, W = net.in_hw
    layers = net.layers
    out = {}
    reset_counts(kernels)
    params = api.init_params(torch.Generator(device=device).manual_seed(0),
                             cfg)
    gen = torch.Generator(device=device).manual_seed(1)
    for leaf in params.values():
        leaf["b"].copy_(0.1 * torch.randn(leaf["b"].shape, generator=gen,
                                          device=device))
    image = torch.randn((1, H, W, net.in_ch), generator=gen, device=device)
    batch = {"image": image}
    n_params = sum(t.numel() for t in _leaves(params))
    costs = layer_costs(cfg)
    flops = sum(c[2] for c in costs)
    nbytes = sum(c[3] for c in costs)
    bound_ms = sum(_bound(b, f, "bfloat16")["bound_ms"]
                   for _, _, f, b in costs)
    print(f"  {cfg.name} {H} x {W}, {n_params:,} {cfg.param_dtype} params, "
          f"{flops / 1e12:.4f} TFLOP and {nbytes / 1e9:.4f} GB a forward "
          f"(layer by layer), bound {bound_ms:.4f} ms", flush=True)

    # ---- (a) the forward
    with torch.no_grad():
        logits, _ = api.forward(params, cfg, batch)
        check(tuple(logits.shape) == (1, H, W, net.num_classes)
              and logits.dtype == torch.bfloat16
              and bool(torch.isfinite(logits).all()),
              f"forward gave {tuple(logits.shape)} {logits.dtype}")
        ms, wall = time_ms(torch, lambda: api.forward(params, cfg, batch),
                           reps=reps, inner=5)

        def layer_pass():
            """Each layer's pair of events and its input."""
            h = image.to(torch.bfloat16).permute(0, 3, 1, 2)
            evs, ins = [], []
            for lay in layers:
                ins.append(h)
                e = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                e[0].record()
                h = DVGG.apply_layer(params, lay, h)
                e[1].record()
                evs.append(e)
            return evs, ins

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        layer_pass()
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        cycles = int((2 * host_ms + 0.2) * _cycles_per_ms(torch))
        per = {lay.name: [] for lay in layers}
        for _ in range(reps):
            torch.cuda._sleep(cycles)
            evs, _ = layer_pass()
            torch.cuda.synchronize()
            for lay, (a, b) in zip(layers, evs):
                per[lay.name].append(a.elapsed_time(b))
        layer_ms = {k: sorted(v)[len(v) // 2] for k, v in per.items()}
        _, inputs = layer_pass()
        rows = []
        print(f"  forward: {ms:.4f} ms device ({1e3 / ms:.1f} images/s), "
              f"{wall:.4f} ms wall; bound {bound_ms:.4f} ms "
              f"({ms / bound_ms:.2f}x)")
        for (lay, shape, f, b), x_in in zip(costs, inputs):
            kern = {_short(k): us / n for k, (us, n) in profiled_kernels(
                torch, functools.partial(DVGG.apply_layer, params, lay, x_in),
                3).items()}
            row = dict(name=lay.name, kind=lay.kind, dilation=lay.dilation,
                       out=shape, ms=layer_ms[lay.name], flops=f, bytes=b,
                       kernels_us=kern, **_bound(b, f, "bfloat16"))
            rows.append(row)
            print(f"  {lay.name:9s} {lay.kind:8s} d={lay.dilation} out "
                  f"{shape[0]:4d} x {shape[1]:4d} x {shape[2]:4d}: "
                  f"{row['ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
                  f"({row['bound_by']}, {row['ms'] / row['bound_ms']:.2f}x), "
                  f"{f / 1e9:.1f} GFLOP, {b / 1e6:.1f} MB; "
                  + ", ".join(f"{k} {v:.1f} us" for k, v in kern.items()),
                  flush=True)
        del inputs
        sum_ms = sum(layer_ms.values())
        print(f"  sum of the layers {sum_ms:.4f} ms against the whole "
              f"forward's {ms:.4f} ms")
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            api.forward(params, cfg, batch)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        fwd_wall = sorted(walls)[len(walls) // 2]
        kern = {k: (us / 5 / 1e3, n / 5) for k, (us, n) in profiled_kernels(
            torch, lambda: api.forward(params, cfg, batch), 5).items()}
        dev_ms = sum(v[0] for v in kern.values())
        ops = sum(v[1] for v in kern.values())
        print(f"  profiled forward: {fwd_wall:.3f} ms host wall, {dev_ms:.4f} "
              f"ms device, {ops:.0f} device ops; device idle "
              f"{1 - dev_ms / fwd_wall:.1%}")
        for k, (kms, n) in sorted(kern.items(), key=lambda kv: -kv[1][0])[:10]:
            print(f"    {kms:8.4f} ms {n:4.0f}x  {_short(k, 100)}")
        out["forward"] = dict(
            ms=ms, wall_ms=wall, images_s=1e3 / ms, bound_ms=bound_ms,
            flops=flops, bytes=nbytes, layers=rows, layers_sum_ms=sum_ms,
            profiled_wall_ms=fwd_wall, profiled_device_ms=dev_ms,
            device_ops=ops, idle=1 - dev_ms / fwd_wall,
            top=sorted(((k, v[0], v[1]) for k, v in kern.items()),
                       key=lambda r: -r[1])[:10])
        section("== 13c. the count against the card: the bf16 forward")
        out["cost"] = phase_cost_cell(
            torch, f"{cfg.name} forward {H} x {W}", cfg, None,
            lambda p, b: api.forward(p, cfg, b)[0], (params, batch), kernels,
            want=())

        # ---- (b) bf16 against f32, the same params
        cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                    compute_dtype="float32")
        p32 = {n: {k: t.float() for k, t in leaf.items()}
               for n, leaf in params.items()}
        logits32, _ = api.forward(p32, cfg32, batch)
        rel = _rel_rms(logits, logits32)
        ms32, _ = time_ms(torch, lambda: api.forward(p32, cfg32, batch),
                          reps=3, inner=2)
        print(f"  (b) bf16 logits against f32: relative RMS {rel:.4e} (limit "
              f"2e-2); |logits| up to {logits32.abs().max().item():.3f}; the "
              f"f32 forward {ms32:.3f} ms device (TF32 off)", flush=True)
        check(rel <= 2e-2, f"bf16 logits {rel} from f32")
        out["bf16_vs_f32_rel_rms"] = rel
        out["f32_forward_ms"] = ms32
        del logits, logits32

        # ---- (c) card against CPU, f32, every channel width
        small = dataclasses.replace(cfg32, convnet=dataclasses.replace(
            net, in_hw=small_hw))
        cpu = torch.device("cpu")
        cgen = torch.Generator().manual_seed(2)
        img = torch.randn((1,) + small_hw + (net.in_ch,), generator=cgen)
        cpu_p = _to(torch, p32, cpu)
        want, _ = api.forward(cpu_p, small, {"image": img})
        got, _ = api.forward(p32, small, {"image": img.to(device)})
        err = (got.cpu() - want).abs().max().item()
        print(f"  (c) f32 at {small_hw[0]} x {small_hw[1]}: card against CPU "
              f"max |diff| {err:.3e} (limit 2e-3), |logits| up to "
              f"{want.abs().max().item():.3f}", flush=True)
        check(tuple(got.shape) == (1,) + small_hw + (net.num_classes,)
              and err <= 2e-3, f"card and CPU forwards differ by {err}")
        out["card_vs_cpu_err"] = err

    # ---- (d) training: bf16 at full size
    opt_cfg = OptimizerConfig(lr=3e-4, warmup_steps=5, total_steps=30)
    labels = torch.randint(0, net.num_classes, (1, H, W), generator=gen,
                           device=device, dtype=torch.int32)
    step = steps.make_train_step(cfg, opt_cfg, remat="none")
    state = adamw.init_opt_state(params, opt_cfg)
    tbatch = {"image": image, "labels": labels}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held_gb = torch.cuda.memory_allocated() / 1e9
    walls, losses = [], []

    def train_step():
        nonlocal params, state
        params, state, met = step(params, state, tbatch)
        losses.append(float(met["loss"]))

    for _ in range(train_steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_step()
        walls.append((time.perf_counter() - t0) * 1e3)
    kern = profiled_kernels(torch, train_step, 1)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    rest = sorted(walls[1:])
    step_ms = rest[len(rest) // 2]
    dev_ms = sum(us for us, _ in kern.values()) / 1e3
    n_ops = sum(n for _, n in kern.values())
    print(f"  (d) train, bf16, B=1 at {H} x {W}: losses {losses}; step "
          f"{step_ms:.2f} ms host wall (first {walls[0]:.1f} ms); profiled "
          f"step {dev_ms:.3f} ms device, {n_ops} device ops, device idle "
          f"{1 - dev_ms / step_ms:.1%}; peak {peak_gb:.2f} GB with "
          f"{held_gb:.2f} GB held before", flush=True)
    for k, (us, n) in sorted(kern.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"    {us / 1e3:8.4f} ms {n:4d}x  {_short(k, 100)}")
    check(all(math.isfinite(v) for v in losses), f"losses {losses}")
    out["train"] = dict(losses=losses, step_ms=step_ms, walls_ms=walls,
                        device_ms=dev_ms, device_ops=n_ops,
                        idle=1 - dev_ms / step_ms, peak_gb=peak_gb,
                        held_gb=held_gb)
    del params, state, tbatch

    # ---- (d) one f32 step at small_hw, card against CPU
    img_s = torch.randn((1,) + small_hw + (net.in_ch,), generator=cgen)
    lab_s = torch.randint(0, net.num_classes, (1,) + small_hw,
                          generator=cgen, dtype=torch.int32)
    res = {}
    for where in ("cuda", "cpu"):
        dev = device if where == "cuda" else cpu
        here = _to(torch, cpu_p, dev)
        _, st, met = steps.make_train_step(small, opt_cfg, remat="none")(
            here, adamw.init_opt_state(here, opt_cfg),
            {"image": img_s.to(dev), "labels": lab_s.to(dev)})
        res[where] = dict(params=here, loss=float(met["loss"]),
                          grad_norm=float(met["grad_norm"]),
                          grads=_grads_of(adamw, st, opt_cfg.b1))
    gpu, cpu_r = res["cuda"], res["cpu"]
    masks, pre = _relu_masks(torch, DVGG, small, p32, img_s.to(device))
    loss64, grads64, pre64 = _pinned_loss_and_grads(
        torch, DVGG, small, cpu_p, img_s, lab_s, masks)
    norm64 = sum(g.square().sum().item() for g in grads64.values()) ** 0.5
    scale = min(1.0, opt_cfg.grad_clip / max(norm64, 1e-9))
    grad_errs = _leaf_errs(gpu["grads"], {k: g * scale
                                          for k, g in grads64.items()})
    worst = max(grad_errs, key=grad_errs.get)
    plain_errs = _leaf_errs(gpu["grads"], cpu_r["grads"])
    plain_worst = max(plain_errs, key=plain_errs.get)
    ties, tie_max = 0, 0.0
    for m, z in zip(masks, pre64):
        apart = m.cpu() != (z > 0)
        ties += int(apart.sum())
        if apart.any():
            tie_max = max(tie_max, (z[apart].abs().max()
                                    / z.abs().max()).item())
    ref = _to(torch, cpu_p, cpu)
    adamw.adamw_update(ref, adamw.tree_like(ref, {
        k: g.cpu() for k, g in gpu["grads"].items()}),
        adamw.init_opt_state(ref, opt_cfg), opt_cfg)
    p_err = max((a.cpu() - b).abs().max().item() for a, b in
                zip(adamw.leaves(gpu["params"]), adamw.leaves(ref)))
    loss_rel = abs(gpu["loss"] - cpu_r["loss"]) / abs(cpu_r["loss"])
    loss64_rel = abs(gpu["loss"] - loss64) / abs(loss64)
    print(f"  (d) one f32 step at {small_hw[0]} x {small_hw[1]}: loss card "
          f"{gpu['loss']!r} / CPU {cpu_r['loss']!r} / CPU f64 {loss64!r} "
          f"(rel {loss_rel:.2e}, {loss64_rel:.2e}); grad norm "
          f"{gpu['grad_norm']!r} / {cpu_r['grad_norm']!r} / {norm64!r}; "
          f"gradient leaf by leaf against the CPU's in f64 under the card's "
          f"relu pattern, max |diff| / max |ref|: worst {worst} "
          f"{grad_errs[worst]:.3e}; against the CPU's f32 step: worst "
          f"{plain_worst} {plain_errs[plain_worst]:.3e}; relus the card and "
          f"f64 take apart: {ties} (largest |z| / layer max {tie_max:.2e}); "
          f"params after the step against the CPU's AdamW on the card's "
          f"gradient: max |diff| {p_err:.3e}", flush=True)
    check(loss_rel <= 2e-3 and loss64_rel <= 2e-3,
          "the card's loss and the CPU's disagree")
    check(grad_errs[worst] <= 2e-3, "the card's gradient and the CPU's "
          "(f64, the card's relu pattern) disagree")
    check(tie_max <= 1e-4, f"a relu the card takes apart from f64 at |z| "
          f"{tie_max} of its layer's largest")
    check(p_err <= 1e-6, "the card's AdamW step and the CPU's disagree")
    out["train_f32_vs_cpu"] = dict(
        loss=(gpu["loss"], cpu_r["loss"], loss64), grad_errs=grad_errs,
        grad_errs_vs_cpu_f32=plain_errs, relu_ties=ties,
        relu_tie_max=tie_max, adamw_err=p_err)
    launches = launches_of(kernels)
    check(all(n == 0 for n in launches.values())
          and all(ops.ref.calls == 0 for ops in kernels.values()),
          f"DilatedVGG launched a kernel of the port: {launches}")
    return out


# ---------------------------------------------------------------------------
# Phase 11: deepseek-v2-236b's MLA, first 4 layers at full width, bf16
# ---------------------------------------------------------------------------


def _cast(tree, fn):
    return {k: _cast(v, fn) for k, v in tree.items()} \
        if isinstance(tree, dict) else fn(tree)


def first_layers_f32(torch, params, n_layers: int):
    """The first ``n_layers`` of a prefix-and-periods stack's params in f32:
    the prefix block and the first ``n_layers - 1`` periods, with the
    embedding, final norm and head."""
    stack = params["stack"]
    cut = {k: v for k, v in params.items() if k != "stack"}
    cut["stack"] = {"prefix": stack["prefix"],
                    "periods": _cast(stack["periods"],
                                     lambda t: t[:n_layers - 1])}
    return _cast(cut, lambda t: t.float() if t.is_floating_point() else t)


def phase_mla_block(torch, cfg, params, device, kernels, batch=2, length=64,
                    steps=8, tol=PREFILL_TOL):
    """deepseek-v2's first block (MLA and the dense FFN) at full width in
    f32: prefill of ``batch`` x ``length`` positions, then ``steps`` decode
    steps at each row's next position, on the card (through K2 once and
    mla_decode once a step) and on the CPU (the plain versions), from the
    same weights; every output and the latent cache agree within ``tol``."""
    from repro_torch.models import blocks as TB

    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    blk = _cast(params["stack"]["prefix"]["blk0"], lambda t: t.float())
    a = cfg.attention
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(batch, length + steps, cfg.d_model, generator=gen)

    def run(dev, p):
        xs = x.to(dev)
        y, cache, _ = TB.apply_block(p, xs[:, :length], cfg32, "attn", "dense",
                                     mode="prefill")
        st = {"attn": {
            "ckv": torch.zeros(batch, length + steps, a.kv_lora_rank,
                               device=dev),
            "krope": torch.zeros(batch, length + steps, a.qk_rope_head_dim,
                                 device=dev)}}
        for key, leaf in cache["attn"].items():
            st["attn"][key][:, :length] = leaf
        outs = [y]
        for i in range(steps):
            y, st, _ = TB.apply_block(
                p, xs[:, length + i:length + i + 1], cfg32, "attn", "dense",
                mode="decode", cache=st,
                pos=torch.full((batch,), length + i, dtype=torch.int32,
                               device=dev))
            outs.append(y)
        return outs, st

    reset_counts(kernels)
    with torch.no_grad():
        card, card_st = run(device, blk)
        torch.cuda.synchronize()
        launches = launches_of(kernels)
        want = {name: 0 for name in kernels}
        want.update(flash_attention=1, mla_decode=steps)
        check(launches == want and all(ops.ref.calls == 0
                                       for ops in kernels.values()),
              f"the block launched {launches}, want {want}")
        t0 = time.perf_counter()
        cpu, cpu_st = run(torch.device("cpu"),
                          _cast(blk, lambda t: t.to("cpu", copy=True)))
        cpu_s = time.perf_counter() - t0
    errs, bad = [], False
    for got, ref in zip(card, cpu):
        e, b = _excess(torch, got.cpu(), ref, tol)
        errs.append(e)
        bad = bad or b
    for key in ("ckv", "krope"):
        e, b = _excess(torch, card_st["attn"][key].cpu(), cpu_st["attn"][key],
                       tol)
        errs.append(e)
        bad = bad or b
    print(f"  MLA block (prefill {batch} x {length}, {steps} decode steps), "
          f"card f32 vs CPU: max err prefill {errs[0]:.3e}, decode "
          f"{max(errs[1:steps + 1]):.3e}, cache {max(errs[-2:]):.3e} (atol "
          f"{tol['atol']}, rtol {tol['rtol']}); CPU {cpu_s:.1f} s", flush=True)
    check(not bad, "the MLA block on the card and on the CPU disagree")
    return dict(prefill_err=errs[0], decode_err=max(errs[1:steps + 1]),
                cache_err=max(errs[-2:]), launches=launches, cpu_s=cpu_s)


def moe_decode_ms(torch, cfg, params, device, slots=4):
    """Device ms of one MoE FFN (the first period's) at the decode step's
    shape: ``slots`` rows of one token."""
    from repro_torch.models import layers as L

    moe = _cast(params["stack"]["periods"]["sub0"]["ffn_moe"], lambda t: t[0])
    x = torch.randn(slots, 1, cfg.d_model, device=device,
                    generator=torch.Generator(device=device).manual_seed(6)
                    ).to(L.dtype_of(cfg.compute_dtype))
    with torch.no_grad():
        return time_ms(torch, lambda: L.apply_moe(
            moe, x, cfg, compute_dtype=x.dtype), reps=5, inner=5)[0]


# ---------------------------------------------------------------------------
# Phase 12: a decoder behind a modality prefix (internvl2-2b) and the
# encoder-decoder (seamless-m4t-large-v2), at full width and depth
# ---------------------------------------------------------------------------


def embeds_key(cfg) -> str:
    """The batch key of the frontend stub's embeddings."""
    return "frames" if cfg.family in ("audio", "encdec") else "prefix_embeds"


def stub_batch(torch, np, cfg, device, batch, n_embeds, n_tokens, seed=0):
    """A prefill batch: ``n_embeds`` normal embeddings a row (the frontend
    stub's patches or frames) and ``n_tokens`` prompt tokens, from
    ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    tokens = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                  size=(batch, n_tokens))
    return {embeds_key(cfg): torch.randn(batch, n_embeds, cfg.d_model,
                                         generator=gen, device=device),
            "tokens": torch.from_numpy(tokens).to(device)}


def self_positions(cfg, batch) -> int:
    """Positions of the self-attention cache after a prefill of ``batch``:
    the prefix and the prompt for a VLM, the prompt for an enc-dec."""
    n = batch["tokens"].shape[1]
    return n + (batch["prefix_embeds"].shape[1] if "prefix_embeds" in batch
                else 0)


def port_kernels_of(kern: dict, n: int = 1) -> dict:
    """{source stem: (device ms, launches)} per call of the port's kernels
    in a profiler's {kernel: (µs, launches)} over ``n`` calls."""
    out = {}
    for name, (us, count) in kern.items():
        m = re.match(r"(?:void )?\(anonymous namespace\)::(\w+)[<(]", name)
        stem = KERNEL_SOURCE.get(m[1]) if m else None
        if stem:
            ms, c = out.get(stem, (0.0, 0.0))
            out[stem] = (ms + us / n / 1e3, c + count / n)
    return out


def profile_calls(torch, fn, n: int) -> dict:
    """Host wall ms a call of ``fn`` (ending in a synchronise), then device
    kernel ms a call over ``n`` profiled calls, the device's idle share and
    the port's kernels' (ms, launches) a call."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / n * 1e3
    kern = profiled_kernels(torch, fn, n)
    device_ms = sum(us for us, _ in kern.values()) / n / 1e3
    top = sorted(kern.items(), key=lambda kv: -kv[1][0])[:6]
    return dict(wall_ms=wall_ms, device_ms=device_ms or None,
                idle=1 - device_ms / wall_ms if device_ms else None,
                port=port_kernels_of(kern, n),
                top=[(_short(k), us / n / 1e3, c / n) for k, (us, c) in top])


def _print_profile(what, prof):
    if prof["device_ms"]:
        print(f"  {what}: {prof['wall_ms']:.3f} ms host wall, "
              f"{prof['device_ms']:.4f} ms device kernel time, device idle "
              f"{prof['idle']:.1%}; port kernels "
              + ", ".join(f"{stem} {ms:.4f} ms in {c:.0f} launches"
                          for stem, (ms, c) in prof["port"].items()))
        for name, ms, c in prof["top"]:
            print(f"    {ms:8.4f} ms {c:5.0f}x  {name}")
    else:
        print(f"  {what}: {prof['wall_ms']:.3f} ms host wall; device time not "
              "measured (the profiler recorded no device kernels)")


def serve_stub_model(torch, cfg, params, device, kernels, steps, api, batch,
                     n_new, want_prefill, want_step):
    """Prefill ``batch`` through ``make_prefill_step``, grow the self cache
    to the prompt's positions plus ``n_new``, then ``n_new`` greedy
    ``make_serve_step`` calls.  The prefill must launch the kernels
    ``want_prefill`` names and each step those ``want_step`` names, each the
    given number of times, and no plain version.  Returns the timings, the
    tokens fed and each step's logits."""
    prefill, decode = steps.make_prefill_step(cfg), steps.make_serve_step(cfg)
    B = batch["tokens"].shape[0]
    S = self_positions(cfg, batch)
    reset_counts(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    last, cache = prefill(params, batch)
    tok = last.reshape(B, -1).argmax(dim=-1)
    tok.cpu()
    ttft_s = time.perf_counter() - t0
    launches_prefill = launches_of(kernels)
    check(launches_prefill == {name: want_prefill.get(name, 0)
                               for name in kernels}
          and all(ops.ref.calls == 0 for ops in kernels.values()),
          f"prefill launched {launches_prefill}, want {want_prefill}")
    state = api.grow_decode_state(cfg, cache, S + n_new)
    del cache
    reset_counts(kernels)
    fed, outs, times = [], [], []
    for i in range(n_new):
        t0 = time.perf_counter()
        fed.append(tok)
        lg, state = decode(params, state, tok, torch.full(
            (B,), S + i, dtype=torch.int32, device=device))
        tok = lg.argmax(dim=-1)
        tok.cpu()                         # the server's one sync a step
        times.append(time.perf_counter() - t0)
        outs.append(lg)
    launches_decode = launches_of(kernels)
    want = {name: n_new * want_step.get(name, 0) for name in kernels}
    check(launches_decode == want and all(ops.ref.calls == 0
                                          for ops in kernels.values()),
          f"{n_new} decode steps launched {launches_decode}, want {want}")
    check(all(bool(torch.isfinite(lg).all()) for lg in outs),
          "non-finite decode logits")
    tpot_ms = sorted(times[1:])[len(times[1:]) // 2] * 1e3
    tok_s = B * n_new / sum(times)
    print(f"  prefill of {B} rows x {S} positions: TTFT {ttft_s * 1e3:.1f} ms "
          f"(first call, host wall to the first tokens); {n_new} greedy "
          f"decode steps: TPOT {tpot_ms:.3f} ms median host wall (first "
          f"{times[0] * 1e3:.1f} ms), {tok_s:.1f} tok/s; launches prefill "
          f"{ {k: v for k, v in launches_prefill.items() if v} }, a step "
          f"{ {k: v / n_new for k, v in launches_decode.items() if v} }",
          flush=True)
    prof_prefill = profile_calls(torch, lambda: prefill(params, batch), 3)
    pos = torch.full((B,), S + n_new - 1, dtype=torch.int32, device=device)
    prof_step = profile_calls(
        torch, lambda: decode(params, state, tok, pos)[0].argmax(-1).cpu(), 3)
    _print_profile("prefill", prof_prefill)
    _print_profile(f"decode step (B={B}, {S + n_new} positions)", prof_step)
    return dict(ttft_ms=ttft_s * 1e3, tpot_ms=tpot_ms, first_step_ms=times[0]
                * 1e3, tok_s=tok_s, launches_prefill=launches_prefill,
                launches_decode=launches_decode, prefill=prof_prefill,
                step=prof_step, last=last.reshape(B, -1), fed=fed, outs=outs,
                S=S)


def check_against_forward(torch, cfg, params, kernels, steps, api, batch,
                          served):
    """The served model against one forward (bf16, as served): prefill's
    logits against forward's at the prompt's last position, and every
    decode step's against forward's over the prompt and the tokens fed, each
    by relative RMS within twice the distance of the bf16 prefill from the
    same prefill with the products in f32, plus 1e-3 (``PERF.md`` §2).  No
    plain version runs."""
    n_tok = batch["tokens"].shape[1]
    whole = dict(batch, tokens=torch.cat(
        [batch["tokens"], torch.stack(served["fed"], dim=1)], dim=1))
    reset_counts(kernels)
    with torch.no_grad():
        logits, _ = api.forward(params, cfg, whole, remat="none")
        last32, _ = steps.make_prefill_step(dataclasses.replace(
            cfg, compute_dtype="float32"))(params, batch)
    check(all(ops.ref.calls == 0 for ops in kernels.values()),
          "the plain versions ran on the card")
    off = logits.shape[1] - whole["tokens"].shape[1]      # prefix positions
    n_new = len(served["outs"])
    fwd_last = logits[:, off + n_tok - 1]
    fwd_dec = logits[:, off + n_tok:off + n_tok + n_new].transpose(0, 1)
    dec = torch.stack(served["outs"])
    rounding = _rel_rms(served["last"], last32.reshape(served["last"].shape))
    err_pre = _rel_rms(served["last"], fwd_last)
    err_dec = _rel_rms(dec, fwd_dec)
    agree = (served["last"].argmax(-1) == fwd_last.argmax(-1)).float().mean()
    print(f"  bf16: prefill vs forward relative RMS {err_pre:.3e}, decode vs "
          f"forward {err_dec:.3e} over {n_new} steps; bf16 vs f32 prefill "
          f"{rounding:.3e} (limit {2 * rounding + 1e-3:.3e}); prefill's "
          f"greedy token = forward's in {agree.item():.0%} of rows",
          flush=True)
    check(bool(torch.isfinite(logits).all()), "non-finite forward logits")
    check(err_pre <= 2 * rounding + 1e-3 and err_dec <= 2 * rounding + 1e-3,
          "prefill or decode and forward differ beyond bf16 rounding")
    return dict(prefill_vs_forward=err_pre, decode_vs_forward=err_dec,
                bf16_vs_f32=rounding)


def first_layers(torch, params, n: int):
    """A copy of ``params`` with each stacked layer axis (the LM's periods,
    the enc-dec's encoder and decoder) cut to its first ``n`` layers, in
    f32."""
    def cut(tree, key):
        return _cast(tree, lambda t: t[:n]) if key in (
            "periods", "encoder", "decoder") else tree

    def walk(tree):
        return {k: walk(cut(v, k)) if isinstance(v, dict) else v
                for k, v in tree.items()}

    return _cast(walk(params),
                 lambda t: t.float() if t.is_floating_point() else t.clone())


def card_vs_cpu(torch, np, cfg32, params32, device, kernels, steps, api, batch,
                want, n_new=4, tol=PREFILL_TOL):
    """Forward, prefill and ``n_new`` decode steps (fixed tokens, after the
    self cache grows) of an f32 model on the card and on the CPU from the
    same params and batch: every output and cache leaf within ``tol``.  The
    card's run must launch the kernels ``want`` names, each the given
    number of times, and no plain version."""
    B = batch["tokens"].shape[0]
    S = self_positions(cfg32, batch)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg32.vocab_size, size=(n_new, B)))
    out = {}
    for where, dev in (("card", device), ("cpu", torch.device("cpu"))):
        p = params32 if where == "card" else _to(torch, params32, dev)
        b = {k: v.to(dev) for k, v in batch.items()}
        reset_counts(kernels)
        t0 = time.perf_counter()
        with torch.no_grad():
            fwd, _ = api.forward(p, cfg32, b, remat="none")
            last, cache = steps.make_prefill_step(cfg32)(p, b)
            st = api.grow_decode_state(cfg32, cache, S + n_new)
            dec = [steps.make_serve_step(cfg32)(
                p, st, toks[i].to(dev), torch.full(
                    (B,), S + i, dtype=torch.int32, device=dev))[0]
                   for i in range(n_new)]
        got = {"forward": fwd, "prefill": last.reshape(B, -1),
               "decode": torch.stack(dec), **dict(_paths(cache))}
        if where == "card":
            torch.cuda.synchronize()
            launches = launches_of(kernels)
            check(launches == {name: want.get(name, 0) for name in kernels}
                  and all(ops.ref.calls == 0 for ops in kernels.values()),
                  f"the card's run launched {launches}, want {want}")
        out[where] = ({k: v.cpu() for k, v in got.items()},
                      time.perf_counter() - t0)
    (card, _), (cpu, cpu_s) = out["card"], out["cpu"]
    errs, bad = {}, []
    for key, want_t in cpu.items():
        errs[key], b = _excess(torch, card[key], want_t, tol)
        if b:
            bad.append(key)
    print(f"  {cfg32.num_layers} layers in f32, card vs CPU (B={B}, {S} "
          f"positions, {n_new} "
          f"decode steps): max err " + ", ".join(
              f"{k} {e:.2e}" for k, e in errs.items())
          + f" (atol {tol['atol']}, rtol {tol['rtol']}); CPU {cpu_s:.1f} s",
          flush=True)
    check(not bad, f"card and CPU disagree: {bad}")
    return dict(errs=errs, launches=launches, cpu_s=cpu_s)


def phase_stub_model(torch, np, cfg, device, kernels, steps, api, train,
                     adamw, OptimizerConfig, pipeline, *, n_embeds, n_tokens,
                     k2_layer, k1_layer, train_seq):
    """Phase 12 for one model of ``cfg`` (bf16, full width and depth, random
    weights from seed 0): serve 4 rows of ``n_embeds`` stub embeddings and
    ``n_tokens`` prompt tokens (K2 ``k2_layer`` times a layer in prefill,
    K1 ``k1_layer`` times a layer a decode step), 32 greedy steps; check
    them against one forward; hold the first 2 layers in f32 on the card to
    the CPU (forward, prefill, decode, one train step); then 3 steps of
    ``launch/train.py`` at batch 2 x ``train_seq`` on the model cut to half
    its depth, decoder and encoder (K2 and its backward ``k2_layer`` times a
    layer a step)."""
    t_phase = time.perf_counter()
    held_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = api.init_params(torch.Generator(device=device).manual_seed(0),
                             cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = list(_leaves(params))
    n_params = sum(t.numel() for t in leaves)
    gbytes = sum(t.numel() * t.element_size() for t in leaves) / 1e9
    del leaves
    layers = cfg.num_layers + cfg.encoder_layers
    a = cfg.attention
    print(f"  {cfg.name}: {layers} layers (encoder {cfg.encoder_layers}), "
          f"d_model {cfg.d_model}, {a.num_heads}/{a.num_kv_heads} heads of "
          f"{a.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
          f"{cfg.frontend.kind} stub; {n_params / 1e9:.3f} B "
          f"{cfg.param_dtype} params, {gbytes:.2f} GB; init {init_s:.1f} s "
          f"with {held_gb:.2f} GB held before it", flush=True)
    batch = stub_batch(torch, np, cfg, device, 4, n_embeds, n_tokens)
    want_prefill = {"flash_attention": k2_layer * cfg.num_layers}
    want_step = {"decode_attention": k1_layer * cfg.num_layers}
    secs, mark = {}, [time.perf_counter()]

    def lap(name):
        secs[name] = time.perf_counter() - mark[0]
        mark[0] = time.perf_counter()

    served = serve_stub_model(torch, cfg, params, device, kernels, steps,
                              api, batch, 32, want_prefill, want_step)
    lap("serve and profile")
    vs_forward = check_against_forward(torch, cfg, params, kernels, steps,
                                       api, batch, served)
    lap("against forward")
    for key in ("last", "fed", "outs"):
        served.pop(key)
    cfg32 = dataclasses.replace(cfg, num_layers=2, encoder_layers=min(
        cfg.encoder_layers, 2), param_dtype="float32", compute_dtype="float32")
    p32 = first_layers(torch, params, 2)
    del params, batch
    gc.collect()
    torch.cuda.empty_cache()
    small = stub_batch(torch, np, cfg32, torch.device("cpu"), 2, 32, 16,
                       seed=1)
    vs_cpu = card_vs_cpu(torch, np, cfg32, p32, device, kernels, steps, api,
                         small, {"flash_attention": 2 * k2_layer * 2,
                                 "decode_attention": 4 * k1_layer * 2})
    del p32
    gc.collect()
    torch.cuda.empty_cache()
    lap("2 layers card vs CPU")
    step_vs_cpu = phase_train_step_vs_cpu(
        torch, cfg32, device, kernels, steps, api, adamw, OptimizerConfig,
        pipeline, {"flash_attention": 2 * k2_layer,
                   "flash_attention_bwd": 2 * k2_layer}, seq=128,
        remat_modes=(), batch_of=lambda tokens: train.model_batch(
            cfg32, {"tokens": tokens}, torch.Generator().manual_seed(0)))
    gc.collect()
    torch.cuda.empty_cache()
    lap("train step vs CPU")
    torch.cuda.reset_peak_memory_stats()
    half = dataclasses.replace(cfg, num_layers=cfg.num_layers // 2,
                               encoder_layers=cfg.encoder_layers // 2)
    trained = phase_train(
        torch, np, half, kernels, steps, train, adamw,
        {"flash_attention": k2_layer * half.num_layers,
         "flash_attention_bwd": k2_layer * half.num_layers},
        n_steps=3, batch=2, seq=train_seq, profile_at=2, dtype="bfloat16",
        converge=False, arch=cfg.name, model_cfg=half)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    gc.collect()
    torch.cuda.empty_cache()
    lap("train.main")
    phase_s = time.perf_counter() - t_phase
    print(f"  {cfg.name}: training peak {peak_gb:.1f} GB allocated; "
          f"{phase_s:.1f} s for the model: "
          + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items()), flush=True)
    return dict(params=n_params, gbytes=gbytes, init_s=init_s,
                held_gb=held_gb, serve=served, vs_forward=vs_forward,
                vs_cpu=vs_cpu, train_step_vs_cpu=step_vs_cpu, train=trained,
                train_peak_gb=peak_gb, phase_s=phase_s, secs=secs)


# ---------------------------------------------------------------------------
# Phase 14: the dense GQA models of head dim 128, qwen2.5-14b whole and
# mistral-large-123b cut to its first 16 layers, bf16
# ---------------------------------------------------------------------------


def phase_dense_gqa(torch, np, cfg, device, kernels, steps, api, serve, *,
                    f32_layers, prefill_f32=True, cost_cells=None):
    """Phase 14 for one dense GQA model of ``cfg`` (bf16, random weights
    from seed 0): serve 4 requests (prompts of 16-64 tokens, 16 new tokens,
    4 slots, 128 positions; admission token by token, so flash-decode runs
    once a layer a decode call and flash attention never); profile the
    decode step of the 4 slots at positions 96, 80, 64 and 48 (5 steps);
    prefill = decode, 2 x 48 tokens, in bf16 against bf16's own rounding;
    the first ``f32_layers`` layers in f32: prefill = decode at 2e-3
    (``prefill_f32``) and the card against the CPU (forward, prefill, 4
    decode steps) at 2e-3.  ``cost_cells``, a
    list, gains the decode step of 4 slots over 128 positions and a
    prefill of 4 x 128, each counted by the dry run against the card."""
    t_phase = time.perf_counter()
    pos = (96, 80, 64, 48)
    held_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = api.init_params(torch.Generator(device=device).manual_seed(0),
                             cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = list(_leaves(params))
    n_params = sum(t.numel() for t in leaves)
    gbytes = sum(t.numel() * t.element_size() for t in leaves) / 1e9
    del leaves
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    a, L = cfg.attention, cfg.num_layers
    print(f"  {cfg.name}: {L} layers, d_model {cfg.d_model}, "
          f"{a.num_heads}/{a.num_kv_heads} heads of {a.head_dim} (group "
          f"{a.num_heads // a.num_kv_heads}), QKV bias {a.qkv_bias}, "
          f"rope_theta {a.rope_theta:g}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}; {n_params / 1e9:.3f} B {cfg.param_dtype} "
          f"params, {gbytes:.2f} GB; init {init_s:.1f} s, peak {peak_gb:.1f} "
          f"GB with {held_gb:.2f} GB held before it", flush=True)
    secs, mark = {}, [time.perf_counter()]

    def lap(name):
        secs[name] = time.perf_counter() - mark[0]
        mark[0] = time.perf_counter()

    served = phase_serve(torch, np, cfg, params, device, kernels, serve,
                         max_len=128, n_requests=4, max_new=16,
                         prompt_range=(16, 65))
    want = {name: 0 for name in kernels}
    want["decode_attention"] = L * served["decode_calls"]
    check(served["launches"] == want, f"serving {cfg.name} launched "
          f"{served['launches']}, want {want} ({L} layers, "
          f"{served['decode_calls']} decode calls, admission token by token)")
    lap("serve")
    print(f"  decode step over a 128-position cache (4 slots at "
          f"{', '.join(map(str, pos))}), 5 steps:")
    prof = phase_profile(torch, cfg, params, device, steps, api, max_len=128,
                         n=5, pos=pos)
    lap("profile")
    print(f"  prefill = decode, 2 x 48 tokens, in bf16 as served, against "
          "bf16's own rounding", flush=True)
    reset_counts(kernels)
    pre = phase_prefill_bf16(torch, np, cfg, params, device, steps, api,
                             length=48)
    n = launches_of(kernels)
    want = {name: 0 for name in kernels}
    want.update(flash_attention=2 * L, decode_attention=48 * L)
    check(n == want, f"prefill = decode launched {n}, want {want}")
    torch.cuda.empty_cache()
    lap("prefill = decode bf16")
    if cost_cells is not None:
        from repro_torch.core.config import ShapeConfig
        from repro_torch.kernels import sm_count
        sms = sm_count(torch.device(device))
        section(f"== 13f. the count against the card: {cfg.name} bf16 decode "
                "(4 slots, 128 positions)")
        state = api.allocate_decode_state(cfg, 4, 128, device)
        cost_cells.append(phase_cost_cell(
            torch, f"{cfg.name} decode B 4 S 128", cfg,
            ShapeConfig("decode", 128, 4, "decode"),
            steps.make_serve_step(cfg),
            (params, state, torch.arange(1, 5, dtype=torch.int32,
                                         device=device),
             torch.tensor(pos, dtype=torch.int32, device=device)),
            kernels, want=("decode_attention",),
            scratch=kernels["decode_attention"].scratch_bytes(
                torch.empty(4, a.num_heads, a.head_dim, dtype=torch.bfloat16,
                            device="meta"),
                torch.empty(4, a.num_kv_heads, 128, a.head_dim,
                            dtype=torch.bfloat16, device="meta"), sms)))
        del state
        section(f"== 13g. the count against the card: {cfg.name} bf16 prefill "
                "4 x 128")
        cost_cells.append(phase_cost_cell(
            torch, f"{cfg.name} prefill 4 x 128", cfg,
            ShapeConfig("prefill", 128, 4, "prefill"),
            steps.make_prefill_step(cfg),
            (params, {"tokens": _prompts(torch, np, cfg, device, 4, 128)}),
            kernels, want=("flash_attention",)))
        torch.cuda.empty_cache()
        lap("cost cells")
    cfg32 = dataclasses.replace(cfg, num_layers=f32_layers,
                                param_dtype="float32", compute_dtype="float32")
    p32 = first_layers(torch, params, f32_layers)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    pre32 = None
    if prefill_f32:
        print(f"  prefill = decode, 2 x 48 tokens, the first {f32_layers} "
              "layers in f32 at 2e-3", flush=True)
        pre32 = phase_prefill(torch, np, cfg32, p32, device, kernels,
                              {"flash_attention": f32_layers}, steps, api,
                              batch=2, length=48)
        lap("prefill = decode f32")
    small = {"tokens": _prompts(torch, np, cfg, torch.device("cpu"), 2, 24)}
    vs_cpu = card_vs_cpu(torch, np, cfg32, p32, device, kernels, steps, api,
                         small, {"flash_attention": 2 * f32_layers,
                                 "decode_attention": 4 * f32_layers})
    del p32
    gc.collect()
    torch.cuda.empty_cache()
    lap("card vs CPU")
    phase_s = time.perf_counter() - t_phase
    print(f"  {cfg.name}: {phase_s:.1f} s for the model: "
          + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items()), flush=True)
    return dict(params=n_params, gbytes=gbytes, init_s=init_s,
                peak_gb=peak_gb, held_gb=held_gb, serve=served, profile=prof,
                prefill_bf16=pre, prefill_f32=pre32, vs_cpu=vs_cpu,
                phase_s=phase_s, secs=secs)


def _k1_lse_case(torch, dops, B, Hq, Hkv, S, hd, lens, dtype, gen) -> dict:
    """K1's (out, lse) against its plain version at one shape, and K1 over
    the cache cut along its keys into 2 and 16 shards (kv_len clamped to
    each shard; some hold no valid key), merged by log-sum-exp, against K1
    over the whole cache.  Returns the errors."""
    dt = getattr(torch, dtype)
    q = torch.randn(B, Hq, hd, device="cuda", generator=gen).to(dt)
    k = torch.randn(B, Hkv, S, hd, device="cuda", generator=gen).to(dt)
    v = torch.randn(B, Hkv, S, hd, device="cuda", generator=gen).to(dt)
    kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
    out, lse = dops.decode_attention(q, k, v, kv_len, return_lse=True)
    ref_out, ref_lse = dops.decode_attention_ref(q, k, v, kv_len,
                                                 return_lse=True)
    row = {"shape": f"B={B} Hq={Hq} Hkv={Hkv} S={S} hd={hd} kv_len={lens}",
           "dtype": dtype,
           "out_err": _within(torch, out, ref_out, TOL[dtype]),
           "lse_err": _within(torch, lse, ref_lse, TOL[dtype])}
    row["max_abs_err"] = max(row["out_err"], row["lse_err"])
    check(torch.equal(dops.decode_attention(q, k, v, kv_len), out),
          "decode_attention: the output changes with return_lse")
    # times with the log-sum-exp, its plain version's, and without it
    keys = sum(min(max(n, 0), S) for n in lens)
    flops, nbytes = dops.cost(q, k, v, kv_len, keys=keys, with_lse=True)
    row.update(**_timings(
        torch, lambda: dops.decode_attention(q, k, v, kv_len, return_lse=True),
        lambda: dops.decode_attention_ref(q, k, v, kv_len, return_lse=True),
        None), **_bound(nbytes, flops, dtype))
    row["ms_no_lse"] = time_ms(torch, lambda: dops.decode_attention(
        q, k, v, kv_len))[0]
    for n in (2, 16):
        chunk = S // n
        outs, lses = [], []
        for i in range(n):
            part = slice(i * chunk, (i + 1) * chunk)
            m = (kv_len - i * chunk).clamp(0, chunk).to(torch.int32)
            o, ls = dops.decode_attention(q, k[:, :, part].contiguous(),
                                          v[:, :, part].contiguous(), m,
                                          return_lse=True)
            outs.append(o)
            lses.append(ls)
        empty = int(torch.isinf(torch.stack(lses)).all(-1).sum())
        check(empty > 0, f"decode_attention: no empty shard at {n} shards")
        merged = dops.merge_partials(torch.stack(outs), torch.stack(lses))
        check(bool(torch.isfinite(merged).all()), "merge: not finite")
        row[f"merge_{n}_err"] = _within(torch, merged, out, TOL[dtype])
        row[f"merge_{n}_empty"] = empty
    print(f"  k1 lse {dtype} {row['shape']}: {row['ms']:.4f} ms (without "
          f"the lse {row['ms_no_lse']:.4f}, plain {row['plain_ms']:.4f}, bound "
          f"{row['bound_ms']:.5f} by {row['bound_by']}); out "
          f"{row['out_err']:.2e} lse "
          f"{row['lse_err']:.2e}; merged over 2 / 16 key shards "
          f"{row['merge_2_err']:.2e} / {row['merge_16_err']:.2e} "
          f"({row['merge_2_empty']} / {row['merge_16_empty']} (row, head) "
          "shards with no key)", flush=True)
    return row


# granite-moe-1b-a400m in phase 15 (a): 4 prompts of 96 tokens, 8 decode
# steps, a train step of 2 x 256 (as phase 2's granite rows)
MOE_B, MOE_S, MOE_NEW, MOE_TRAIN = 4, 96, 8, (2, 256)
# the mesh's bf16 logits against no mesh's: phase 15 (a)'s relative RMS
# for bf16 products (a one-rank mesh's 2-D products and norms' sums round
# otherwise than the plain ones; a router near a tie may then choose
# another expert for a token, which a max |diff| would not tolerate)
MESH_BF16_RMS = 5e-2


def _moves(adamw, sh, after_mesh, after_none, before) -> tuple:
    """Each param's move, a mesh's step against no mesh's: (max |diff|,
    the largest move, relative RMS of the difference)."""
    err = moved = sq_err = sq_move = 0.0
    for a, b, c in zip(adamw.leaves(after_mesh), adamw.leaves(after_none),
                       adamw.leaves(before)):
        d_mesh, d_none = sh.full(a) - c, b - c
        err = max(err, float((d_mesh - d_none).abs().max()))
        moved = max(moved, float(d_none.abs().max()))
        sq_err += float((d_mesh - d_none).double().square().sum())
        sq_move += float(d_none.double().square().sum())
    return err, moved, (sq_err / sq_move) ** 0.5


def phase_mesh_moe(torch, np, device, mesh, kernels, steps, api, adamw,
                   get_arch, OptimizerConfig, ShapeConfig, gen) -> dict:
    """Phase 15 (a) for the MoE family: granite-moe-1b-a400m at full width
    and depth (24 layers, 32 experts top-8, bf16, random weights from seed
    17) with no mesh and on the one-rank ``mesh``, its experts on "model":
    a prefill of 4 x 96 tokens and 8 decode steps from no mesh's cache,
    then one train step of 2 x 256 with f32 params and bf16 products.  The
    mesh's logits, loss, gradient norm and param moves are held to no
    mesh's; K1, K2 and K2's backward are counted in each run; the device
    ms of a decode step (both) and of the train step (no mesh)."""
    from repro_torch import sharding as sh
    from repro_torch.launch import mesh as mesh_lib

    t0 = time.perf_counter()
    cfg = get_arch("granite-moe-1b-a400m").model
    L, B, S, new = cfg.num_layers, MOE_B, MOE_S, MOE_NEW
    params = api.init_params(torch.Generator(device).manual_seed(17), cfg)
    n_params = sum(t.numel() for t in _leaves(params))
    tokens = torch.randint(0, cfg.vocab_size, (B, S + new), device=device,
                           generator=gen, dtype=torch.int32)
    prefill, serve_step = steps.make_prefill_step(cfg), \
        steps.make_serve_step(cfg)
    pspecs = mesh_lib.shardings_for(cfg, ShapeConfig("p", S, B, "prefill"),
                                    mesh, params, None,
                                    {"tokens": tokens[:, :S]})
    want_prefill = {name: 0 for name in kernels}
    want_prefill["flash_attention"] = L
    want_decode = {name: 0 for name in kernels}
    want_decode["decode_attention"] = L * new

    def run_serving(on):
        """(prefill logits, stacked decode logits, launches of each, the
        decode state, tokens' layout, rules) with or without the mesh."""
        # decode lays the cache on its keys where "model" is over 1
        # (seq_parallel), prefill does not
        rules = (lambda sp=False: sh.activation_rules(
            mesh if on else None, seq_parallel=sp and on))
        p, batch = params, {"tokens": tokens[:, :S]}
        if on:
            p = sh.distribute_tree(params, pspecs["params"], mesh)
            batch = sh.distribute_tree(batch, pspecs["batch"], mesh)
        reset_counts(kernels)
        with rules():
            logits, cache = prefill(p, batch)
        logits = sh.full(logits)
        torch.cuda.synchronize()
        n_pre = launches_of(kernels)
        if not on:
            first_cache.append(cache)
        del cache
        state = api.grow_decode_state(cfg, first_cache[0], S + new)
        put = (lambda t: t)
        if on:
            dspecs = mesh_lib.shardings_for(
                cfg, ShapeConfig("d", S + new, B, "decode"), mesh, params,
                None, {"tokens": tokens[:, S], "state": state},
                seq_parallel=True)
            state = sh.distribute_tree(state, dspecs["state"], mesh)
            put = (lambda t: sh.distribute(t, dspecs["tokens"], mesh))
        reset_counts(kernels)
        out = []
        for i in range(new):
            with rules(True):
                lg, state = serve_step(p, state, put(tokens[:, S + i]),
                                       torch.tensor(S + i, device=device))
            out.append(sh.full(lg))
        torch.cuda.synchronize()
        n_dec = launches_of(kernels)
        check(n_pre == want_prefill and n_dec == want_decode,
              f"granite {'mesh' if on else 'no mesh'}: prefill launched "
              f"{n_pre} (want {want_prefill}), decode {n_dec} (want "
              f"{want_decode})")
        tok, at = put(tokens[:, S]), torch.tensor(S, device=device)

        def step():
            with rules(True):
                lg, _ = serve_step(p, state, tok, at)
            return sh.full(lg).argmax(dim=-1).cpu()

        prof = profile_calls(torch, step, 3)
        return logits, torch.stack(out), n_pre, n_dec, prof

    first_cache = []        # no mesh's prefill cache seeds both decodes
    pre0, dec0, _, _, prof0 = run_serving(False)
    pre1, dec1, n_pre, n_dec, prof1 = run_serving(True)
    del first_cache
    rms_p, rms_d = _rel_rms(pre1, pre0), _rel_rms(dec1, dec0)
    err_p = float((pre1 - pre0).abs().max())
    err_d = float((dec1 - dec0).abs().max())
    agree = float((dec1.argmax(-1) == dec0.argmax(-1)).float().mean())
    check(bool(torch.isfinite(pre1).all() and torch.isfinite(dec1).all()),
          "granite on the mesh: logits not finite")
    check(rms_p <= MESH_BF16_RMS and rms_d <= MESH_BF16_RMS,
          f"granite mesh (1, 1) != no mesh: relative RMS prefill {rms_p}, "
          f"decode {rms_d} (tolerance {MESH_BF16_RMS})")
    print(f"  (a) {cfg.name} bf16 ({L} layers, {cfg.moe.num_experts} "
          f"experts top-{cfg.moe.num_experts_per_tok}, {n_params / 1e9:.3f} "
          f"B params), {B} x {S} prefill + {new} decode steps: mesh (1, 1) vs "
          f"none: prefill max |diff| {err_p:.3g}, relative RMS {rms_p:.3g}; "
          f"decode max |diff| {err_d:.3g}, relative RMS {rms_d:.3g} "
          f"(tolerance {MESH_BF16_RMS}), argmax agreement {agree:.3f}; "
          f"launches prefill {n_pre}, decode {n_dec}", flush=True)
    for what, prof in (("decode step, no mesh", prof0),
                       ("decode step, mesh (1, 1)", prof1)):
        _print_profile(f"{cfg.name} {what}", prof)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # ---- one train step, f32 params and bf16 products, as qwen's -----
    opt_cfg = OptimizerConfig(warmup_steps=0, eps=1e-3)
    lr = opt_cfg.lr
    tb, ts = MOE_TRAIN
    cfg_t = dataclasses.replace(cfg, param_dtype="float32")
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (tb, ts),
                                     device=device, generator=gen,
                                     dtype=torch.int32)}
    p_t = api.init_params(torch.Generator(device).manual_seed(18), cfg_t)
    p_init = _cast(p_t, lambda t: t.clone())
    step = steps.make_train_step(cfg_t, opt_cfg, remat="none")
    opt = adamw.init_opt_state(p_t, opt_cfg)
    tspecs = mesh_lib.shardings_for(cfg_t, ShapeConfig("t", ts, tb, "train"),
                                    mesh, p_t, opt, batch)
    want_t = {name: 0 for name in kernels}
    want_t.update(flash_attention=L, flash_attention_bwd=L)
    with sh.activation_rules(mesh):
        pm = sh.distribute_tree(p_t, tspecs["params"], mesh)
        om = sh.distribute_tree(opt, tspecs["opt_state"], mesh)
        bm = sh.distribute_tree(batch, tspecs["batch"], mesh)
        reset_counts(kernels)
        pm, _, m1 = step(pm, om, bm)
        torch.cuda.synchronize()
        launches_t1 = launches_of(kernels)
    del om
    reset_counts(kernels)
    p_t, opt, m0 = step(p_t, opt, batch)
    torch.cuda.synchronize()
    launches_t0 = launches_of(kernels)
    err_loss = abs(float(m1["loss"].full_tensor()) - float(m0["loss"]))
    err_aux = abs(float(m1["aux"].full_tensor()) - float(m0["aux"]))
    err_norm = abs(float(m1["grad_norm"]) - float(m0["grad_norm"]))
    err_move, moved, rel_move = _moves(adamw, sh, pm, p_t, p_init)
    del pm, p_init
    gc.collect()
    tol_t = dict(loss=1e-4, grad_norm=1e-3 * float(m0["grad_norm"]),
                 move=lr / 2, move_rms=5e-2)
    check(err_loss <= tol_t["loss"] and err_aux <= tol_t["loss"]
          and err_norm <= tol_t["grad_norm"] and moved > lr / 2
          and err_move <= tol_t["move"] and rel_move <= tol_t["move_rms"],
          f"granite mesh train step != no mesh: loss {err_loss}, aux "
          f"{err_aux}, grad norm {err_norm}, params' move max {moved} (lr "
          f"{lr}), its max |diff| {err_move}, relative RMS {rel_move} "
          f"(tolerances {tol_t})")
    check(launches_t1 == launches_t0 == want_t,
          f"granite train launches {launches_t1} vs {launches_t0}, want "
          f"{want_t}")
    print(f"  (a) {cfg.name} train step {tb} x {ts} (f32 params, bf16 "
          f"products; lr {lr}, no warmup, eps 1e-3): mesh vs none: |d loss| "
          f"{err_loss:.3g} (loss {float(m0['loss']):.4f}), |d aux| "
          f"{err_aux:.3g} (aux {float(m0['aux']):.4f}), |d grad norm| "
          f"{err_norm:.3g}; params moved up to {moved:.3g}, the moves' max "
          f"|diff| {err_move:.3g}, relative RMS {rel_move:.3g} (tolerances "
          f"{tol_t}); launches {launches_t1}", flush=True)
    prof_t = profile_calls(torch, lambda: step(p_t, opt, batch), 1)
    _print_profile(f"{cfg.name} train step {tb} x {ts}, no mesh", prof_t)
    del p_t, opt, m0, m1
    gc.collect()
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t0
    print(f"  (a) {cfg.name}: {phase_s:.1f} s", flush=True)
    return dict(params=n_params, prefill_err=err_p, prefill_rel_rms=rms_p,
                decode_err=err_d, decode_rel_rms=rms_d, argmax_agree=agree,
                tol=MESH_BF16_RMS, launches_prefill=n_pre,
                launches_decode=n_dec, decode_profile=prof0,
                decode_profile_mesh=prof1,
                train=dict(loss_err=err_loss, aux_err=err_aux,
                           grad_norm_err=err_norm, max_move=moved,
                           move_err=err_move, move_rel_rms=rel_move,
                           tol=tol_t, launches=launches_t1,
                           profile=prof_t),
                phase_s=phase_s)


# jamba-1.5-large-398b in phase 15 (a): CARD (its first 5 layers, bf16)
# prefills 2 prompts of 128 tokens and decodes 8 steps; TRAIN_CARD (its
# first layer, f32) takes one train step of 2 x 512
HYB_B, HYB_S, HYB_NEW, HYB_TRAIN = 2, 128, 8, (2, 512)


def _share_tree(tree, specs, mesh):
    """``tree`` as DTensors of ``specs`` on a one-rank ``mesh`` over the
    leaves' own storage (each rank's shard is the whole leaf), where
    ``sh.distribute`` copies each shard: two 48 GB trees do not fit on one
    card."""
    from torch.distributed.tensor import DTensor

    from repro_torch import sharding as sh
    check(mesh.size() == 1, "_share_tree takes a one-rank mesh")
    if isinstance(tree, dict):
        return {k: _share_tree(v, specs[k], mesh) for k, v in tree.items()}
    return DTensor.from_local(tree, mesh, sh.placements(specs, mesh),
                              run_check=False, shape=tree.shape,
                              stride=tree.stride())


def phase_mesh_hybrid(torch, np, device, mesh, kernels, steps, api, adamw,
                      OptimizerConfig, ShapeConfig, gen) -> dict:
    """Phase 15 (a) for the hybrid family: jamba-1.5-large-398b ``CARD``
    (its first 5 layers at full width in bf16, random weights from seed
    19: every kind of block, 4 Mamba mixers, one attention layer, two MoE
    FFNs) with no mesh and on the one-rank ``mesh`` over the same storage
    (``_share_tree``, held by data_ptr), its Mamba channels on "model": a
    prefill of 2 x 128 tokens and 8 decode steps from no mesh's cache; then
    ``TRAIN_CARD`` (its first layer) in f32, one train step of 2 x 512
    through K3's backward, with and without the mesh.  Logits are held to
    no mesh's at ``MESH_BF16_RMS``, the step's loss, gradient norm and
    each param's move at qwen's f32 tolerances (moves within lr / 100); K1,
    K2, K3 and K3's backward are counted in each run."""
    from repro_torch import sharding as sh
    from repro_torch.configs.jamba_1_5_large_398b import CARD, TRAIN_CARD
    from repro_torch.launch import mesh as mesh_lib

    t0 = time.perf_counter()
    cfg = CARD
    kinds = cfg.layer_kinds()
    n_ssm, n_attn = kinds.count("ssm"), kinds.count("attn")
    B, S, new = HYB_B, HYB_S, HYB_NEW
    params = api.init_params(torch.Generator(device).manual_seed(19), cfg)
    n_params = sum(t.numel() for t in _leaves(params))
    tokens = torch.randint(0, cfg.vocab_size, (B, S + new), device=device,
                           generator=gen, dtype=torch.int32)
    batch = {"tokens": tokens[:, :S]}
    prefill, serve_step = steps.make_prefill_step(cfg), \
        steps.make_serve_step(cfg)
    want_prefill = {name: 0 for name in kernels}
    want_prefill.update(ssm_scan=n_ssm, flash_attention=n_attn)
    want_decode = {name: 0 for name in kernels}
    want_decode.update(ssm_scan=n_ssm * new, decode_attention=n_attn * new)

    def decode(p, state, put, on):
        out = []
        for i in range(new):
            with sh.activation_rules(mesh if on else None,
                                     seq_parallel=on):
                lg, state = serve_step(p, state, put(tokens[:, S + i]),
                                       torch.tensor(S + i, device=device))
            out.append(sh.full(lg))
        torch.cuda.synchronize()
        return torch.stack(out)

    # no mesh; its prefill cache seeds both decodes
    reset_counts(kernels)
    pre0, cache = prefill(params, batch)
    torch.cuda.synchronize()
    n_pre0 = launches_of(kernels)
    state0 = api.grow_decode_state(cfg, cache, S + new)
    del cache
    start = _cast(state0, lambda t: t.clone())
    reset_counts(kernels)
    dec0 = decode(params, state0, lambda t: t, False)
    n_dec0 = launches_of(kernels)
    del state0
    # the mesh, over the same params
    pspecs = mesh_lib.shardings_for(cfg, ShapeConfig("p", S, B, "prefill"),
                                    mesh, params, None, batch)
    pm = _share_tree(params, pspecs["params"], mesh)
    shared = all(a.to_local().data_ptr() == b.data_ptr()
                 for a, b in zip(_leaves(pm), _leaves(params)))
    check(shared, "jamba CARD's one-rank DTensors copy the params")
    reset_counts(kernels)
    with sh.activation_rules(mesh):
        pre1, _ = prefill(pm, sh.distribute_tree(batch, pspecs["batch"],
                                                 mesh))
    pre1 = sh.full(pre1)
    torch.cuda.synchronize()
    n_pre1 = launches_of(kernels)
    dspecs = mesh_lib.shardings_for(
        cfg, ShapeConfig("d", S + new, B, "decode"), mesh, params, None,
        {"tokens": tokens[:, S], "state": start}, seq_parallel=True)
    state1 = sh.distribute_tree(start, dspecs["state"], mesh)
    del start
    reset_counts(kernels)
    dec1 = decode(pm, state1, lambda t: sh.distribute(t, dspecs["tokens"],
                                                      mesh), True)
    n_dec1 = launches_of(kernels)
    check(n_pre0 == n_pre1 == want_prefill and n_dec0 == n_dec1 ==
          want_decode, f"jamba CARD: prefill launched {n_pre0} / {n_pre1} "
          f"(no mesh / mesh; want {want_prefill}), decode {n_dec0} / "
          f"{n_dec1} (want {want_decode})")
    rms_p, rms_d = _rel_rms(pre1, pre0), _rel_rms(dec1, dec0)
    err_p = float((pre1 - pre0).abs().max())
    err_d = float((dec1 - dec0).abs().max())
    check(bool(torch.isfinite(pre1).all() and torch.isfinite(dec1).all()),
          "jamba on the mesh: logits not finite")
    check(rms_p <= MESH_BF16_RMS and rms_d <= MESH_BF16_RMS,
          f"jamba mesh (1, 1) != no mesh: relative RMS prefill {rms_p}, "
          f"decode {rms_d} (tolerance {MESH_BF16_RMS})")
    print(f"  (a) {cfg.name} CARD bf16 ({cfg.num_layers} layers: {n_ssm} "
          f"Mamba, {n_attn} attention, {cfg.ffn_kinds().count('moe')} MoE; "
          f"{n_params / 1e9:.2f} B params, the mesh's DTensors over their "
          f"storage: {shared}), {B} x {S} prefill + {new} decode steps: mesh "
          f"(1, 1) vs none: prefill max |diff| {err_p:.3g}, relative RMS "
          f"{rms_p:.3g}; decode max |diff| {err_d:.3g}, relative RMS "
          f"{rms_d:.3g} (tolerance {MESH_BF16_RMS}); launches prefill "
          f"{n_pre1}, decode {n_dec1}", flush=True)
    del params, pm, state1, pre0, pre1, dec0, dec1
    gc.collect()
    torch.cuda.empty_cache()

    # ---- TRAIN_CARD: one train step in f32, K3's backward on the mesh ----
    opt_cfg = OptimizerConfig(warmup_steps=0, eps=1e-3)
    lr = opt_cfg.lr
    tb, ts = HYB_TRAIN
    cfg_t = dataclasses.replace(TRAIN_CARD, param_dtype="float32",
                                compute_dtype="float32")
    tbatch = {"tokens": torch.randint(0, cfg_t.vocab_size, (tb, ts),
                                      device=device, generator=gen,
                                      dtype=torch.int32)}
    p_init = api.init_params(torch.Generator(device).manual_seed(20), cfg_t)
    step = steps.make_train_step(cfg_t, opt_cfg, remat="none")
    want_t = {name: 0 for name in kernels}
    want_t.update(ssm_scan=1, ssm_scan_bwd=1)
    p_mesh = _cast(p_init, lambda t: t.clone())
    opt = adamw.init_opt_state(p_mesh, opt_cfg)
    tspecs = mesh_lib.shardings_for(cfg_t, ShapeConfig("t", ts, tb, "train"),
                                    mesh, p_mesh, opt, tbatch)
    with sh.activation_rules(mesh):
        pm = _share_tree(p_mesh, tspecs["params"], mesh)
        om = _share_tree(opt, tspecs["opt_state"], mesh)
        reset_counts(kernels)
        pm, om, m1 = step(pm, om, sh.distribute_tree(
            tbatch, tspecs["batch"], mesh))
        torch.cuda.synchronize()
        launches_t1 = launches_of(kernels)
    loss1, norm1 = float(m1["loss"].full_tensor()), float(m1["grad_norm"])
    del om, opt, m1       # the mesh's moments: 16.8 GB
    gc.collect()
    torch.cuda.empty_cache()
    p_t = _cast(p_init, lambda t: t.clone())
    opt = adamw.init_opt_state(p_t, opt_cfg)
    reset_counts(kernels)
    p_t, opt, m0 = step(p_t, opt, tbatch)
    torch.cuda.synchronize()
    launches_t0 = launches_of(kernels)
    loss0, norm0 = float(m0["loss"]), float(m0["grad_norm"])
    err_move, moved, rel_move = _moves(adamw, sh, pm, p_t, p_init)
    tol_t = dict(loss=1e-4, grad_norm=1e-3 * norm0, move=lr / 100,
                 move_rms=1e-3)
    err_loss, err_norm = abs(loss1 - loss0), abs(norm1 - norm0)
    check(err_loss <= tol_t["loss"] and err_norm <= tol_t["grad_norm"]
          and moved > lr / 2 and err_move <= tol_t["move"]
          and rel_move <= tol_t["move_rms"],
          f"jamba TRAIN_CARD mesh train step != no mesh: loss {err_loss}, "
          f"grad norm {err_norm}, params' move max {moved} (lr {lr}), its "
          f"max |diff| {err_move}, relative RMS {rel_move} (tolerances "
          f"{tol_t})")
    check(launches_t1 == launches_t0 == want_t,
          f"jamba train launches {launches_t1} vs {launches_t0}, want "
          f"{want_t}")
    n_train = sum(t.numel() for t in _leaves(p_init))
    print(f"  (a) {cfg_t.name} TRAIN_CARD f32 ({n_train / 1e9:.2f} B params)"
          f" train step {tb} x {ts} (lr {lr}, no warmup, eps 1e-3): mesh vs "
          f"none: |d loss| {err_loss:.3g} (loss {loss0:.4f}), |d grad norm| "
          f"{err_norm:.3g}; params moved up to {moved:.3g}, the moves' max "
          f"|diff| {err_move:.3g}, relative RMS {rel_move:.3g} (tolerances "
          f"{tol_t}); launches {launches_t1}", flush=True)
    del p_t, p_mesh, pm, p_init, opt, m0
    gc.collect()
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t0
    print(f"  (a) {cfg.name}: {phase_s:.1f} s", flush=True)
    return dict(params=n_params, shared_storage=shared, prefill_err=err_p,
                prefill_rel_rms=rms_p, decode_err=err_d,
                decode_rel_rms=rms_d, tol=MESH_BF16_RMS,
                launches_prefill=n_pre1, launches_decode=n_dec1,
                train=dict(params=n_train, loss_err=err_loss,
                           grad_norm_err=err_norm, max_move=moved,
                           move_err=err_move, move_rel_rms=rel_move,
                           tol=tol_t, launches=launches_t1),
                phase_s=phase_s)


# rwkv6-1.6b in phase 15 (a): whole, f32, prefills 4 prompts of 128 tokens
# and decodes 8 steps; its first 4 layers take one f32 train step of 2 x 512
RWKV_B, RWKV_S, RWKV_NEW, RWKV_TRAIN, RWKV_TRAIN_LAYERS = 4, 128, 8, \
    (2, 512), 4
# mesh against none, f32 (the one-rank mesh's LayerNorms take their
# variance as a mean of squares and its lora products as 2-D products, so
# the two paths round apart): the logits' max |diff| (read 4.3e-5), and
# each state leaf's (the prefill cache's, the decoded state's) relative
# RMS, which scales with the state's magnitude (read 6.1e-6 on a prefill
# cache whose values reach 178, where its max |diff| is 6.8e-4)
RWKV_LOGITS_TOL = 1e-4
RWKV_STATE_RMS = 2e-5


def phase_mesh_rwkv(torch, np, device, mesh, kernels, steps, api, adamw,
                    OptimizerConfig, ShapeConfig, gen) -> dict:
    """Phase 15 (a) for the RWKV-6 family: rwkv6-1.6b whole (24 layers) in
    f32, random weights from seed 21, with no mesh and on the one-rank
    ``mesh`` over the same storage (``_share_tree``, held by data_ptr), its
    heads on "model": a prefill of 4 x 128 tokens through K4 and 8 decode
    steps (the closed form: no K4) from no mesh's cache, the logits held to
    no mesh's at ``RWKV_LOGITS_TOL`` and the state (the prefill cache, the
    state after decoding) at ``RWKV_STATE_RMS``; then its first 4 layers in f32, one
    train step of 2 x 512 through K4's backward, with and without the mesh,
    the loss, gradient norm and each param's move held at qwen's f32
    tolerances (moves within lr / 100).  K4 and K4's backward are counted
    in each run."""
    from repro_torch import sharding as sh
    from repro_torch.configs.rwkv6_1_6b import FULL
    from repro_torch.launch import mesh as mesh_lib

    t0 = time.perf_counter()
    cfg = dataclasses.replace(FULL, param_dtype="float32",
                              compute_dtype="float32")
    B, S, new = RWKV_B, RWKV_S, RWKV_NEW
    params = api.init_params(torch.Generator(device).manual_seed(21), cfg)
    n_params = sum(t.numel() for t in _leaves(params))
    tokens = torch.randint(0, cfg.vocab_size, (B, S + new), device=device,
                           generator=gen, dtype=torch.int32)
    batch = {"tokens": tokens[:, :S]}
    prefill, serve_step = steps.make_prefill_step(cfg), \
        steps.make_serve_step(cfg)
    want_prefill = {name: 0 for name in kernels}
    want_prefill.update(rwkv6_scan=cfg.num_layers)
    want_decode = {name: 0 for name in kernels}

    def decode(p, state, put, on):
        out = []
        for i in range(new):
            with sh.activation_rules(mesh if on else None,
                                     seq_parallel=on):
                lg, state = serve_step(p, state, put(tokens[:, S + i]),
                                       torch.tensor(S + i, device=device))
            out.append(sh.full(lg))
        torch.cuda.synchronize()
        return torch.stack(out)

    # the prefill, with no mesh and on the mesh over the same params
    reset_counts(kernels)
    pre0, cache = prefill(params, batch)
    torch.cuda.synchronize()
    n_pre0 = launches_of(kernels)
    pspecs = mesh_lib.shardings_for(cfg, ShapeConfig("p", S, B, "prefill"),
                                    mesh, params, None, batch)
    pm = _share_tree(params, pspecs["params"], mesh)
    shared = all(a.to_local().data_ptr() == b.data_ptr()
                 for a, b in zip(_leaves(pm), _leaves(params)))
    check(shared, "rwkv6-1.6b's one-rank DTensors copy the params")
    reset_counts(kernels)
    with sh.activation_rules(mesh):
        pre1, cache1 = prefill(pm, sh.distribute_tree(
            batch, pspecs["batch"], mesh))
    pre1 = sh.full(pre1)
    torch.cuda.synchronize()
    n_pre1 = launches_of(kernels)
    err_cache = max(float((sh.full(a) - b).abs().max())
                    for a, b in zip(_leaves(cache1), _leaves(cache)))
    rms_cache = max(_rel_rms(sh.full(a), b)
                    for a, b in zip(_leaves(cache1), _leaves(cache)))
    mag_cache = max(float(b.abs().max()) for b in _leaves(cache))
    # no mesh's prefill cache seeds both decodes
    state0 = api.grow_decode_state(cfg, cache, S + new)
    start = _cast(state0, lambda t: t.clone())
    reset_counts(kernels)
    dec0 = decode(params, state0, lambda t: t, False)
    n_dec0 = launches_of(kernels)
    dspecs = mesh_lib.shardings_for(
        cfg, ShapeConfig("d", S + new, B, "decode"), mesh, params, None,
        {"tokens": tokens[:, S], "state": start}, seq_parallel=True)
    state1 = sh.distribute_tree(start, dspecs["state"], mesh)
    reset_counts(kernels)
    dec1 = decode(pm, state1, lambda t: sh.distribute(t, dspecs["tokens"],
                                                      mesh), True)
    n_dec1 = launches_of(kernels)
    err_state = max(float((sh.full(a) - b).abs().max())
                    for a, b in zip(_leaves(state1), _leaves(state0)))
    rms_state = max(_rel_rms(sh.full(a), b)
                    for a, b in zip(_leaves(state1), _leaves(state0)))
    check(n_pre0 == n_pre1 == want_prefill and n_dec0 == n_dec1 ==
          want_decode, f"rwkv6-1.6b: prefill launched {n_pre0} / {n_pre1} "
          f"(no mesh / mesh; want {want_prefill}), decode {n_dec0} / "
          f"{n_dec1} (want {want_decode})")
    err_p = float((pre1 - pre0).abs().max())
    err_d = float((dec1 - dec0).abs().max())
    rms_p, rms_d = _rel_rms(pre1, pre0), _rel_rms(dec1, dec0)
    check(bool(torch.isfinite(pre1).all() and torch.isfinite(dec1).all()),
          "rwkv6-1.6b on the mesh: logits not finite")
    check(max(err_p, err_d) <= RWKV_LOGITS_TOL
          and max(rms_cache, rms_state) <= RWKV_STATE_RMS,
          f"rwkv6-1.6b mesh (1, 1) != no mesh: logits' max |diff| prefill "
          f"{err_p}, decode {err_d} (tolerance {RWKV_LOGITS_TOL}); state's "
          f"relative RMS prefill cache {rms_cache}, after decode "
          f"{rms_state} (tolerance {RWKV_STATE_RMS})")
    print(f"  (a) {cfg.name} f32 ({cfg.num_layers} layers, {n_params / 1e9:.2f}"
          f" B params, the mesh's DTensors over their storage: {shared}), "
          f"{B} x {S} prefill + {new} decode steps: mesh (1, 1) vs none: "
          f"logits' max |diff| prefill {err_p:.3g} (relative RMS "
          f"{rms_p:.3g}), decode {err_d:.3g} (relative RMS {rms_d:.3g}) "
          f"(tolerance {RWKV_LOGITS_TOL}); the prefill cache's max |diff| "
          f"{err_cache:.3g} (its max |value| {mag_cache:.3g}, relative RMS "
          f"{rms_cache:.3g}), the decoded state's {err_state:.3g} (relative "
          f"RMS {rms_state:.3g}) (tolerance {RWKV_STATE_RMS}); launches "
          f"prefill {n_pre1}, decode {n_dec1}", flush=True)
    del params, pm, state0, state1, start, cache, cache1, pre0, pre1, dec0, \
        dec1
    gc.collect()
    torch.cuda.empty_cache()

    # ---- its first layers: one f32 train step through K4's backward ----
    opt_cfg = OptimizerConfig(warmup_steps=0, eps=1e-3)
    lr = opt_cfg.lr
    tb, ts = RWKV_TRAIN
    cfg_t = dataclasses.replace(cfg, num_layers=RWKV_TRAIN_LAYERS)
    tbatch = {"tokens": torch.randint(0, cfg_t.vocab_size, (tb, ts),
                                      device=device, generator=gen,
                                      dtype=torch.int32)}
    p_init = api.init_params(torch.Generator(device).manual_seed(22), cfg_t)
    step = steps.make_train_step(cfg_t, opt_cfg, remat="none")
    want_t = {name: 0 for name in kernels}
    want_t.update(rwkv6_scan=cfg_t.num_layers,
                  rwkv6_scan_bwd=cfg_t.num_layers)
    p_mesh = _cast(p_init, lambda t: t.clone())
    opt = adamw.init_opt_state(p_mesh, opt_cfg)
    tspecs = mesh_lib.shardings_for(cfg_t, ShapeConfig("t", ts, tb, "train"),
                                    mesh, p_mesh, opt, tbatch)
    with sh.activation_rules(mesh):
        pm = _share_tree(p_mesh, tspecs["params"], mesh)
        om = _share_tree(opt, tspecs["opt_state"], mesh)
        reset_counts(kernels)
        pm, om, m1 = step(pm, om, sh.distribute_tree(
            tbatch, tspecs["batch"], mesh))
        torch.cuda.synchronize()
        launches_t1 = launches_of(kernels)
    loss1, norm1 = float(m1["loss"].full_tensor()), float(m1["grad_norm"])
    del om, opt, m1
    p_t = _cast(p_init, lambda t: t.clone())
    opt = adamw.init_opt_state(p_t, opt_cfg)
    reset_counts(kernels)
    p_t, opt, m0 = step(p_t, opt, tbatch)
    torch.cuda.synchronize()
    launches_t0 = launches_of(kernels)
    loss0, norm0 = float(m0["loss"]), float(m0["grad_norm"])
    err_move, moved, rel_move = _moves(adamw, sh, pm, p_t, p_init)
    tol_t = dict(loss=1e-4, grad_norm=1e-3 * norm0, move=lr / 100,
                 move_rms=1e-3)
    err_loss, err_norm = abs(loss1 - loss0), abs(norm1 - norm0)
    check(err_loss <= tol_t["loss"] and err_norm <= tol_t["grad_norm"]
          and moved > lr / 2 and err_move <= tol_t["move"]
          and rel_move <= tol_t["move_rms"],
          f"rwkv6-1.6b mesh train step != no mesh: loss {err_loss}, grad "
          f"norm {err_norm}, params' move max {moved} (lr {lr}), its max "
          f"|diff| {err_move}, relative RMS {rel_move} (tolerances {tol_t})")
    check(launches_t1 == launches_t0 == want_t,
          f"rwkv6-1.6b train launches {launches_t1} vs {launches_t0}, want "
          f"{want_t}")
    n_train = sum(t.numel() for t in _leaves(p_init))
    print(f"  (a) {cfg.name} first {cfg_t.num_layers} layers f32 "
          f"({n_train / 1e9:.2f} B params) train step {tb} x {ts} (lr {lr}, "
          f"no warmup, eps 1e-3): mesh vs none: |d loss| {err_loss:.3g} "
          f"(loss {loss0:.4f}), |d grad norm| {err_norm:.3g}; params moved "
          f"up to {moved:.3g}, the moves' max |diff| {err_move:.3g}, "
          f"relative RMS {rel_move:.3g} (tolerances {tol_t}); launches "
          f"{launches_t1}", flush=True)
    del p_t, p_mesh, pm, p_init, opt, m0
    gc.collect()
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t0
    print(f"  (a) {cfg.name}: {phase_s:.1f} s", flush=True)
    return dict(params=n_params, shared_storage=shared, prefill_err=err_p,
                prefill_rel_rms=rms_p, prefill_cache_err=err_cache,
                prefill_cache_rel_rms=rms_cache, prefill_cache_max=mag_cache,
                decode_err=err_d, decode_rel_rms=rms_d,
                decode_state_err=err_state, decode_state_rel_rms=rms_state,
                tol=dict(logits=RWKV_LOGITS_TOL, state_rms=RWKV_STATE_RMS),
                launches_prefill=n_pre1, launches_decode=n_dec1,
                train=dict(params=n_train, layers=cfg_t.num_layers,
                           loss_err=err_loss, grad_norm_err=err_norm,
                           max_move=moved, move_err=err_move,
                           move_rel_rms=rel_move, tol=tol_t,
                           launches=launches_t1),
                phase_s=phase_s)


def phase_mesh(torch, np, device, kernels, steps, api, adamw, get_arch,
               OptimizerConfig, ShapeConfig, dops, gen) -> dict:
    """Phase 15: (a) a one-rank NCCL mesh = no mesh, for qwen1.5-0.5b,
    granite-moe-1b-a400m (:func:`phase_mesh_moe`), jamba-1.5-large-398b
    (:func:`phase_mesh_hybrid`) and rwkv6-1.6b (:func:`phase_mesh_rwkv`),
    (b) K1's log-sum-exp and its merge over key shards, (c) four sharded
    dry-run cells."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import sharding as sh
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.perf import roofline, useful_flops

    t0 = time.perf_counter()
    out = {}
    # ---- (a) one rank, (1, 1) mesh = no mesh ----------------------------
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group("nccl" if on_card else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1,
                            **({"device_id": dev} if on_card else {}))
    mesh = init_device_mesh(dev.type, (1, 1), mesh_dim_names=("data", "model"))

    def sync():
        if on_card:
            torch.cuda.synchronize()
    cfg = dataclasses.replace(get_arch("qwen1.5-0.5b").model,
                              param_dtype="float32", compute_dtype="float32")
    params = api.init_params(torch.Generator(device).manual_seed(15), cfg)
    B, S, new = 4, 128, 8
    tokens = torch.randint(0, cfg.vocab_size, (B, S + new), device=device,
                           generator=gen, dtype=torch.int32)
    prefill, serve_step = steps.make_prefill_step(cfg), \
        steps.make_serve_step(cfg)

    def decode(p, state, put, rules):
        logits, walls = [], []
        for i in range(new):
            tok = put(tokens[:, S + i])
            sync()
            t = time.perf_counter()
            with rules():
                lg, state = serve_step(p, state, tok,
                                       torch.tensor(S + i, device=device))
            sync()
            walls.append((time.perf_counter() - t) * 1e3)
            logits.append(sh.full(lg))
        return torch.stack(logits), walls

    reset_counts(kernels)
    logits0, cache = prefill(params, {"tokens": tokens[:, :S]})
    state = api.grow_decode_state(cfg, cache, S + new)
    state_copy = _cast(state, lambda t: t.clone())
    dec0, walls0 = decode(params, state, lambda t: t,
                          lambda: sh.activation_rules(None))
    launches0 = launches_of(kernels)
    shape = ShapeConfig("p", S, B, "prefill")
    specs = mesh_lib.shardings_for(cfg, shape, mesh, params, None,
                                   {"tokens": tokens[:, :S]})
    with sh.activation_rules(mesh):
        pm = sh.distribute_tree(params, specs["params"], mesh)
        reset_counts(kernels)
        logits1, _ = prefill(pm, sh.distribute_tree(
            {"tokens": tokens[:, :S]}, specs["batch"], mesh))
        dshape = ShapeConfig("d", S + new, B, "decode")
        dspecs = mesh_lib.shardings_for(cfg, dshape, mesh, params, None,
                                        {"tokens": tokens[:, S],
                                         "state": state_copy},
                                        seq_parallel=True)
        state1 = sh.distribute_tree(state_copy, dspecs["state"], mesh)
    dec1, walls1 = decode(pm, state1, lambda t: sh.distribute(
        t, dspecs["tokens"], mesh),
        lambda: sh.activation_rules(mesh, seq_parallel=True))
    launches1 = launches_of(kernels)
    del pm, state1, state, state_copy, cache
    err_p = float((sh.full(logits1) - logits0).abs().max())
    err_d = float((dec1 - dec0).abs().max())
    tol = 1e-5
    check(err_p <= tol and err_d <= tol, f"mesh (1, 1) != no mesh: prefill "
          f"{err_p}, decode {err_d} (tolerance {tol})")
    check(launches1 == launches0, f"mesh launches {launches1} != no mesh "
          f"{launches0}")
    wall0, wall1 = float(np.median(walls0[1:])), float(np.median(walls1[1:]))
    print(f"  (a) qwen1.5-0.5b f32, 4 x 128 prefill + {new} decode steps: "
          f"mesh (1, 1) vs none: max |diff| prefill {err_p:.3g}, decode "
          f"{err_d:.3g} (tolerance {tol}; bitwise: {err_p == err_d == 0.0}); "
          f"launches {launches1}; decode step host wall {wall1:.2f} ms with "
          f"the mesh, {wall0:.2f} ms without (DTensor's dispatch "
          f"{wall1 - wall0:.2f} ms)", flush=True)
    out["a"] = dict(prefill_err=err_p, decode_err=err_d, tol=tol,
                    launches=launches1, decode_wall_ms=wall1,
                    decode_wall_ms_no_mesh=wall0)
    del params
    # one train step at 2 x 256 with and without the mesh, in f32 and with
    # bf16 products: f32 params, so that each param's move shows whole, and
    # no warmup, so that step 1 runs at the full rate and moves a param by
    # up to lr; eps 1e-3 makes the move, lr g / (|g| + eps) in AdamW's
    # first step, a smooth function of the gradient (at eps 1e-8 a gradient
    # within rounding of zero moves its param by anything in (-lr, lr)).
    # In f32 the moves agree within lr / 100 (relative RMS 1e-3); with bf16
    # products the mesh's 2-D products and its norms' sums round otherwise
    # than the plain 3-D ones, and the moves within lr / 2 (relative RMS
    # 5e-2) -- still far from a skipped update (1), a doubled rate (1) or a
    # wrong step count (~0.5)
    opt_cfg = OptimizerConfig(warmup_steps=0, eps=1e-3)
    lr = opt_cfg.lr
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 256),
                                     device=device, generator=gen,
                                     dtype=torch.int32)}
    tshape = ShapeConfig("t", 256, 2, "train")
    out["a"]["train"] = {}
    for name, compute, tol_move, tol_rms in (
            ("f32", "float32", lr / 100, 1e-3),
            ("bf16 products", "bfloat16", lr / 2, 5e-2)):
        cfg_t = dataclasses.replace(cfg, param_dtype="float32",
                                    compute_dtype=compute)
        p_t = api.init_params(torch.Generator(device).manual_seed(16), cfg_t)
        p_init = _cast(p_t, lambda t: t.clone())
        step = steps.make_train_step(cfg_t, opt_cfg, remat="none")
        opt = adamw.init_opt_state(p_t, opt_cfg)
        tspecs = mesh_lib.shardings_for(cfg_t, tshape, mesh, p_t, opt, batch)
        with sh.activation_rules(mesh):
            pm = sh.distribute_tree(p_t, tspecs["params"], mesh)
            om = sh.distribute_tree(opt, tspecs["opt_state"], mesh)
            bm = sh.distribute_tree(batch, tspecs["batch"], mesh)
            reset_counts(kernels)
            pm, _, m1 = step(pm, om, bm)
            sync()
            launches_t1 = launches_of(kernels)
        reset_counts(kernels)
        p_t, _, m0 = step(p_t, opt, batch)
        sync()
        launches_t0 = launches_of(kernels)
        err_loss = abs(float(m1["loss"].full_tensor()) - float(m0["loss"]))
        err_norm = abs(float(m1["grad_norm"]) - float(m0["grad_norm"]))
        err_move, moved, rel_move = _moves(adamw, sh, pm, p_t, p_init)
        tol_t = dict(loss=1e-4, grad_norm=1e-3 * float(m0["grad_norm"]),
                     move=tol_move, move_rms=tol_rms)
        check(err_loss <= tol_t["loss"] and err_norm <= tol_t["grad_norm"]
              and moved > lr / 2 and err_move <= tol_t["move"]
              and rel_move <= tol_t["move_rms"],
              f"mesh train step ({name}) != no mesh: loss {err_loss}, grad "
              f"norm {err_norm}, params' move max {moved} (lr {lr}), its max "
              f"|diff| {err_move}, relative RMS {rel_move} (tolerances "
              f"{tol_t})")
        check(launches_t1 == launches_t0 and (
              launches_t1["flash_attention_bwd"] == cfg.num_layers
              or not on_card),
              f"train launches {launches_t1} vs {launches_t0}")
        print(f"  (a) train step 2 x 256, {name} (f32 params; lr {lr}, no "
              f"warmup, eps 1e-3): mesh vs none: |d loss| {err_loss:.3g}, "
              f"|d grad norm| {err_norm:.3g}; params moved up to "
              f"{moved:.3g}, the moves' max |diff| {err_move:.3g}, "
              f"relative RMS {rel_move:.3g} (tolerances {tol_t}); launches "
              f"{launches_t1}", flush=True)
        out["a"]["train"][name] = dict(
            loss_err=err_loss, grad_norm_err=err_norm, max_move=moved,
            move_err=err_move, move_rel_rms=rel_move, tol=tol_t,
            launches=launches_t1)
        del pm, om, p_t, p_init, opt, m0, m1
        gc.collect()
    out["a"]["granite"] = phase_mesh_moe(
        torch, np, device, mesh, kernels, steps, api, adamw, get_arch,
        OptimizerConfig, ShapeConfig, gen)
    out["a"]["jamba"] = phase_mesh_hybrid(
        torch, np, device, mesh, kernels, steps, api, adamw,
        OptimizerConfig, ShapeConfig, gen)
    out["a"]["rwkv"] = phase_mesh_rwkv(
        torch, np, device, mesh, kernels, steps, api, adamw,
        OptimizerConfig, ShapeConfig, gen)
    dist.destroy_process_group()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    # ---- (b) K1's log-sum-exp and the merge over key shards -------------
    out["b"] = [_k1_lse_case(torch, dops, 4, 16, 16, 512, 64,
                             [1, 333, 512, 200], "float32", gen),
                _k1_lse_case(torch, dops, 4, 16, 16, 512, 64,
                             [1, 333, 512, 200], "bfloat16", gen),
                _k1_lse_case(torch, dops, 4, 40, 8, 4096, 128,
                             [17, 2000, 4096, 1], "bfloat16", gen)]
    # ---- (c) sharded dry-run cells -------------------------------------
    out["c"] = {}
    for arch, sname in (("qwen1.5-0.5b", "decode_32k"),
                        ("granite-moe-1b-a400m", "decode_32k"),
                        ("jamba-1.5-large-398b", "long_500k"),
                        ("rwkv6-1.6b", "long_500k")):
        ccfg, dshape = get_arch(arch).model, dryrun.LM_SHAPES[sname]
        rep = dryrun.count_on_mesh(ccfg, dshape, multi_pod=False)
        terms = roofline(rep, ccfg, useful_flops(ccfg, dshape) / rep["chips"])
        check(rep["collective_bytes"] > 0 and rep["flops"] > 0,
              f"the sharded cell of {arch} counted no collectives")
        coll = {k: v / 1e9 for k, v in rep["collective_breakdown"].items()}
        print(f"  (c) {arch} {sname} on {rep['mesh']} (rank 0 of a "
              f"virtual group, seq_parallel): {rep['flops'] / 1e9:.3f} "
              f"GFLOP, {rep['hbm_bytes'] / 1e9:.3f} GB, collectives by kind "
              f"{coll} GB, t_compute {terms['t_compute_ms']:.4f} ms, "
              f"t_memory {terms['t_memory_ms']:.4f} ms, t_collective "
              f"{terms['t_collective_ms']:.4f} ms, peak "
              f"{rep['peak_bytes'] / 1e9:.3f} GB, trace "
              f"{rep['trace_seconds']:.1f} s", flush=True)
        out["c"][arch] = dict(
            flops=rep["flops"], hbm_bytes=rep["hbm_bytes"],
            collective_breakdown=rep["collective_breakdown"],
            peak_bytes=rep["peak_bytes"], **terms)
    out["phase_s"] = time.perf_counter() - t0
    print(f"phase 15: {out['phase_s']:.1f} s", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, help="write every number here (JSON)")
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: {ROOT / 'src' / 'repro_torch'} not found; run "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch.nn.functional as F

    from repro_torch.core.config import OptimizerConfig, ShapeConfig, get_arch
    from repro_torch.core.device import resolve_device
    from repro_torch.data import pipeline
    from repro_torch.kernels import _build, sm_count
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import bwd as bops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.mla_decode import ops as mops
    from repro_torch.kernels.rwkv6_scan import bwd as kbops
    from repro_torch.kernels.rwkv6_scan import ops as kops
    from repro_torch.kernels.ssm_scan import bwd as sbops
    from repro_torch.kernels.ssm_scan import ops as sops
    from repro_torch.launch import serve, steps, train
    from repro_torch.models import api
    from repro_torch.optim import adamw

    kernels = {"decode_attention": dops, "flash_attention": fops,
               "flash_attention_bwd": bops, "ssm_scan": sops,
               "rwkv6_scan": kops, "ssm_scan_bwd": sbops,
               "rwkv6_scan_bwd": kbops, "mla_decode": mops}
    t_start = time.perf_counter()
    # ---- 1. build and device -------------------------------------------
    section("== 1. build and device")
    device = resolve_device("cuda")        # also sets full-precision matmuls
    build_s = _build.build()
    print(f"built {_build.sources()} in {build_s:.1f} s "
          f"(nvcc {' '.join(_build.NVCC_FLAGS)})")
    ptxas = {name: _ptxas_summary(log) for name, log in _build.build_log.items()}
    for name, kernels_of in ptxas.items():
        for kernel, info in kernels_of:
            print(f"  {name}: {kernel}: {info}")
    # the products run on the tensor cores: wgmma in K2's bf16 kernel and
    # its backward's, mma.sync in K1's bf16 kernel and (3xTF32) in K2's f32
    # backward
    sass = {name: _tensor_core_ops(_build.target(name)) for name in
            ("flash_attention", "decode_attention", "flash_attention_bwd",
             "mla_decode")}
    for name, of_kernel in sass.items():
        for kernel, ops in sorted(of_kernel.items()):
            for op, (count, n_wait, first) in ops.items():
                print(f"  {name}: {kernel}: {count} {op} ({n_wait} with "
                      f"gsb0), e.g. `{first}`")
    for name, kernel, op in (
            ("flash_attention", "wgmma_kernel", "HGMMA"),
            ("decode_attention", "mma_kernel", "HMMA"),
            ("mla_decode", "mla_wgmma_kernel", "HGMMA"),
            ("flash_attention_bwd", "wg_dkdv_kernel", "HGMMA"),
            ("flash_attention_bwd", "wg_dq_kernel", "HGMMA"),
            ("flash_attention_bwd", "tf32_dkdv_kernel", "HMMA"),
            ("flash_attention_bwd", "tf32_dq_kernel", "HMMA")):
        found = [ops[op] for name_args, ops in sass[name].items()
                 if name_args.split("<")[0] == kernel and op in ops]
        check(bool(found) and all(not kernel.startswith("tf32")
                                  or "TF32" in first for _, _, first in found),
              f"{name}: no {op} instruction in {kernel}'s SASS")
    # MLA's expanded attention (hd 192, hd_v 128): 12 k-steps of Q K^T and
    # 8 of P V, each group ending in one wait unless ptxas serialized it
    mla_k2 = sass["flash_attention"].get("wgmma_kernel<192,128>", {})
    count, n_wait, _ = mla_k2.get("HGMMA", (0, 0, ""))
    check(0 < n_wait < count, "flash_attention: wgmma_kernel<192,128> holds "
          f"{count} HGMMA, {n_wait} with gsb0 (all of them: serialized)")
    # and its backward's: two warpgroups of 20 products each in the dK/dV
    # kernel, 12 + 8 and 12 in the dQ kernel; neither spills
    bwd_ptxas = dict(ptxas.get("flash_attention_bwd", ()))
    for kernel in ("wg_dkdv_kernel<192,128>", "wg_dq_kernel<192,128>"):
        count, n_wait, _ = sass["flash_attention_bwd"].get(kernel, {}).get(
            "HGMMA", (0, 0, ""))
        check(0 < n_wait < count, f"flash_attention_bwd: {kernel} holds "
              f"{count} HGMMA, {n_wait} with gsb0 (all of them: serialized)")
        check(bwd_ptxas.get(kernel, "").endswith(" 0 bytes spill stores"),
              f"flash_attention_bwd: ptxas reports {kernel}: "
              f"{bwd_ptxas.get(kernel, 'nothing')}")
    card = gpu_name_and_power_limit()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)

    # ---- 2. kernels against plain versions ------------------------------
    section("== 2. kernels against their plain versions on the card")
    gen = torch.Generator(device=device).manual_seed(0)
    rows = {name: [] for name in kernels}
    # phase 12's shapes, by kernel and use, printed with the kernel's rows
    slice12 = {key: [] for key in (
        "k1 internvl2 decode", "k1 seamless cross decode",
        "k2 seamless encoder", "k2 seamless cross", "k2 internvl2 prefill",
        "bwd seamless train", "bwd internvl2 train")}
    for dtype in ("float32", "bfloat16"):
        for B in (4, 8):
            for S in (512, 1024):
                lens = [1, 333, S] + torch.randint(
                    1, S + 1, (B - 3,), generator=gen, device=device).tolist()
                rows["decode_attention"].append(decode_case(
                    torch, F, dops, B, 16, 16, S, 64, lens, dtype, gen))
        rows["decode_attention"].append(decode_case(   # minitron's heads
            torch, F, dops, 4, 32, 8, 1024, 128, [1, 333, 777, 1024], dtype,
            gen))
        # phase 12's decode steps: internvl2's (GQA 16/8, hd 128, 1,088
        # cached positions and up to 32 generated) and seamless's
        # cross-attention (16/16, hd 64, every row over all 1,024 frames)
        slice12["k1 internvl2 decode"].append(decode_case(
            torch, F, dops, 4, 16, 8, 1120, 128, [1089, 1100, 1111, 1120],
            dtype, gen))
        slice12["k1 seamless cross decode"].append(decode_case(
            torch, F, dops, 4, 16, 16, 1024, 64, [1024] * 4, dtype, gen))
        for case in ((4, 16, 16, 512, 512, 64, True, 0),
                     (4, 16, 16, 256, 256, 64, True, 0),      # main-path prefill
                     (2, 16, 16, 128, 512, 64, True, 384),    # q_offset
                     (2, 16, 16, 200, 520, 64, False, 320),   # Sq != Sk
                     (2, 32, 8, 512, 512, 128, True, 0)):     # minitron's GQA
            rows["flash_attention"].append(
                flash_case(torch, F, fops, *case, dtype=dtype, gen=gen))
        # phase 12's prefills: seamless's encoder (non-causal, 1,024 frames)
        # and cross-attention (16 prompt tokens over the 1,024 frames), and
        # internvl2's causal prefill over 1,024 patches and 64 tokens
        for key, case in (
                ("k2 seamless encoder", (4, 16, 16, 1024, 1024, 64, False, 0)),
                ("k2 seamless cross", (4, 16, 16, 16, 1024, 64, False, 0)),
                ("k2 internvl2 prefill",
                 (4, 16, 8, 1088, 1088, 128, True, 0))):
            slice12[key].append(
                flash_case(torch, F, fops, *case, dtype=dtype, gen=gen))
        # rwkv6-1.6b: one prompt's 32 heads of 64 over 16-256 tokens, four
        # prompts at once, two odd shapes (ragged key rows and columns), a
        # ragged last chunk at full width and many chunks
        # (hd 30: rows that 16-byte loads and stores cannot take)
        for N, S, hd in ((32, 16, 64), (32, 131, 64), (32, 256, 64),
                         (128, 256, 64), (6, 33, 16), (4, 100, 128),
                         (32, 33, 64), (32, 1024, 64), (32, 4096, 64),
                         (3, 45, 30)):
            rows["rwkv6_scan"].append(rwkv_case(
                torch, kops, N, S, hd, dtype, gen,
                profile=S == 256 and dtype == "float32"))
        # the decay extremes: logw = -8 at every step (the largest in-chunk
        # decay, where a factored exponent overflows f32), and -1e-6 (no
        # decay: the state grows, and the f32 plain version's own rounding
        # passes 1e-3, so that case is held to the f64 recurrence)
        rows["rwkv6_scan"].append(rwkv_case(torch, kops, 32, 256, 64, dtype,
                                            gen, logw_value=-8.0))
        rows["rwkv6_scan"].append(rwkv_case(torch, kops, 32, 256, 64, dtype,
                                            gen, logw_value=-1e-6, f64=True))
        # tests/test_kernels.py's selective-scan shapes, and two whose u / dt
        # rows cannot be copied 16 bytes at a time (di 100 and 50)
        for Bz, S, di, ds in ((2, 64, 128, 16), (1, 100, 64, 8),
                              (2, 37, 256, 16), (2, 37, 100, 16),
                              (1, 50, 50, 8)):
            rows["ssm_scan"].append(
                ssm_case(torch, sops, Bz, S, di, ds, dtype, gen))
    # K2's backward.  qwen's training shape in f32 and bf16 (each with the
    # CUDA-core route timed beside the tensor cores), a GQA group of 2 at
    # hd 128 and a query offset with Sq < Sk; in both dtypes the shapes of
    # tests/test_torch_kernels_flash_bwd.py (ragged Sq = Sk = 257, hd 32 and
    # 16, one query over 200 keys, non-causal GQA 4/1 over 320 keys, a query
    # offset with Sq < Sk); in bf16 the GQA and query-offset shapes and
    # jamba's attention (GQA 64/8, hd 128); and two head dims that only the
    # CUDA cores take (f32 hd 30, bf16 hd 36)
    for case in ((4, 16, 16, 512, 512, 64, True, 0, "float32"),
                 (4, 16, 16, 512, 512, 64, True, 0, "bfloat16"),
                 (2, 32, 16, 512, 512, 128, True, 0, "float32"),
                 (2, 16, 16, 128, 512, 64, True, 384, "float32")):
        rows["flash_attention_bwd"].append(flash_bwd_case(
            torch, F, fops, bops, *case[:-1], dtype=case[-1], gen=gen,
            compare=case[3] == 512 and case[5] == 64, profile=True))
    for dtype in ("float32", "bfloat16"):
        for case in ((2, 4, 2, 128, 128, 64, True, 0),
                     (1, 8, 8, 257, 257, 64, True, 0),
                     (2, 4, 1, 64, 320, 128, False, 0),
                     (1, 2, 2, 1, 200, 64, False, 0),
                     (1, 16, 4, 96, 96, 128, True, 0),
                     (1, 4, 2, 40, 104, 32, True, 64),
                     (1, 2, 1, 1, 50, 16, True, 49)):
            rows["flash_attention_bwd"].append(flash_bwd_case(
                torch, F, fops, bops, *case, dtype=dtype, gen=gen))
    for case in ((2, 32, 16, 512, 512, 128, True, 0),
                 (2, 16, 16, 128, 512, 64, True, 384),
                 (1, 64, 8, 512, 512, 128, True, 0)):   # jamba's
        rows["flash_attention_bwd"].append(flash_bwd_case(
            torch, F, fops, bops, *case, dtype="bfloat16", gen=gen,
            profile=case[1] == 64))
    for hd, dtype in ((30, "float32"), (36, "bfloat16")):
        rows["flash_attention_bwd"].append(flash_bwd_case(
            torch, F, fops, bops, 2, 4, 2, 130, 130, hd, True, 0, dtype, gen))
    # MLA's widths (192, 128) and the smoke's (24, 16); the first row is
    # TRAIN_CARD's bf16 step (B 2, 128 heads, S 512)
    mla_bwd = mla_bwd_rows(torch, F, fops, bops, gen)
    rows["flash_attention_bwd"] += mla_bwd
    # phase 12's training shapes, bf16: seamless's encoder and cross layers
    # (non-causal, 512 frames and 512 tokens) and internvl2's (causal, 256
    # patches and 512 tokens)
    for key, case in (
            ("bwd seamless train", (2, 16, 16, 512, 512, 64, False, 0)),
            ("bwd internvl2 train", (2, 16, 8, 768, 768, 128, True, 0))):
        slice12[key].append(flash_bwd_case(
            torch, F, fops, bops, *case, dtype="bfloat16", gen=gen))
    # jamba CARD, u/B/C bf16 and dt f32: one prompt's prefill (h0 = 0) at
    # 16-256 tokens and at 2048, and the decode step of 4 slots from their
    # states, out of place and in place (h_out=h0, as the model calls it)
    jamba_ssm = {S: ssm_case(torch, sops, 1, S, 16384, 16, "bfloat16", gen,
                             h0_random=False, profile=S == 256)
                 for S in (16, 131, 256, 2048)}
    jamba_ssm["decode"] = ssm_case(torch, sops, 4, 1, 16384, 16, "bfloat16",
                                   gen, profile=True)
    jamba_ssm["decode in place"] = ssm_case(
        torch, sops, 4, 1, 16384, 16, "bfloat16", gen, in_place=True)
    rows["ssm_scan"] += jamba_ssm.values()
    # jamba's attention: GQA group 8, hd 128, bf16; the decode step of 4
    # slots and one prompt's causal prefill
    rows["decode_attention"].append(decode_case(
        torch, F, dops, 4, 64, 8, 512, 128, [17, 130, 256, 511], "bfloat16",
        gen))
    # and its admissions: one prompt's causal prefill, at 256 and 512 tokens
    # and at two of the served prompt lengths (ragged tiles)
    for S in (256, 512, 221, 19):
        rows["flash_attention"].append(flash_case(
            torch, F, fops, 1, 64, 8, S, S, 128, True, 0, dtype="bfloat16",
            gen=gen))
    # any GQA group: qwen2.5-14b's 40/8 heads (group 5) and
    # mistral-large-123b's 96/8 (group 12), hd 128, ragged kv_len
    for dtype in ("float32", "bfloat16"):
        for Hq in (40, 96):
            rows["decode_attention"].append(decode_case(
                torch, F, dops, 4, Hq, 8, 512, 128, [17, 130, 256, 511],
                dtype, gen))
    # phase 14's shapes, bf16: the decode step of qwen2.5-14b (GQA 40/8,
    # group 5) and of mistral-large-123b (96/8, group 12), hd 128, 4 slots
    # of a 128-position cache at the profiled step's kv_len, and
    # qwen2.5-14b's prefill of 4 x 128 (causal, 40/8, hd 128)
    slice14 = {
        "k1 qwen2.5-14b decode": decode_case(
            torch, F, dops, 4, 40, 8, 128, 128, [97, 81, 65, 49], "bfloat16",
            gen),
        "k1 mistral-large-123b decode": decode_case(
            torch, F, dops, 4, 96, 8, 128, 128, [97, 81, 65, 49], "bfloat16",
            gen),
        "k2 qwen2.5-14b prefill": flash_case(
            torch, F, fops, 4, 40, 8, 128, 128, 128, True, 0,
            dtype="bfloat16", gen=gen)}
    # phase 15's granite-moe-1b-a400m shapes, bf16 (GQA 16/8, hd 64): the
    # profiled decode step (4 rows at kv_len 97 in a cache of 104), the
    # prefill of 4 x 96 and the train step's backward (2 x 256), causal
    slice15 = {
        "k1 granite-moe-1b-a400m decode": decode_case(
            torch, F, dops, MOE_B, 16, 8, MOE_S + MOE_NEW, 64,
            [MOE_S + 1] * MOE_B, "bfloat16", gen),
        "k2 granite-moe-1b-a400m prefill": flash_case(
            torch, F, fops, MOE_B, 16, 8, MOE_S, MOE_S, 64, True, 0,
            dtype="bfloat16", gen=gen),
        "bwd granite-moe-1b-a400m train": flash_bwd_case(
            torch, F, fops, bops, MOE_TRAIN[0], 16, 8, MOE_TRAIN[1],
            MOE_TRAIN[1], 64, True, 0, dtype="bfloat16", gen=gen),
        # and jamba's (CARD in bf16: GQA 64/8, hd 128, d_inner 16384,
        # d_state 16): the last decode step (2 rows at kv_len 136) and its
        # Mamba step in place, the prefill of 2 x 128; TRAIN_CARD's f32
        # step of 2 x 512 (its backward: rows["ssm_scan_bwd"][1])
        "k1 jamba-1.5-large-398b decode": decode_case(
            torch, F, dops, HYB_B, 64, 8, HYB_S + HYB_NEW, 128,
            [HYB_S + HYB_NEW] * HYB_B, "bfloat16", gen),
        "k2 jamba-1.5-large-398b prefill": flash_case(
            torch, F, fops, HYB_B, 64, 8, HYB_S, HYB_S, 128, True, 0,
            dtype="bfloat16", gen=gen),
        "k3 jamba-1.5-large-398b prefill": ssm_case(
            torch, sops, HYB_B, HYB_S, 16384, 16, "bfloat16", gen,
            h0_random=False),
        "k3 jamba-1.5-large-398b decode": ssm_case(
            torch, sops, HYB_B, 1, 16384, 16, "bfloat16", gen,
            in_place=True),
        "k3 jamba-1.5-large-398b train": ssm_case(
            torch, sops, *HYB_TRAIN, 16384, 16, "float32", gen,
            h0_random=False),
        # and rwkv6-1.6b's (f32, 32 heads of 64 a row): the prefill of
        # 4 x 128 and its first layers' train step of 2 x 512, forward and
        # backward (inputs drawn as phase 2's rows)
        "k4 rwkv6-1.6b prefill": rwkv_case(
            torch, kops, RWKV_B * 32, RWKV_S, 64, "float32", gen),
        "k4 rwkv6-1.6b train": rwkv_case(
            torch, kops, RWKV_TRAIN[0] * 32, RWKV_TRAIN[1], 64, "float32",
            gen),
        "bwd rwkv6-1.6b train": rwkv_bwd_case(
            torch, kops, kbops, RWKV_TRAIN[0] * 32, RWKV_TRAIN[1], 64,
            "float32", gen)}
    # the scans' backwards.  K4 at rwkv6-1.6b's training shape (B 4 x 32
    # heads of 64, S 512) in f32 and bf16, and at both decay extremes held
    # to the f64 recurrence; a ragged last chunk with hd 30, hd 128 and a
    # small bf16 case.  K3 at jamba's training shape (Bz 2, S 512, d_inner
    # 16384, d_state 16) with u, B, C in bf16 and in f32, an S that is not
    # a multiple of the checkpoint interval (131), and d_state 8 over 100
    # channels (a ragged block of channels)
    for case in ((128, 512, 64, "float32"), (128, 512, 64, "bfloat16"),
                 (3, 45, 30, "float32"), (4, 100, 128, "float32"),
                 (6, 33, 16, "bfloat16")):
        rows["rwkv6_scan_bwd"].append(rwkv_bwd_case(
            torch, kops, kbops, *case[:3], case[3], gen,
            profile=case[0] == 128))
    for lw in (-8.0, -1e-6):
        rows["rwkv6_scan_bwd"].append(rwkv_bwd_case(
            torch, kops, kbops, 128, 512, 64, "float32", gen, logw_value=lw,
            f64=True))
    for case in ((2, 512, 16384, 16, "bfloat16"), (2, 512, 16384, 16,
                                                   "float32"),
                 (2, 131, 16384, 16, "bfloat16"), (1, 37, 100, 8, "float32")):
        rows["ssm_scan_bwd"].append(ssm_bwd_case(
            torch, sops, sbops, *case[:4], case[4], gen,
            profile=case[:2] == (2, 512)))
    # deepseek-v2's MLA: the absorbed decode (H 128, L 512, R 64) at B 1
    # and 4 over caches of 512, 4096 and 32768 positions (decode_32k), the
    # served step of phase 11 (4 slots in a cache of 128 at pos 96, 80, 64,
    # 48), and a smoke-like shape (the CUDA cores' route in bf16 too); K2 at MLA's expanded prefill
    # (hd 192, hd_v 128, 128 heads): one prompt of 256, 512 and a ragged 221
    # tokens, and a query offset with Sq < Sk; and at the smoke's (24, 16)
    for dtype in ("float32", "bfloat16"):
        for T in (512, 4096, 32768):
            rows["mla_decode"].append(mla_case(
                torch, F, mops, 1, 128, 512, 64, T, [T - T // 3], dtype, gen))
            rows["mla_decode"].append(mla_case(
                torch, F, mops, 4, 128, 512, 64, T,
                [1, T, T // 2 + 17, T // 8 + 5], dtype, gen))
        rows["mla_decode"].append(mla_case(
            torch, F, mops, 4, 128, 512, 64, 128, [97, 81, 65, 49], dtype,
            gen))
        rows["mla_decode"].append(mla_case(
            torch, F, mops, 4, 4, 32, 8, 512, [1, 512, 77, 300], dtype, gen))
        for Sq, Sk, q_offset in ((256, 256, 0), (512, 512, 0), (221, 221, 0),
                                 (64, 300, 236)):
            row = flash_case(torch, F, fops, 1, 128, 128, Sq, Sk, 192, True,
                             q_offset, dtype=dtype, gen=gen, hd_v=128)
            rows["flash_attention"].append(row)
            if Sq == 512 and dtype == "bfloat16":    # as CARD prefills
                k2_mla = row
        for Sq, Sk, q_offset in ((40, 40, 0), (40, 70, 30)):
            rows["flash_attention"].append(flash_case(
                torch, F, fops, 2, 4, 4, Sq, Sk, 24, True, q_offset,
                dtype=dtype, gen=gen, hd_v=16))
    # the profiled step's cache: 4 slots at 4096, 8192, 16384, 32768; and
    # the same 61,440 keys in rows of one length, which the split balanced
    # over the batch should take in the same time
    mla_main = mla_case(torch, F, mops, 4, 128, 512, 64, 32768,
                        [4096, 8192, 16384, 32768], "bfloat16", gen)
    mla_even = mla_case(torch, F, mops, 4, 128, 512, 64, 32768,
                        [15360] * 4, "bfloat16", gen)
    rows["mla_decode"] += [mla_main, mla_even]
    for name, rs in rows.items():
        for row in rs:
            _print_row(name, row)
            if "sdpa" in row:
                print(f"    SDPA backends: {row['sdpa']}")
    for key, rs in slice12.items():
        for row in rs:
            _print_row(key, row)
    for key, row in (*slice14.items(), *slice15.items()):
        _print_row(key, row)
    print("phase 2's cases, host seconds by kind: " + ", ".join(
        f"{name} {secs:.1f}" for name, secs in CASE_S.items()), flush=True)
    # each kernel at the shape the main paths give it (f32, as served)
    main_rows = {
        "decode_attention": decode_case(torch, F, dops, 4, 16, 16, 512, 64,
                                        [17, 130, 256, 511], "float32", gen),
        "flash_attention": rows["flash_attention"][1],
        "ssm_scan": jamba_ssm[256],                 # Bz=1 S=256 prefill
        "rwkv6_scan": rows["rwkv6_scan"][2],        # f32 N=32 S=256
        "flash_attention_bwd": rows["flash_attention_bwd"][0],  # training
        "rwkv6_scan_bwd": rows["rwkv6_scan_bwd"][0],     # f32 N=128 S=512
        "ssm_scan_bwd": rows["ssm_scan_bwd"][0],         # bf16 Bz=2 S=512
        "mla_decode": mla_main,          # bf16 B=4 T=32768, the profiled cache
    }
    _print_row("decode (main)", main_rows["decode_attention"])
    mla_balance = mla_main["ms"] / mla_even["ms"]
    print(f"mla_decode balance: kv_len [4096, 8192, 16384, 32768] takes "
          f"{mla_balance:.3f}x the time of [15360] x 4 (same keys)")

    # ---- 3-5. qwen1.5-0.5b at full width ---------------------------------
    cfg = dataclasses.replace(get_arch("qwen1.5-0.5b").model,
                              param_dtype="float32", compute_dtype="float32")
    params = api.init_params(torch.Generator(device=device).manual_seed(0), cfg)
    n_params = sum(t.numel() for t in _leaves(params))
    section(f"== 3. serve {cfg.name} at full width ({cfg.num_layers} layers, "
            f"d_model {cfg.d_model}, vocab {cfg.vocab_size}, "
            f"{n_params / 1e6:.1f} M f32 params)")
    served = phase_serve(torch, np, cfg, params, device, kernels, serve,
                         prompt_range=(16, 129))
    n = served["launches"]
    check(n["decode_attention"] == cfg.num_layers * served["decode_calls"],
          f"decode kernel launched {n['decode_attention']} times for "
          f"{served['decode_calls']} decode calls of {cfg.num_layers} layers")
    check(n["decode_attention"] > 0, "decode kernel never launched")
    check(all(calls == 0 for name, calls in n.items()
              if name != "decode_attention"),
          f"serving {cfg.name} launched another kernel: {n}")
    prof = phase_profile(torch, cfg, params, device, steps, api)
    section("== 4. ragged batch equals solo decode at full width")
    ragged_err = phase_ragged(torch, cfg, params, device, steps, api)
    section("== 5. prefill 4 x 256 tokens through flash_attention")
    pre = phase_prefill(torch, np, cfg, params, device, kernels,
                        {"flash_attention": cfg.num_layers}, steps, api)
    section("== 13a. the count against the card: qwen1.5-0.5b f32 decode (4 "
            "slots, 512 positions), prefill 4 x 256, one train step 4 x 512 "
            "(remat dots)")
    cost_cells = []
    sms = sm_count(torch.device(device))
    att, cd = cfg.attention, getattr(torch, cfg.compute_dtype)
    state = api.allocate_decode_state(cfg, 4, 512, device)
    cost_cells.append(phase_cost_cell(
        torch, "qwen1.5-0.5b decode B 4 S 512", cfg,
        ShapeConfig("decode", 512, 4, "decode"), steps.make_serve_step(cfg),
        (params, state, torch.arange(1, 5, dtype=torch.int32, device=device),
         torch.tensor([300, 200, 100, 50], dtype=torch.int32, device=device)),
        kernels, want=("decode_attention",),
        scratch=dops.scratch_bytes(
            torch.empty(4, att.num_heads, att.head_dim, dtype=cd,
                        device="meta"),
            torch.empty(4, att.num_kv_heads, 512, att.head_dim, dtype=cd,
                        device="meta"), sms)))
    del state
    cost_cells.append(phase_cost_cell(
        torch, "qwen1.5-0.5b prefill 4 x 256", cfg,
        ShapeConfig("prefill", 256, 4, "prefill"),
        steps.make_prefill_step(cfg),
        (params, {"tokens": _prompts(torch, np, cfg, device, 4, 256)}),
        kernels, want=("flash_attention",)))
    opt_cfg = OptimizerConfig()
    cost_cells.append(phase_cost_cell(
        torch, "qwen1.5-0.5b train 4 x 512 remat dots", cfg,
        ShapeConfig("train", 512, 4, "train"),
        steps.make_train_step(cfg, opt_cfg, remat="dots"),
        (params, adamw.init_opt_state(params, opt_cfg),
         {"tokens": _prompts(torch, np, cfg, device, 4, 512)}),
        kernels, want=("flash_attention", "flash_attention_bwd"),
        scratch=bops.scratch_bytes(
            torch.empty(4, att.num_heads, 512, att.head_dim, dtype=cd,
                        device="meta"),
            torch.empty(4, att.num_kv_heads, 512, att.head_dim, dtype=cd,
                        device="meta"), sms)))
    del params
    gc.collect()            # the servers' closures hold params in cycles
    torch.cuda.empty_cache()

    # ---- training: qwen1.5-0.5b through K2 and its backward --------------
    section(f"== train (a). one step of {cfg.name} cut to 2 layers at full "
            "width, on the card and on the CPU from the same params")
    k2 = {"flash_attention": 1, "flash_attention_bwd": 1}   # a layer
    step_vs_cpu = phase_train_step_vs_cpu(
        torch, dataclasses.replace(cfg, num_layers=2), device, kernels, steps,
        api, adamw, OptimizerConfig, pipeline,
        {name: 2 * calls for name, calls in k2.items()})
    section(f"== train (b). {cfg.name} at full width and depth, f32, through "
            "launch/train.py's main")
    per_layer = {name: cfg.num_layers * calls for name, calls in k2.items()}
    trained = phase_train(torch, np, cfg, kernels, steps, train, adamw,
                          per_layer, n_steps=20)
    section(f"== train (b2). {cfg.name} at full width and depth in bf16 "
            "(--dtype bfloat16): two steps, then one profiled")
    trained_bf16 = phase_train(torch, np, cfg, kernels, steps, train, adamw,
                               per_layer, n_steps=3, profile_at=2,
                               dtype="bfloat16", converge=False)
    gc.collect()
    torch.cuda.empty_cache()
    section("== train (c). rwkv6 and jamba smoke: every gradient on the card "
            "against the CPU's (f32), under each remat mode; flash-decode "
            "refuses grad mode")
    grad_check = phase_grad_check(torch, device, api, adamw, get_arch,
                                  pipeline, kernels, dops)
    rcfg = dataclasses.replace(get_arch("rwkv6-1.6b").model,
                               param_dtype="float32", compute_dtype="float32")
    section(f"== train (c2). one step of {rcfg.name} cut to 2 layers at full "
            "width, on the card and on the CPU from the same params")
    step_vs_cpu_r = phase_train_step_vs_cpu(
        torch, dataclasses.replace(rcfg, num_layers=2), device, kernels,
        steps, api, adamw, OptimizerConfig, pipeline,
        {"rwkv6_scan": 2, "rwkv6_scan_bwd": 2})
    from repro_torch.configs.jamba_1_5_large_398b import TRAIN_CARD
    section("== train (c3). jamba's Mamba mixer at full width (TRAIN_CARD's "
            "layer 0, f32), on the card and on the CPU")
    mixer_vs_cpu = phase_mixer_vs_cpu(torch, dataclasses.replace(
        TRAIN_CARD, param_dtype="float32", compute_dtype="float32"), device,
        kernels, adamw)
    gc.collect()
    torch.cuda.empty_cache()
    rtrain = dataclasses.replace(rcfg, num_layers=rcfg.num_layers // 2)
    section(f"== train (d). {rcfg.name} at full width, its first "
            f"{rtrain.num_layers} of {rcfg.num_layers} layers, f32, through "
            "launch/train.py's main")
    trained_r = phase_train(
        torch, np, rtrain, kernels, steps, train, adamw,
        {"rwkv6_scan": rtrain.num_layers,
         "rwkv6_scan_bwd": rtrain.num_layers},
        n_steps=20, arch="rwkv6-1.6b", model_cfg=rtrain)
    gc.collect()
    torch.cuda.empty_cache()
    section(f"== train (e). {TRAIN_CARD.name} cut to {TRAIN_CARD.num_layers} "
            "layer (TRAIN_CARD: Mamba mixer and dense FFN at full width), bf16, "
            "through launch/train.py's main")
    trained_j = phase_train(
        torch, np, TRAIN_CARD, kernels, steps, train, adamw,
        {"ssm_scan": 1, "ssm_scan_bwd": 1}, n_steps=20, batch=2,
        dtype="bfloat16", arch="jamba-1.5-large-398b", model_cfg=TRAIN_CARD)
    gc.collect()
    torch.cuda.empty_cache()

    # ---- training: deepseek-v2's MLA through K2 and its backward at (192,
    # 128) ------------------------------------------------------------------
    section("== train (f). deepseek-v2 smoke: every gradient on the card against "
            "the CPU's (f32, K2 and its backward at (24, 16) on 3xTF32), under "
            "each remat mode")
    grad_check_d = phase_grad_check(torch, device, api, adamw, get_arch,
                                    pipeline, kernels, None,
                                    archs=("deepseek-v2-236b",))
    from repro_torch.configs.deepseek_v2_236b import TRAIN_CARD as DTRAIN
    mla_k2 = {"flash_attention": 1, "flash_attention_bwd": 1}   # one layer
    section(f"== train (g). {DTRAIN.name} cut to {DTRAIN.num_layers} layer "
            "(TRAIN_CARD: MLA and the dense FFN at full width) in f32: one step "
            "of B 1 x 256 on the card and on the CPU from the same params")
    step_vs_cpu_d = phase_train_step_vs_cpu(
        torch, dataclasses.replace(DTRAIN, param_dtype="float32",
                                   compute_dtype="float32"),
        device, kernels, steps, api, adamw, OptimizerConfig, pipeline, mla_k2,
        batch=1, remat_modes=())
    gc.collect()
    torch.cuda.empty_cache()
    section(f"== train (h). {DTRAIN.name} TRAIN_CARD in bf16 through "
            "launch/train.py's main: B 2 x 512, 20 steps")
    # at the trainer's default lr of 3e-4 the bf16 weights of this model
    # spike (to a loss of 19 at step 7 on an H100, where f32 falls): 1e-4
    trained_d = phase_train(
        torch, np, DTRAIN, kernels, steps, train, adamw, mla_k2, n_steps=20,
        batch=2, dtype="bfloat16", arch="deepseek-v2-236b", model_cfg=DTRAIN,
        lr=1e-4)
    gc.collect()
    torch.cuda.empty_cache()
    section("== 13e. the count against the card: deepseek-v2 TRAIN_CARD bf16 "
            "train step 2 x 512")
    dtp = api.init_params(torch.Generator(device=device).manual_seed(0),
                          DTRAIN)
    d_opt = OptimizerConfig()
    da = DTRAIN.attention
    d_hd = da.qk_nope_head_dim + da.qk_rope_head_dim
    d_args = (dtp, adamw.init_opt_state(dtp, d_opt),
              {"tokens": _prompts(torch, np, DTRAIN, device, 2, 512)})
    cost_cells.append(phase_cost_cell(
        torch, "deepseek-v2 TRAIN_CARD train 2 x 512", DTRAIN,
        ShapeConfig("train", 512, 2, "train"),
        steps.make_train_step(DTRAIN, d_opt, remat="none"), d_args, kernels,
        want=("flash_attention", "flash_attention_bwd"),
        scratch=bops.scratch_bytes(
            torch.empty(2, da.num_heads, 512, d_hd, dtype=torch.bfloat16,
                        device="meta"),
            torch.empty(2, da.num_kv_heads, 512, d_hd, dtype=torch.bfloat16,
                        device="meta"), sms, hd_v=da.v_head_dim)))
    trained_d["head_ms"] = head_device_ms(torch, DTRAIN, dtp, 2, 512)
    check(trained_d["head_ms"] > 0, "the head's time was not measured")
    print(f"  the head and its cross-entropy at that step's shape (forward "
          f"and backward, profiled alone): {trained_d['head_ms']:.3f} ms "
          f"device against the profiled step's {trained_d['device_ms']:.2f}",
          flush=True)
    del dtp, d_args
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 6-7. rwkv6-1.6b at full width -----------------------------------
    rparams = api.init_params(torch.Generator(device=device).manual_seed(0),
                              rcfg)
    n_params = sum(t.numel() for t in _leaves(rparams))
    section(f"== 6. serve {rcfg.name} at full width ({rcfg.num_layers} layers, "
            f"d_model {rcfg.d_model}, vocab {rcfg.vocab_size}, "
            f"{n_params / 1e6:.1f} M f32 params)")
    served_r = phase_serve(torch, np, rcfg, rparams, device, kernels, serve)
    n = served_r["launches"]
    want = rcfg.num_layers * 8
    check(n["rwkv6_scan"] == want, f"rwkv6_scan launched {n['rwkv6_scan']} "
          f"times, want {rcfg.num_layers} layers x 8 admissions = {want}")
    check(all(calls == 0 for name, calls in n.items() if name != "rwkv6_scan"),
          f"serving {rcfg.name} launched another kernel: {n}")
    prof_r = phase_profile(torch, rcfg, rparams, device, steps, api)
    section("== 7a. prefill 2 x 256 tokens through rwkv6_scan")
    pre_r = phase_prefill(torch, np, rcfg, rparams, device, kernels,
                          {"rwkv6_scan": rcfg.num_layers}, steps, api, batch=2)
    section("== 13b. the count against the card: rwkv6-1.6b f32 prefill 4 x "
            "256")
    cost_cells.append(phase_cost_cell(
        torch, "rwkv6-1.6b prefill 4 x 256", rcfg,
        ShapeConfig("prefill", 256, 4, "prefill"),
        steps.make_prefill_step(rcfg),
        (rparams, {"tokens": _prompts(torch, np, rcfg, device, 4, 256)}),
        kernels, want=("rwkv6_scan",)))
    section("== 7b. 2-slot server equals solo at full width")
    solo_err = phase_server_solo(torch, np, rcfg, rparams, device, serve)
    del rparams
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 8-9. jamba-1.5-large-398b, first 5 layers at full width, bf16 ----
    from repro_torch.configs.jamba_1_5_large_398b import CARD as jcfg
    held_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    jparams = api.init_params(torch.Generator(device=device).manual_seed(0),
                              jcfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = list(_leaves(jparams))
    n_params = sum(t.numel() for t in leaves)
    gbytes = sum(t.numel() * t.element_size() for t in leaves) / 1e9
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    section(f"== 8. serve {jcfg.name} cut to {jcfg.num_layers} layers at full "
            f"width (d_model {jcfg.d_model}, {jcfg.moe.num_experts} experts of "
            f"d_ff {jcfg.moe.d_ff_expert}, vocab {jcfg.vocab_size}, "
            f"{n_params / 1e9:.2f} B {jcfg.param_dtype} params, {gbytes:.1f} GB; "
            f"init {init_s:.1f} s, peak {peak_gb:.1f} GB with {held_gb:.2f} GB "
            "held before it)")
    n_ssm = jcfg.layer_kinds().count("ssm")
    n_attn = jcfg.layer_kinds().count("attn")
    served_j = phase_serve(torch, np, jcfg, jparams, device, kernels, serve)
    n, calls = served_j["launches"], served_j["decode_calls"]
    want = {"ssm_scan": n_ssm * (8 + calls),
            "decode_attention": n_attn * calls,
            "flash_attention": n_attn * 8}
    want = {name: want.get(name, 0) for name in kernels}
    check(n == want, f"serving {jcfg.name} launched {n}, want {want} "
          f"({n_ssm} Mamba and {n_attn} attention layers, 8 admissions, "
          f"{calls} decode calls)")
    prof_j = phase_profile(torch, jcfg, jparams, device, steps, api)
    # prefill routes a prompt as one group and may drop tokens over an
    # expert's capacity, which one-token decode steps never do: compare the
    # two dropless, as the reference's consistency tests run MoE
    dropless = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, capacity_factor=-1.0))
    want = {"ssm_scan": n_ssm, "flash_attention": n_attn}
    section("== 9a. prefill 2 x 128 tokens through ssm_scan and "
            "flash_attention (dropless MoE), computed in f32 from the same "
            "bf16 weights")
    pre_j32 = phase_prefill(torch, np, dataclasses.replace(
        dropless, compute_dtype="float32"), jparams, device, kernels, want,
        steps, api, batch=2, length=128)
    torch.cuda.empty_cache()
    section("== 9b. the same in bf16, as served, against bf16's own rounding")
    pre_j = phase_prefill_bf16(torch, np, dropless, jparams, device, steps,
                               api)
    torch.cuda.empty_cache()
    section("== 9c. 2-slot server equals solo at full width, bf16")
    solo_err_j = phase_server_solo(torch, np, jcfg, jparams, device, serve)
    del jparams, leaves
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 10. DilatedVGG at 1024 x 2048, bf16 -------------------------------
    vcfg = get_arch("dilated-vgg").model
    section(f"== 10. {vcfg.name} at {vcfg.convnet.in_hw[0]} x "
            f"{vcfg.convnet.in_hw[1]} in {vcfg.compute_dtype}: forward and its "
            "layers, bf16 against f32, card against CPU, training")
    dvgg = phase_dilated_vgg(torch, vcfg, device, api, steps, adamw,
                             OptimizerConfig, kernels)
    cost_cells.append(dvgg.pop("cost"))
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 11. deepseek-v2-236b, first 4 layers at full width, bf16 ----------
    from repro_torch.configs.deepseek_v2_236b import CARD as dcfg
    t11 = time.perf_counter()
    held_gb_d = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dparams = api.init_params(torch.Generator(device=device).manual_seed(0),
                              dcfg)
    torch.cuda.synchronize()
    init_s_d = time.perf_counter() - t0
    dleaves = list(_leaves(dparams))
    n_params_d = sum(t.numel() for t in dleaves)
    gbytes_d = sum(t.numel() * t.element_size() for t in dleaves) / 1e9
    del dleaves
    a = dcfg.attention
    section(f"== 11. serve {dcfg.name} cut to {dcfg.num_layers} layers at full "
            f"width (d_model {dcfg.d_model}, MLA {a.num_heads} heads, "
            f"kv_lora_rank {a.kv_lora_rank}, q_lora_rank {a.q_lora_rank}, "
            f"nope {a.qk_nope_head_dim} + rope {a.qk_rope_head_dim}, v "
            f"{a.v_head_dim}; a dense prefix layer of d_ff "
            f"{dcfg.moe.d_ff_dense} and {dcfg.num_layers - 1} MoE layers of "
            f"{dcfg.moe.num_experts} experts top-{dcfg.moe.num_experts_per_tok}"
            f" of d_ff {dcfg.moe.d_ff_expert} + {dcfg.moe.num_shared_experts} "
            f"shared; vocab {dcfg.vocab_size}; {n_params_d / 1e9:.2f} B "
            f"{dcfg.param_dtype} params, {gbytes_d:.1f} GB; init {init_s_d:.1f} "
            f"s, peak {torch.cuda.max_memory_allocated() / 1e9:.1f} GB with "
            f"{held_gb_d:.2f} GB held before it)")
    served_d = phase_serve(torch, np, dcfg, dparams, device, kernels, serve,
                           max_len=128, prompt_range=(16, 65))
    section("== 13d. the count against the card: deepseek-v2 CARD bf16 decode "
            "(4 slots, 128 positions)")
    state = api.allocate_decode_state(dcfg, 4, 128, device)
    cost_cells.append(phase_cost_cell(
        torch, "deepseek-v2 CARD decode B 4 S 128", dcfg,
        ShapeConfig("decode", 128, 4, "decode"), steps.make_serve_step(dcfg),
        (dparams, state, torch.arange(1, 5, dtype=torch.int32, device=device),
         torch.tensor([96, 80, 64, 48], dtype=torch.int32, device=device)),
        kernels, want=("mla_decode",),
        scratch=mops.scratch_bytes(
            torch.empty(4, dcfg.attention.num_heads,
                        dcfg.attention.kv_lora_rank, dtype=torch.bfloat16,
                        device="meta"),
            torch.empty(4, 128, dcfg.attention.qk_rope_head_dim,
                        dtype=torch.bfloat16, device="meta"),
            sm_count(torch.device(device)))))
    del state
    n, calls = served_d["launches"], served_d["decode_calls"]
    want = {name: 0 for name in kernels}
    want["mla_decode"] = dcfg.num_layers * calls
    check(n == want, f"serving {dcfg.name} launched {n}, want {want} "
          f"({dcfg.num_layers} MLA layers, {calls} decode calls, admission "
          "token by token: no prefill)")
    print("  decode step over the served cache (4 slots at 96, 80, 64, 48 of "
          "128):")
    prof_d = phase_profile(torch, dcfg, dparams, device, steps, api,
                           max_len=128, pos=(96, 80, 64, 48))
    print("  decode step over a 32,768-position cache of random latents (4 "
          "slots at 4095, 8191, 16383, 32767):")
    prof_d32k = phase_profile(torch, dcfg, dparams, device, steps, api,
                              max_len=32768, pos=(4095, 8191, 16383, 32767),
                              random_cache=True)
    moe_ms = moe_decode_ms(torch, dcfg, dparams, device)
    n_moe = dcfg.ffn_kinds().count("moe")
    moe_share = {key: (n_moe * moe_ms / prof["device_ms"]
                       if prof["device_ms"] else None)
                 for key, prof in (("served", prof_d), ("32k", prof_d32k))}
    print(f"  one MoE FFN at the decode step: {moe_ms:.4f} ms device; "
          f"{n_moe} of them take {moe_share['served']:.1%} of the served "
          f"step's device time, {moe_share['32k']:.1%} at 32k", flush=True)
    torch.cuda.empty_cache()
    # prefill routes a prompt as one group and may drop tokens over an
    # expert's capacity, which one-token decode steps never do: dropless
    ddropless = dataclasses.replace(dcfg, moe=dataclasses.replace(
        dcfg.moe, capacity_factor=-1.0))
    section("== 11a. prefill = decode, 2 x 48 tokens, in bf16 as served "
            "(dropless MoE), against bf16's own rounding")
    reset_counts(kernels)
    pre_d = phase_prefill_bf16(torch, np, ddropless, dparams, device, steps,
                               api, length=48)
    n = launches_of(kernels)
    want = {name: 0 for name in kernels}
    want.update(flash_attention=2 * dcfg.num_layers,
                mla_decode=48 * dcfg.num_layers)
    check(n == want, f"prefill = decode launched {n}, want {want}")
    k2_mla_launches = n["flash_attention"]
    torch.cuda.empty_cache()
    section("== 11b. prefill = decode, 2 x 48 tokens, the first 2 layers in f32 "
            "(dropless MoE) at 2e-3")
    d32 = first_layers_f32(torch, dparams, 2)
    pre_d32 = phase_prefill(torch, np, dataclasses.replace(
        ddropless, num_layers=2, param_dtype="float32",
        compute_dtype="float32"), d32, device, kernels,
        {"flash_attention": 2}, steps, api, batch=2, length=48)
    del d32
    gc.collect()
    torch.cuda.empty_cache()
    section("== 11c. one MLA block at full width in f32 (prefill, then 8 decode "
            "steps): card against CPU")
    block_d = phase_mla_block(torch, dcfg, dparams, device, kernels)
    del dparams
    gc.collect()
    torch.cuda.empty_cache()
    phase11_s = time.perf_counter() - t11
    print(f"phase 11: {phase11_s:.1f} s", flush=True)

    # ---- 12. internvl2-2b and seamless-m4t-large-v2, whole, bf16 ----------
    t12 = time.perf_counter()
    stub_kw = dict(torch=torch, np=np, device=device, kernels=kernels,
                   steps=steps, api=api, train=train, adamw=adamw,
                   OptimizerConfig=OptimizerConfig, pipeline=pipeline)
    section("== 12a. internvl2-2b at full width and depth, bf16: 4 rows of "
            "1,024 patch embeddings and 64 prompt tokens, 32 greedy steps; "
            "against one forward; 2 layers in f32 card = CPU; 3 train steps "
            "of 256 patches + 512 tokens at half depth (12 layers)")
    vlm = phase_stub_model(cfg=get_arch("internvl2-2b").model, n_embeds=1024,
                           n_tokens=64, k2_layer=1, k1_layer=1, train_seq=512,
                           **stub_kw)
    section("== 12b. seamless-m4t-large-v2 at full width and depth, bf16: 4 "
            "rows of 1,024 frames and 16 prompt tokens, 32 greedy steps; "
            "against one forward; 2 + 2 layers in f32 card = CPU; 3 train "
            "steps of 512 frames + 512 tokens at half depth (12 + 12 layers)")
    audio = phase_stub_model(cfg=get_arch("seamless-m4t-large-v2").model,
                             n_embeds=1024, n_tokens=16, k2_layer=3,
                             k1_layer=2, train_seq=1024, **stub_kw)
    phase12_s = time.perf_counter() - t12
    print(f"phase 12: {phase12_s:.1f} s", flush=True)

    # ---- 14. qwen2.5-14b whole and mistral-large-123b CARD, bf16 --------
    from repro_torch.configs.mistral_large_123b import CARD as mcfg
    t14 = time.perf_counter()
    dense_kw = dict(torch=torch, np=np, device=device, kernels=kernels,
                    steps=steps, api=api, serve=serve)
    qcfg = get_arch("qwen2.5-14b").model
    section(f"== 14a. serve {qcfg.name} at full width and depth "
            f"({qcfg.num_layers} layers, bf16): 4 requests of 16-64 prompt "
            "tokens, 16 new tokens, 4 slots of 128 positions; one decode step "
            "profiled; prefill = decode in bf16 and, on the first 2 layers in "
            "f32, at 2e-3; 2 layers in f32 card = CPU; the decode step and a "
            "prefill counted (13f, 13g)")
    qwen25 = phase_dense_gqa(cfg=qcfg, f32_layers=2, cost_cells=cost_cells,
                             **dense_kw)
    section(f"== 14b. serve {mcfg.name} CARD (its first {mcfg.num_layers} of "
            "88 layers at full width, bf16): the same traffic; one decode step "
            "profiled; prefill = decode in bf16; the first layer in f32 card = "
            "CPU")
    mistral = phase_dense_gqa(cfg=mcfg, f32_layers=1, prefill_f32=False,
                              **dense_kw)
    phase14_s = time.perf_counter() - t14
    print(f"phase 14: {phase14_s:.1f} s", flush=True)

    # ---- 13. the count against the card (run inside the phases above) -----
    phase13_s = sum(c["phase_s"] for c in cost_cells)
    section(f"== 13. the count against the card, {len(cost_cells)} cells in "
            f"{phase13_s:.1f} s ({card}):")
    print("  cell | GFLOP | GB | t_compute ms | t_memory ms | bound ms | "
          "measured ms | ratio | dominant | roofline fraction | peak GB | "
          "temp B | requested B (allowance) | allocated B")
    for c in cost_cells:
        print(f"  {c['cell']} | {c['flops'] / 1e9:.3f} | "
              f"{c['hbm_bytes'] / 1e9:.4f} | {c['t_compute_ms']:.4f} | "
              f"{c['t_memory_ms']:.4f} | {c['bound_ms']:.4f} | "
              f"{c['measured_ms']:.4f} | {c['ratio']:.2f} | {c['dominant']} |"
              f" {c['roofline_fraction']:.4f} | {c['peak_bytes'] / 1e9:.4f} |"
              f" {c['temp_bytes']:,} | {c['requested_bytes']:,} "
              f"({c['scratch_bytes'] + SCALAR_SLACK:,}) | "
              f"{c['growth_bytes']:,}")

    # ---- 15. the mesh ----------------------------------------------------
    section("== 15. the mesh: (a) a one-rank NCCL mesh (1, 1) = no mesh on "
            "qwen1.5-0.5b (prefill, decode, a train step in f32 and one "
            "with bf16 products), on granite-moe-1b-a400m in bf16, its "
            "experts on \"model\" (prefill, decode, a train step with bf16 "
            "products), on jamba-1.5-large-398b, its Mamba channels on "
            "\"model\" (CARD bf16: prefill, decode; TRAIN_CARD f32: a train "
            "step through K3's backward), and on rwkv6-1.6b in f32, its "
            "heads on \"model\" (whole: prefill, decode; its first 4 layers: "
            "a train step through K4's backward); (b) K1's log-sum-exp and "
            "its merge over 2 and 16 key shards; (c) qwen1.5-0.5b and "
            "granite-moe-1b-a400m decode_32k and jamba-1.5-large-398b and "
            "rwkv6-1.6b long_500k counted on (16, 16)")
    meshed = phase_mesh(torch, np, device, kernels, steps, api, adamw,
                        get_arch, OptimizerConfig, ShapeConfig, dops, gen)

    # ---- summary ---------------------------------------------------------
    launches = {"decode_attention": served["launches"]["decode_attention"],
                "flash_attention": pre["launches"]["flash_attention"],
                "ssm_scan": served_j["launches"]["ssm_scan"],
                "rwkv6_scan": served_r["launches"]["rwkv6_scan"],
                "flash_attention_bwd":
                    trained["launches"]["flash_attention_bwd"],
                "rwkv6_scan_bwd": trained_r["launches"]["rwkv6_scan_bwd"],
                "ssm_scan_bwd": trained_j["launches"]["ssm_scan_bwd"],
                "mla_decode": served_d["launches"]["mla_decode"]}
    print("kernels: " + " ".join(f"{k}={v}" for k, v in launches.items()))
    source = {"decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                                   "src/repro/kernels/decode_attention/kernel.py:64"),
              "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                                  "src/repro/kernels/flash_attention/kernel.py:71"),
              "ssm_scan": ("src/repro_torch/csrc/ssm_scan.cu",
                           "src/repro/kernels/ssm_scan/kernel.py:61"),
              "rwkv6_scan": ("src/repro_torch/csrc/rwkv6_scan.cu",
                             "src/repro/kernels/rwkv6_scan/kernel.py:73"),
              # new kernels: the TPU kernels they differentiate are
              # forward-only
              "flash_attention_bwd": (
                  "src/repro_torch/csrc/flash_attention_bwd.cu",
                  "src/repro/kernels/flash_attention/kernel.py:71"),
              "rwkv6_scan_bwd": ("src/repro_torch/csrc/rwkv6_scan_bwd.cu",
                                 "src/repro/kernels/rwkv6_scan/kernel.py:73"),
              "ssm_scan_bwd": ("src/repro_torch/csrc/ssm_scan_bwd.cu",
                               "src/repro/kernels/ssm_scan/kernel.py:61"),
              # no TPU kernel: the reference's absorbed decode is XLA einsums
              "mla_decode": ("src/repro_torch/csrc/mla_decode.cu",
                             "src/repro/models/attention.py:200")}
    kernel_rows = []
    for name, row in main_rows.items():
        kernel_rows.append({
            "name": name, "route": "cuda", "source": source[name][0],
            "replaces": source[name][1], "launches": launches[name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "wall_ms": row["wall_ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": row["shape"], "dtype": row["dtype"],
            **({"design_bound_ms": row["design_bound_ms"]}
               if "design_bound_ms" in row else {})})
    # K2 at MLA's expanded shape (bf16, S 512): its numbers beside the row's
    k2_row = next(r for r in kernel_rows if r["name"] == "flash_attention")
    k2_row["mla"] = {key: k2_mla[key] for key in (
        "shape", "dtype", "max_abs_err", "ms", "wall_ms", "plain_ms",
        "bound_ms", "bound_by", "library_ms")}
    k2_row["mla"]["launches"] = k2_mla_launches
    # K2's backward at MLA's widths (bf16, TRAIN_CARD's step), launched
    # once a step of train (h)
    bwd_row = next(r for r in kernel_rows
                   if r["name"] == "flash_attention_bwd")
    bwd_row["mla"] = {key: mla_bwd[0][key] for key in (
        "shape", "dtype", "max_abs_err", "ms", "wall_ms", "plain_ms",
        "bound_ms", "bound_by", "library_ms", "design_bound_ms")}
    bwd_row["mla"]["launches"] = trained_d["launches"]["flash_attention_bwd"]
    # phase 12's shapes (bf16), each with its launches in phase 12's run
    row_of = {r["name"]: r for r in kernel_rows}
    for name, key, launches_12 in (
            ("decode_attention", "k1 internvl2 decode",
             vlm["serve"]["launches_decode"]["decode_attention"]),
            ("decode_attention", "k1 seamless cross decode",
             audio["serve"]["launches_decode"]["decode_attention"] // 2),
            ("flash_attention", "k2 internvl2 prefill",
             vlm["serve"]["launches_prefill"]["flash_attention"]),
            ("flash_attention", "k2 seamless encoder",
             audio["serve"]["launches_prefill"]["flash_attention"] // 3),
            ("flash_attention", "k2 seamless cross",
             audio["serve"]["launches_prefill"]["flash_attention"] // 3),
            ("flash_attention_bwd", "bwd internvl2 train",
             vlm["train"]["launches"]["flash_attention_bwd"]),
            ("flash_attention_bwd", "bwd seamless train",
             audio["train"]["launches"]["flash_attention_bwd"])):
        row_of[name][key.split(" ", 1)[1]] = sub_row_of(
            next(r for r in slice12[key] if r["dtype"] == "bfloat16"),
            launches_12)
    # phase 14's shapes (bf16): K1 with its launches in phase 14's serving,
    # K2 with its launches in the counted prefill of 4 x 128 (cell 13g)
    prefill_cell = next(c for c in cost_cells
                        if c["cell"] == f"{qcfg.name} prefill 4 x 128")
    for name, key, launches_14 in (
            ("decode_attention", "k1 qwen2.5-14b decode",
             qwen25["serve"]["launches"]["decode_attention"]),
            ("decode_attention", "k1 mistral-large-123b decode",
             mistral["serve"]["launches"]["decode_attention"]),
            ("flash_attention", "k2 qwen2.5-14b prefill",
             prefill_cell["launches"]["flash_attention"])):
        row_of[name][key.split(" ", 1)[1]] = sub_row_of(slice14[key],
                                                        launches_14)
    # phase 15's K1 with its log-sum-exp (bf16, qwen2.5-14b's heads): the
    # card's one-rank mesh decodes by heads, so the main path launches it
    # 0 times; a mesh of 2 or more "model" ranks takes it once a layer
    row_of["decode_attention"]["lse qwen2.5-14b"] = sub_row_of(
        meshed["b"][2], 0)
    # phase 15's granite-moe-1b-a400m (bf16), jamba-1.5-large-398b (CARD
    # bf16, TRAIN_CARD f32) and rwkv6-1.6b (f32), with their launches in the
    # one-rank mesh's prefill, decode steps and train step
    granite, jamba, rwkv = (meshed["a"][k] for k in ("granite", "jamba",
                                                     "rwkv"))
    slice15["bwd jamba-1.5-large-398b train"] = rows["ssm_scan_bwd"][1]
    for name, key, launches_15 in (
            ("decode_attention", "k1 granite-moe-1b-a400m decode",
             granite["launches_decode"]["decode_attention"]),
            ("flash_attention", "k2 granite-moe-1b-a400m prefill",
             granite["launches_prefill"]["flash_attention"]),
            ("flash_attention_bwd", "bwd granite-moe-1b-a400m train",
             granite["train"]["launches"]["flash_attention_bwd"]),
            ("decode_attention", "k1 jamba-1.5-large-398b decode",
             jamba["launches_decode"]["decode_attention"]),
            ("flash_attention", "k2 jamba-1.5-large-398b prefill",
             jamba["launches_prefill"]["flash_attention"]),
            ("ssm_scan", "k3 jamba-1.5-large-398b prefill",
             jamba["launches_prefill"]["ssm_scan"]),
            ("ssm_scan", "k3 jamba-1.5-large-398b decode",
             jamba["launches_decode"]["ssm_scan"]),
            ("ssm_scan", "k3 jamba-1.5-large-398b train",
             jamba["train"]["launches"]["ssm_scan"]),
            ("ssm_scan_bwd", "bwd jamba-1.5-large-398b train",
             jamba["train"]["launches"]["ssm_scan_bwd"]),
            ("rwkv6_scan", "k4 rwkv6-1.6b prefill",
             rwkv["launches_prefill"]["rwkv6_scan"]),
            ("rwkv6_scan", "k4 rwkv6-1.6b train",
             rwkv["train"]["launches"]["rwkv6_scan"]),
            ("rwkv6_scan_bwd", "bwd rwkv6-1.6b train",
             rwkv["train"]["launches"]["rwkv6_scan_bwd"])):
        row_of[name][key.split(" ", 1)[1]] = sub_row_of(slice15[key],
                                                        launches_15)
    print("phase 15 (a) jamba's launches on the one-rank mesh: K3 "
          f"{jamba['launches_prefill']['ssm_scan']} (prefill) + "
          f"{jamba['launches_decode']['ssm_scan']} (decode) + "
          f"{jamba['train']['launches']['ssm_scan']} (train), K3's backward "
          f"{jamba['train']['launches']['ssm_scan_bwd']}, K1 "
          f"{jamba['launches_decode']['decode_attention']}, K2 "
          f"{jamba['launches_prefill']['flash_attention']}", flush=True)
    print("phase 15 (a) rwkv6-1.6b's launches on the one-rank mesh: K4 "
          f"{rwkv['launches_prefill']['rwkv6_scan']} (prefill) + "
          f"{rwkv['launches_decode']['rwkv6_scan']} (decode) + "
          f"{rwkv['train']['launches']['rwkv6_scan']} (train), K4's backward "
          f"{rwkv['train']['launches']['rwkv6_scan_bwd']}", flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(
            {"card": card, "build_s": build_s, "ptxas": ptxas, "sass": sass,
             "cases": rows, "mla_balance": mla_balance,
             "kernels": kernel_rows, "serve": served, "profile": prof,
             "ragged_err": ragged_err, "prefill": pre,
             "train_step_vs_cpu": step_vs_cpu, "train": trained,
             "train_bf16": trained_bf16,
             "grad_check": grad_check, "train_step_vs_cpu_rwkv": step_vs_cpu_r,
             "mixer_vs_cpu": mixer_vs_cpu, "train_rwkv": trained_r,
             "train_jamba": trained_j, "grad_check_deepseek": grad_check_d,
             "train_step_vs_cpu_deepseek": step_vs_cpu_d,
             "train_deepseek": trained_d,
             "serve_rwkv": served_r, "profile_rwkv": prof_r,
             "prefill_rwkv": pre_r, "server_solo_err_rwkv": solo_err,
             "jamba": {"params": n_params, "gbytes": gbytes, "init_s": init_s,
                       "peak_gb": peak_gb, "held_gb": held_gb},
             "serve_jamba": served_j, "profile_jamba": prof_j,
             "prefill_jamba_f32": pre_j32, "prefill_jamba": pre_j,
             "server_solo_err_jamba": solo_err_j, "dilated_vgg": dvgg,
             "deepseek": {"params": n_params_d, "gbytes": gbytes_d,
                          "init_s": init_s_d, "held_gb": held_gb_d,
                          "phase_s": phase11_s},
             "serve_deepseek": served_d, "profile_deepseek": prof_d,
             "profile_deepseek_32k": prof_d32k, "moe_decode_ms": moe_ms,
             "moe_share": moe_share, "prefill_deepseek": pre_d,
             "prefill_deepseek_f32": pre_d32, "mla_block": block_d,
             "slice12_cases": slice12, "internvl2": vlm,
             "seamless": audio, "phase12_s": phase12_s,
             "slice14_cases": slice14, "slice15_cases": slice15,
             "qwen2.5-14b": qwen25,
             "mistral-large-123b CARD": mistral, "phase14_s": phase14_s,
             "cost_cells": cost_cells, "phase13_s": phase13_s,
             "mesh": meshed,
             "total_s": time.perf_counter() - t_start}, indent=1))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernel_rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def sub_row_of(row, launches) -> dict:
    """A phase-2 row's numbers as a sub-row of the kernels line, with the
    kernel's launches at that shape in the main path's run."""
    return dict({k: row[k] for k in (
        "shape", "dtype", "max_abs_err", "ms", "wall_ms", "plain_ms",
        "bound_ms", "bound_by", "library_ms", "design_bound_ms")
        if k in row}, launches=launches)


def _leaves(tree):
    for _, leaf in _paths(tree):
        yield leaf


def _paths(tree, prefix=""):
    """(path, leaf) pairs of a nested dict."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


if __name__ == "__main__":
    sys.exit(main())
