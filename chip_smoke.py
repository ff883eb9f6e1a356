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
   forward, at qwen's training shape in f32 and bf16, a GQA group of 2 at
   hd 128 and a query offset;
3. serve 8 requests with the port's ``BatchedServer`` on qwen1.5-0.5b at
   full width (24 layers, d_model 1024, vocab 151,936, f32, random weights
   from a seed): every decode step must go through the decode kernel;
4. check that two requests decoded in one batch at different depths give
   the logits each gives alone;
5. prefill 4 prompts of 256 tokens through the flash-attention kernel and
   check the last logits and the cache against the decode path fed the
   same prompts;
   then train: (a) one train step of qwen1.5-0.5b cut to 2 layers at full
   width on the card and on the CPU from the same params and batch (loss,
   grad norm, params after the step), and the same step under remat "dots"
   and "full"; (b) qwen1.5-0.5b at full width and depth in f32, batch 4 x
   512, 30 steps through ``launch/train.py``'s ``main`` with a checkpoint:
   the loss must fall, every step runs the flash-attention kernel and its
   backward once per layer, one step is profiled; (c) under grad mode, the
   forward-only kernels (the WKV and selective scans, flash-decode) raise;
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
   logits it gets alone.

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
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# the port's kernels, by the name of their __global__ function (each is
# defined at the start of a line of src/repro_torch/csrc/*.cu)
PORT_KERNELS = {name for src in (ROOT / "src" / "repro_torch" / "csrc").glob("*.cu")
                for name in re.findall(r"^(\w+_kernel)\(", src.read_text(), re.M)}
# H100 SXM data sheet peaks (dense), used for each kernel's bound
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
# tests/test_kernels.py's tolerances
TOL = {"float32": dict(atol=3e-5, rtol=0.0),
       "bfloat16": dict(atol=3e-2, rtol=1e-2)}
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
# full-width consistency checks: prefill = decode at 2e-3 for a model
# computed in f32 (tests/test_models.py); the same function at another batch
# (ragged = solo, 2-slot server = solo) at 1e-4, in f32 or bf16
PREFILL_TOL = dict(atol=2e-3, rtol=2e-3)
SOLO_TOL = dict(atol=1e-4, rtol=0.0)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


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


def time_ms(torch, fn, reps: int = 7, inner: int = 10) -> tuple:
    """(device ms, wall ms) of one call: medians over ``reps`` of the mean
    of ``inner`` back-to-back calls, by CUDA events, after warm-up.

    The device figure enqueues each batch behind ``torch.cuda._sleep`` long
    enough to cover the host's enqueue of the batch (twice the time the host
    took for one batch, plus 0.2 ms), so the events time the device's work
    alone.  The wall figure has no sleep: below ~0.05 ms a call it reads the
    host's time per call (checks, allocation, the launch); it is the only
    figure this script gave before it timed the device."""
    for _ in range(3):
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
    call (None where there is none)."""
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


def _ptxas_summary(log: str) -> list:
    """(kernel, "N registers, S bytes spill stores") per kernel that
    ``nvcc -Xptxas -v`` reported, the kernel's name cut from its mangling."""
    out, kernel, spill = [], None, ""
    for line in log.splitlines():
        if "Function properties for" in line:
            mangled = line.rsplit(" ", 1)[-1]
            kernel = re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]+\d+", "",
                            mangled).split("EEv")[0]
        elif "spill stores" in line:
            spill = line.split(",")[1].strip()
        elif "registers" in line and kernel:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out.append((kernel, f"{regs} registers, {spill}"))
            kernel = None
    return out


def _tensor_core_ops(so: Path, op: str) -> tuple:
    """(count, how many of them wait for their group's end (gsb0), first)
    of the SASS instructions named ``op`` (HGMMA, HMMA) in a built kernel
    library, by cuobjdump.  Only a group's last HGMMA waits unless ptxas
    serialized the group."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    res = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                         text=True, timeout=300)
    check(res.returncode == 0, f"cuobjdump failed: {res.stderr.strip()}")
    found = [line.split("*/", 1)[1].split(";")[0].strip()
             for line in res.stdout.splitlines() if f" {op}." in line]
    return (len(found), sum("gsb0" in f for f in found),
            found[0] if found else None)


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

    elem = q.element_size()
    valid = sum(kv_len)
    nbytes = (2 * valid * Hkv * hd + 2 * B * Hq * hd) * elem + 4 * B
    flops = 4.0 * valid * Hq * hd
    return dict(
        shape=f"B={B} Hq={Hq} Hkv={Hkv} S={S} hd={hd} kv_len={kv_len}",
        dtype=dtype, max_abs_err=err,
        **_timings(torch, lambda: dops.decode_attention(q, k, v, lens),
                   lambda: dops.decode_attention_ref(q, k, v, lens), library),
        **_bound(nbytes, flops, dtype))


def flash_case(torch, F, fops, B, Hq, Hkv, Sq, Sk, hd, causal, q_offset,
               dtype, gen):
    dt = getattr(torch, dtype)
    q = torch.randn(B, Hq, Sq, hd, device="cuda", generator=gen).to(dt)
    k = torch.randn(B, Hkv, Sk, hd, device="cuda", generator=gen).to(dt)
    v = torch.randn(B, Hkv, Sk, hd, device="cuda", generator=gen).to(dt)
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

    if causal:   # visible (query, key) pairs
        pairs = sum(min(Sk, max(0, q_offset + i + 1)) for i in range(Sq))
    else:
        pairs = Sq * Sk
    elem = q.element_size()
    nbytes = (2 * B * Hq * Sq * hd + 2 * B * Hkv * Sk * hd) * elem
    flops = 4.0 * B * Hq * pairs * hd
    return dict(
        shape=(f"B={B} Hq={Hq} Hkv={Hkv} Sq={Sq} Sk={Sk} hd={hd} "
               f"causal={causal} q_offset={q_offset}"),
        dtype=dtype, max_abs_err=err,
        **_timings(torch, lambda: fops.flash_attention(q, k, v, **kw),
                   lambda: fops.attention_ref(q, k, v, **kw), library),
        library_causal_ms=(time_ms(torch, library_causal)[0]
                           if causal and q_offset == 0 and Sq == Sk else None),
        **_bound(nbytes, flops, dtype))


def flash_bwd_case(torch, F, fops, bops, B, Hq, Hkv, Sq, Sk, hd, causal,
                   q_offset, dtype, gen):
    """One check of the flash-attention backward kernel + timings.  The
    forward kernel's row log-sum-exps are held to the plain version's; the
    backward kernel, fed the forward kernel's output and lse, to the plain
    backward fed the same, and to autograd over the plain forward; the
    autograd path (``flash_attention`` under grad) must give the kernel's
    gradients bit for bit."""
    dt = getattr(torch, dtype)
    q, k, v, do = (torch.randn(*shape, device="cuda", generator=gen).to(dt)
                   for shape in ((B, Hq, Sq, hd), (B, Hkv, Sk, hd),
                                 (B, Hkv, Sk, hd), (B, Hq, Sq, hd)))
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

    if causal:   # visible (query, key) pairs
        pairs = sum(min(Sk, max(0, q_offset + i + 1)) for i in range(Sq))
    else:
        pairs = Sq * Sk
    elem = q.element_size()
    # read q, k, v, o, do and lse; write dq, dk, dv.  Five products: S and dP
    # recomputed, dV, dQ, dK
    nbytes = (4 * B * Hq * Sq * hd + 4 * B * Hkv * Sk * hd) * elem \
        + 4 * B * Hq * Sq
    flops = 10.0 * B * Hq * pairs * hd
    return dict(
        shape=(f"B={B} Hq={Hq} Hkv={Hkv} Sq={Sq} Sk={Sk} hd={hd} "
               f"causal={causal} q_offset={q_offset}"),
        dtype=dtype, max_abs_err=err, err_vs_autograd=err_auto,
        lse_err=lse_err,
        **_timings(torch,
                   lambda: bops.flash_attention_bwd(q, k, v, out, lse, do, **kw),
                   lambda: fops.ref.attention_bwd_ref(q, k, v, out, lse, do,
                                                      **kw), library),
        launch_us=launch_us(torch, lambda: bops.flash_attention_bwd(
            q, k, v, out, lse, do, **kw)),
        **_bound(nbytes, flops, dtype))


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
    # r, k, v read once in their dtype, logw once in f32, y written once in
    # f32, the state read and written once, u read once
    nbytes = ((3 * r.element_size() + 4) * N * S * hd + 4 * N * S * hd
              + 8 * N * hd * hd + 4 * N * hd)
    flops = 4.0 * N * S * hd * hd      # read-out + update, one FMA each
    shape = f"N={N} S={S} hd={hd}" \
        + (f" logw={logw_value:g}" if logw_value is not None else "") \
        + (" (vs f64)" if f64 else "")
    return dict(
        shape=shape, dtype=dtype, max_abs_err=err, **extra,
        **_timings(torch, lambda: kops.rwkv6_scan(*args),
                   lambda: kops.rwkv6_scan_ref(*args), None, plain_reps=(5, 2)),
        **_bound(nbytes, flops, "float32"))


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
    n = Bz * S * di
    # u once in its dtype, dt once in f32, y written once in f32; B, C once;
    # A_log and D once; the state read and written once
    nbytes = ((u.element_size() + 8) * n + 2 * B.element_size() * Bz * S * ds
              + 4 * di * (ds + 1) + 8 * Bz * di * ds)
    # per state element and step: dt * a, exp, the update (2), dbu * B, the
    # read-out (2); per channel and step: dt * u, u * D + y (2)
    flops = 7.0 * n * ds + 3.0 * n
    return dict(
        shape=f"Bz={Bz} S={S} di={di} ds={ds} h0={'random' if h0_random else 0}"
        + (" h_out=h0" if in_place else ""),
        dtype=dtype, max_abs_err=err, **extra,
        **_timings(torch, kernel,
                   lambda: sops.ssm_scan_ref(*args), None, plain_reps=(5, 2)),
        **_bound(nbytes, flops, "float32"))


def _bound(nbytes: float, flops: float, dtype: str) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def _print_row(name, row):
    lib = row["library_ms"]
    lib = "none" if lib is None else f"{lib:.4f}/{row['library_wall_ms']:.4f}"
    print(f"  {name:17s} {row['dtype']:8s} {row['shape']:60s} "
          f"err={row['max_abs_err']:.2e} ms={row['ms']:.4f} "
          f"wall_ms={row['wall_ms']:.4f} plain_ms={row['plain_ms']:.4f}/"
          f"{row['plain_wall_ms']:.4f} library_ms={lib} "
          + (f"library_causal_ms={row['library_causal_ms']:.4f} "
             if row.get("library_causal_ms") else "")
          + (f"err_vs_autograd={row['err_vs_autograd']:.2e} lse_err="
             f"{row['lse_err']:.2e} " if "err_vs_autograd" in row else "")
          + (f"err_vs_plain={row['err_vs_plain']:.2e} plain_err="
             f"{row['plain_err']:.2e} " if "plain_err" in row else "")
          + ("launch_us=" + ",".join(f"{k}:{v:.2f}" for k, v in
                                     row["launch_us"].items()) + " "
             if "launch_us" in row else "")
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


def phase_profile(torch, cfg, params, device, steps, api, slots=4,
                  max_len=512, n=10):
    """Where one decode step's time goes: host wall time per step without
    the profiler, and device kernel time per step from torch.profiler."""
    decode = steps.make_serve_step(cfg)
    st = api.allocate_decode_state(cfg, slots, max_len, device)
    tokens = torch.arange(1, slots + 1, dtype=torch.int32, device=device)
    pos = torch.tensor([300, 200, 100, 50][:slots], dtype=torch.int32,
                       device=device)

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
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    kernels = {key: (us / n / 1e3, count / n)
               for key, (us, count) in device_kernels(prof).items()}
    device_ms = sum(ms for ms, _ in kernels.values())
    launches = sum(c for _, c in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]
    # the port's own kernels: the __global__ functions of csrc/*.cu
    port = {}
    for name, value in kernels.items():
        m = re.match(r"void \(anonymous namespace\)::(\w+)<", name)
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
    """{path: max |got - want| over max |want|} of two {path: tensor}."""
    out = {}
    for path, w in want.items():
        scale = w.abs().max().item()
        err = (got[path].cpu() - w.cpu()).abs().max().item()
        out[path] = err / scale if scale > 0 else (0.0 if err == 0 else
                                                    float("inf"))
    return out


def phase_train_step_vs_cpu(torch, cfg, device, kernels, steps, api, adamw,
                            OptimizerConfig, pipeline, batch=2, seq=256):
    """One train step on the card and on the CPU from the same params and
    batch (f32).  The gradient of every leaf (``m`` after one step from zero
    moments is 0.1 times it) agrees to 2e-3 of the leaf's largest value
    (tests/test_models.py's bound), and so do the loss and grad norm.  The
    card's params after the step equal the CPU's AdamW applied to the card's
    own gradient to 1e-6: comparing them with the CPU's step instead could
    not fail, since Adam's first step moves each element by about lr
    whatever its gradient's size.  Then the same step under remat "dots" and
    "full" on the card gives every leaf's gradient to 1e-5."""
    opt_cfg = OptimizerConfig(lr=3e-4, warmup_steps=5, total_steps=30)
    cpu_params = api.init_params(torch.Generator().manual_seed(0), cfg)
    data = pipeline.SyntheticTokenPipeline(pipeline.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch))
    tokens = torch.from_numpy(data.batch_at(0)["tokens"])
    results = {}
    for where in ("cuda", "cpu"):
        dev = device if where == "cuda" else torch.device("cpu")
        params = _to(torch, cpu_params, dev)
        step = steps.make_train_step(cfg, opt_cfg, remat="none")
        reset_counts(kernels)
        t0 = time.perf_counter()
        params, state, metrics = step(params, adamw.init_opt_state(
            params, opt_cfg), {"tokens": tokens.to(dev)})
        loss = float(metrics["loss"])
        secs = time.perf_counter() - t0
        results[where] = dict(params=params, loss=loss, s=secs,
                              grads=_grads_of(adamw, state, opt_cfg.b1),
                              grad_norm=float(metrics["grad_norm"]),
                              lr=float(metrics["lr"]),
                              launches=launches_of(kernels),
                              plain_calls=sum(ops.ref.calls
                                              for ops in kernels.values()))
    gpu, cpu = results["cuda"], results["cpu"]
    n = cfg.num_layers
    check(gpu["launches"] == {name: (n if name.startswith("flash") else 0)
                              for name in kernels}
          and gpu["plain_calls"] == 0,
          f"the card's train step launched {gpu['launches']}, want "
          f"flash_attention and flash_attention_bwd {n} times each")
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
    p_err = max((a.cpu() - b).abs().max().item() for a, b in
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
    for mode in ("dots", "full"):
        params = _to(torch, cpu_params, device)
        step = steps.make_train_step(cfg, opt_cfg, remat=mode)
        _, state, metrics = step(params, adamw.init_opt_state(
            params, opt_cfg), {"tokens": tokens.to(device)})
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


def phase_train(torch, np, cfg, kernels, steps, train, adamw, n_steps=30,
                batch=4, seq=512, profile_at=10):
    """``launch/train.py``'s own ``main`` on the card: ``n_steps`` steps of
    the synthetic pipeline, checkpointing into a temporary directory.  Each
    step is timed on the host clock, ending in a synchronise; one step is
    profiled for its device kernel time, with its AdamW update in a range of
    its own (its kernels' device time and count, and its span between two
    CUDA events).  The loss must fall by tests/test_system.py's criterion,
    and every step must run K2 and its backward once per layer and no other
    kernel."""
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
            losses = train.main(["--arch", "qwen1.5-0.5b", "--steps",
                                 str(n_steps), "--batch", str(batch),
                                 "--seq", str(seq), "--warmup", "5",
                                 "--ckpt-dir", ckpt_dir, "--ckpt-every",
                                 "1000", "--log-every", "10"])
            wall = time.perf_counter() - t0
            launches = launches_of(kernels)
            saved = sorted(os.listdir(ckpt_dir))
    finally:
        steps.make_train_step, adamw.adamw_update = make, update
    n = cfg.num_layers
    want = {name: (n * n_steps if name.startswith("flash") else 0)
            for name in kernels}
    check(launches == want and all(ops.ref.calls == 0
                                   for ops in kernels.values()),
          f"training launched {launches}, want {want}")
    check(len(losses) == n_steps and bool(np.isfinite(losses).all()),
          f"losses {losses}")
    first5, last5 = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    check(last5 < first5 - 0.05, f"the loss did not fall: first five "
          f"{first5:.4f}, last five {last5:.4f}")
    check(f"step_{n_steps:09d}" in saved, f"no checkpoint of the last step "
          f"in {saved}")
    steady = sorted(t for i, t in enumerate(times) if i not in (0, profile_at))
    step_ms = steady[len(steady) // 2] * 1e3
    kern = prof_out.get("kernels", {})
    device_ms = sum(us for us, _ in kern.values()) / 1e3
    top = sorted(kern.items(), key=lambda kv: -kv[1][0])[:8]
    tok_s = batch * seq / (step_ms / 1e3)
    print(f"trained {n_steps} steps of B={batch} x S={seq} in {wall:.1f} s "
          f"(checkpoint included); loss {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"(first five {first5:.4f}, last five {last5:.4f}); step "
          f"{step_ms:.1f} ms median host wall (first {times[0] * 1e3:.1f} "
          f"ms), {tok_s:.0f} tokens/s; K2 {launches['flash_attention'] / n_steps:.0f} "
          f"forward and {launches['flash_attention_bwd'] / n_steps:.0f} "
          "backward launches a step", flush=True)
    if device_ms > 0:
        print(f"profiled step {profile_at}: {device_ms:.2f} ms device kernel "
              f"time against {step_ms:.1f} ms a step: device idle "
              f"{1 - device_ms / step_ms:.1%}")
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
    opt_bound = n_params * 4 * 7 / HBM_BYTES_PER_S * 1e3
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
                top=[(name, us / 1e3, count) for name, (us, count) in top],
                optimizer=dict(device_ms=opt_ms or None,
                               launches=opt_launches or None,
                               span_ms=span_ms, leaves=n_leaves,
                               bound_ms=opt_bound))


def phase_grad_guard(torch, device, api, get_arch, dops):
    """Under grad mode, a forward whose kernel has no backward yet raises the
    grad guard's error on the card: rwkv6 smoke (K4), jamba smoke (K3), and
    K1 called with a query that requires grad."""
    seen = {}
    for arch, kernel in (("rwkv6-1.6b", "rwkv6_scan"),
                         ("jamba-1.5-large-398b", "ssm_scan")):
        cfg = dataclasses.replace(get_arch(arch).smoke, param_dtype="float32",
                                  compute_dtype="float32")
        params = api.init_params(torch.Generator(device=device).manual_seed(0),
                                 cfg)
        for leaf in _leaves(params):
            leaf.requires_grad_()
        tokens = torch.zeros((1, 8), dtype=torch.int64, device=device)
        try:
            api.forward(params, cfg, {"tokens": tokens}, remat="none")
        except RuntimeError as e:
            seen[kernel] = str(e)
        check(f"{kernel}: the backward of this CUDA kernel is not ported yet"
              in seen.get(kernel, ""), f"{arch} forward under grad did not "
              f"raise the {kernel} grad guard: {seen.get(kernel)}")
    q = torch.randn(1, 2, 16, device=device, requires_grad=True)
    kv = torch.randn(1, 2, 8, 16, device=device)
    try:
        dops.decode_attention(q, kv, kv, torch.tensor(
            [8], dtype=torch.int32, device=device))
    except RuntimeError as e:
        seen["decode_attention"] = str(e)
    check("decode_attention: the backward" in seen.get("decode_attention", ""),
          "decode_attention under grad did not raise the grad guard")
    with torch.no_grad():     # the guard lets no-grad callers through
        dops.decode_attention(q, kv, kv, torch.tensor(
            [8], dtype=torch.int32, device=device))
    for kernel, msg in seen.items():
        print(f"  {kernel}: raised under grad: {msg[:100]}...")
    return seen


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

    from repro_torch.core.config import OptimizerConfig, get_arch
    from repro_torch.core.device import resolve_device
    from repro_torch.data import pipeline
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import bwd as bops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.rwkv6_scan import ops as kops
    from repro_torch.kernels.ssm_scan import ops as sops
    from repro_torch.launch import serve, steps, train
    from repro_torch.models import api
    from repro_torch.optim import adamw

    kernels = {"decode_attention": dops, "flash_attention": fops,
               "flash_attention_bwd": bops, "ssm_scan": sops,
               "rwkv6_scan": kops}
    t_start = time.perf_counter()
    # ---- 1. build and device -------------------------------------------
    print("== 1. build and device", flush=True)
    device = resolve_device("cuda")        # also sets full-precision matmuls
    build_s = _build.build()
    print(f"built {_build.sources()} in {build_s:.1f} s "
          f"(nvcc {' '.join(_build.NVCC_FLAGS)})")
    ptxas = {name: _ptxas_summary(log) for name, log in _build.build_log.items()}
    for name, kernels_of in ptxas.items():
        for kernel, info in kernels_of:
            print(f"  {name}: {kernel}: {info}")
    # the bf16 products run on the tensor cores: wgmma in K2, mma.sync in K1
    sass = {}
    for name, op in (("flash_attention", "HGMMA"), ("decode_attention", "HMMA")):
        n_ops, n_wait, first = _tensor_core_ops(_build.target(name), op)
        check(n_ops > 0, f"{name}: no {op} instruction in its SASS")
        sass[name] = dict(op=op, count=n_ops, gsb0=n_wait, first=first)
        print(f"  {name}: {n_ops} {op} instructions ({n_wait} with gsb0), "
              f"e.g. `{first}`")
    card = gpu_name_and_power_limit()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)

    # ---- 2. kernels against plain versions ------------------------------
    print("== 2. kernels against their plain versions on the card", flush=True)
    gen = torch.Generator(device=device).manual_seed(0)
    rows = {name: [] for name in kernels}
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
        for case in ((4, 16, 16, 512, 512, 64, True, 0),
                     (4, 16, 16, 256, 256, 64, True, 0),      # main-path prefill
                     (2, 16, 16, 128, 512, 64, True, 384),    # q_offset
                     (2, 16, 16, 200, 520, 64, False, 320),   # Sq != Sk
                     (2, 32, 8, 512, 512, 128, True, 0)):     # minitron's GQA
            rows["flash_attention"].append(
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
    # K2's backward: qwen's training shape in f32 and in bf16, a GQA group
    # of 2 at hd 128, and a query offset with Sq < Sk
    for case in ((4, 16, 16, 512, 512, 64, True, 0, "float32"),
                 (4, 16, 16, 512, 512, 64, True, 0, "bfloat16"),
                 (2, 32, 16, 512, 512, 128, True, 0, "float32"),
                 (2, 16, 16, 128, 512, 64, True, 384, "float32")):
        rows["flash_attention_bwd"].append(flash_bwd_case(
            torch, F, fops, bops, *case[:-1], dtype=case[-1], gen=gen))
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
    for name, rs in rows.items():
        for row in rs:
            _print_row(name, row)
    # each kernel at the shape the main paths give it (f32, as served)
    main_rows = {
        "decode_attention": decode_case(torch, F, dops, 4, 16, 16, 512, 64,
                                        [17, 130, 256, 511], "float32", gen),
        "flash_attention": rows["flash_attention"][1],
        "ssm_scan": jamba_ssm[256],                 # Bz=1 S=256 prefill
        "rwkv6_scan": rows["rwkv6_scan"][2],        # f32 N=32 S=256
        "flash_attention_bwd": rows["flash_attention_bwd"][0],  # training
    }
    _print_row("decode (main)", main_rows["decode_attention"])

    # ---- 3-5. qwen1.5-0.5b at full width ---------------------------------
    cfg = dataclasses.replace(get_arch("qwen1.5-0.5b").model,
                              param_dtype="float32", compute_dtype="float32")
    params = api.init_params(torch.Generator(device=device).manual_seed(0), cfg)
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"== 3. serve {cfg.name} at full width ({cfg.num_layers} layers, "
          f"d_model {cfg.d_model}, vocab {cfg.vocab_size}, "
          f"{n_params / 1e6:.1f} M f32 params)", flush=True)
    served = phase_serve(torch, np, cfg, params, device, kernels, serve)
    n = served["launches"]
    check(n["decode_attention"] == cfg.num_layers * served["decode_calls"],
          f"decode kernel launched {n['decode_attention']} times for "
          f"{served['decode_calls']} decode calls of {cfg.num_layers} layers")
    check(n["decode_attention"] > 0, "decode kernel never launched")
    check(n["flash_attention"] == n["flash_attention_bwd"] == n["rwkv6_scan"]
          == n["ssm_scan"] == 0,
          f"serving {cfg.name} launched another kernel: {n}")
    prof = phase_profile(torch, cfg, params, device, steps, api)
    print("== 4. ragged batch equals solo decode at full width", flush=True)
    ragged_err = phase_ragged(torch, cfg, params, device, steps, api)
    print("== 5. prefill 4 x 256 tokens through flash_attention", flush=True)
    pre = phase_prefill(torch, np, cfg, params, device, kernels,
                        {"flash_attention": cfg.num_layers}, steps, api)
    del params
    gc.collect()            # the servers' closures hold params in cycles
    torch.cuda.empty_cache()

    # ---- training: qwen1.5-0.5b through K2 and its backward --------------
    print(f"== train (a). one step of {cfg.name} cut to 2 layers at full "
          "width, on the card and on the CPU from the same params", flush=True)
    step_vs_cpu = phase_train_step_vs_cpu(
        torch, dataclasses.replace(cfg, num_layers=2), device, kernels, steps,
        api, adamw, OptimizerConfig, pipeline)
    print(f"== train (b). {cfg.name} at full width and depth, f32, through "
          "launch/train.py's main", flush=True)
    trained = phase_train(torch, np, cfg, kernels, steps, train, adamw)
    print("== train (c). forward-only kernels refuse grad mode on the card",
          flush=True)
    guard = phase_grad_guard(torch, device, api, get_arch, dops)
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 6-7. rwkv6-1.6b at full width -----------------------------------
    rcfg = dataclasses.replace(get_arch("rwkv6-1.6b").model,
                               param_dtype="float32", compute_dtype="float32")
    rparams = api.init_params(torch.Generator(device=device).manual_seed(0),
                              rcfg)
    n_params = sum(t.numel() for t in _leaves(rparams))
    print(f"== 6. serve {rcfg.name} at full width ({rcfg.num_layers} layers, "
          f"d_model {rcfg.d_model}, vocab {rcfg.vocab_size}, "
          f"{n_params / 1e6:.1f} M f32 params)", flush=True)
    served_r = phase_serve(torch, np, rcfg, rparams, device, kernels, serve)
    n = served_r["launches"]
    want = rcfg.num_layers * 8
    check(n["rwkv6_scan"] == want, f"rwkv6_scan launched {n['rwkv6_scan']} "
          f"times, want {rcfg.num_layers} layers x 8 admissions = {want}")
    check(n["decode_attention"] == n["flash_attention"]
          == n["flash_attention_bwd"] == n["ssm_scan"] == 0,
          f"serving {rcfg.name} launched another kernel: {n}")
    prof_r = phase_profile(torch, rcfg, rparams, device, steps, api)
    print("== 7a. prefill 2 x 256 tokens through rwkv6_scan", flush=True)
    pre_r = phase_prefill(torch, np, rcfg, rparams, device, kernels,
                          {"rwkv6_scan": rcfg.num_layers}, steps, api, batch=2)
    print("== 7b. 2-slot server equals solo at full width", flush=True)
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
    print(f"== 8. serve {jcfg.name} cut to {jcfg.num_layers} layers at full "
          f"width (d_model {jcfg.d_model}, {jcfg.moe.num_experts} experts of "
          f"d_ff {jcfg.moe.d_ff_expert}, vocab {jcfg.vocab_size}, "
          f"{n_params / 1e9:.2f} B {jcfg.param_dtype} params, {gbytes:.1f} GB; "
          f"init {init_s:.1f} s, peak {peak_gb:.1f} GB with {held_gb:.2f} GB "
          "held before it)", flush=True)
    n_ssm = jcfg.layer_kinds().count("ssm")
    n_attn = jcfg.layer_kinds().count("attn")
    served_j = phase_serve(torch, np, jcfg, jparams, device, kernels, serve)
    n, calls = served_j["launches"], served_j["decode_calls"]
    want = {"ssm_scan": n_ssm * (8 + calls),
            "decode_attention": n_attn * calls,
            "flash_attention": n_attn * 8, "rwkv6_scan": 0,
            "flash_attention_bwd": 0}
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
    print("== 9a. prefill 2 x 256 tokens through ssm_scan and "
          "flash_attention (dropless MoE), computed in f32 from the same "
          "bf16 weights", flush=True)
    pre_j32 = phase_prefill(torch, np, dataclasses.replace(
        dropless, compute_dtype="float32"), jparams, device, kernels, want,
        steps, api, batch=2)
    torch.cuda.empty_cache()
    print("== 9b. the same in bf16, as served, against bf16's own rounding",
          flush=True)
    pre_j = phase_prefill_bf16(torch, np, dropless, jparams, device, steps,
                               api)
    torch.cuda.empty_cache()
    print("== 9c. 2-slot server equals solo at full width, bf16", flush=True)
    solo_err_j = phase_server_solo(torch, np, jcfg, jparams, device, serve)

    # ---- summary ---------------------------------------------------------
    launches = {"decode_attention": served["launches"]["decode_attention"],
                "flash_attention": pre["launches"]["flash_attention"],
                "ssm_scan": served_j["launches"]["ssm_scan"],
                "rwkv6_scan": served_r["launches"]["rwkv6_scan"],
                "flash_attention_bwd":
                    trained["launches"]["flash_attention_bwd"]}
    print("kernels: " + " ".join(f"{k}={v}" for k, v in launches.items()))
    source = {"decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                                   "src/repro/kernels/decode_attention/kernel.py:64"),
              "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                                  "src/repro/kernels/flash_attention/kernel.py:71"),
              "ssm_scan": ("src/repro_torch/csrc/ssm_scan.cu",
                           "src/repro/kernels/ssm_scan/kernel.py:61"),
              "rwkv6_scan": ("src/repro_torch/csrc/rwkv6_scan.cu",
                             "src/repro/kernels/rwkv6_scan/kernel.py:73"),
              # a new kernel: the TPU kernel it differentiates is forward-only
              "flash_attention_bwd": (
                  "src/repro_torch/csrc/flash_attention_bwd.cu",
                  "src/repro/kernels/flash_attention/kernel.py:71")}
    kernel_rows = []
    for name, row in main_rows.items():
        kernel_rows.append({
            "name": name, "route": "cuda", "source": source[name][0],
            "replaces": source[name][1], "launches": launches[name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "wall_ms": row["wall_ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": row["shape"], "dtype": row["dtype"]})
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(
            {"card": card, "build_s": build_s, "ptxas": ptxas, "sass": sass,
             "cases": rows,
             "kernels": kernel_rows, "serve": served, "profile": prof,
             "ragged_err": ragged_err, "prefill": pre,
             "train_step_vs_cpu": step_vs_cpu, "train": trained,
             "grad_guard": guard,
             "serve_rwkv": served_r, "profile_rwkv": prof_r,
             "prefill_rwkv": pre_r, "server_solo_err_rwkv": solo_err,
             "jamba": {"params": n_params, "gbytes": gbytes, "init_s": init_s,
                       "peak_gb": peak_gb, "held_gb": held_gb},
             "serve_jamba": served_j, "profile_jamba": prof_j,
             "prefill_jamba_f32": pre_j32, "prefill_jamba": pre_j,
             "server_solo_err_jamba": solo_err_j,
             "total_s": time.perf_counter() - t_start}, indent=1))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernel_rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


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
