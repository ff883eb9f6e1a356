#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
Hopper card.

    python3 chip_smoke.py [--out results.json]

Phases, in order; any failed check ends the run with a non-zero exit:

1. build the CUDA kernels from ``src/repro_torch/csrc`` with nvcc (sm_90a);
2. hold each kernel against its plain PyTorch version on the card, in f32
   and bf16, at the main path's shapes, and time the kernel, the plain
   version and one PyTorch library call that computes the same function;
3. serve 8 requests with the port's ``BatchedServer`` on qwen1.5-0.5b at
   full width (24 layers, d_model 1024, vocab 151,936, f32, random weights
   from a seed): every decode step must go through the decode kernel;
4. check that two requests decoded in one batch at different depths give
   the logits each gives alone;
5. prefill 4 prompts of 256 tokens through the flash-attention kernel and
   check the last logits against the decode path fed the same prompts.

The last line is ``{"ok": true, "device": {...}}``; ``--out`` also writes
every number of the run to a JSON file.  The script needs a CUDA
card and the repository's ``src/`` beside it; it exits non-zero without
either.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM data sheet peaks (dense), used for each kernel's bound
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
# tests/test_kernels.py's tolerances
TOL = {"float32": dict(atol=3e-5, rtol=0.0),
       "bfloat16": dict(atol=3e-2, rtol=1e-2)}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def time_ms(torch, fn, reps: int = 7, inner: int = 10) -> float:
    """Median over ``reps`` of the mean time of ``inner`` back-to-back
    calls, by CUDA events, after warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return sorted(times)[len(times) // 2]


def gpu_name_and_power_limit() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def _within(torch, got, want, dtype) -> float:
    """Max abs error; fails beyond the dtype's tolerance."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    tol = TOL[dtype]
    bad = err > tol["atol"] + tol["rtol"] * want.abs()
    check(bool(torch.isfinite(got).all()), "non-finite kernel output")
    check(not bool(bad.any()),
          f"kernel disagrees with its plain version: max err {err.max().item()}")
    return err.max().item()


def decode_case(torch, F, dops, B, Hq, Hkv, S, hd, kv_len, dtype, gen):
    """One flash-decode check + timings.  Returns the row for the table."""
    dt = getattr(torch, dtype)
    q = torch.randn(B, Hq, hd, device="cuda", generator=gen).to(dt)
    k = torch.randn(B, Hkv, S, hd, device="cuda", generator=gen).to(dt)
    v = torch.randn(B, Hkv, S, hd, device="cuda", generator=gen).to(dt)
    lens = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    got = dops.decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    err = _within(torch, got, dops.decode_attention_ref(q, k, v, lens), dtype)

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
        ms=time_ms(torch, lambda: dops.decode_attention(q, k, v, lens)),
        plain_ms=time_ms(torch, lambda: dops.decode_attention_ref(q, k, v, lens)),
        library_ms=time_ms(torch, library),
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
    err = _within(torch, got, fops.attention_ref(q, k, v, **kw), dtype)

    q_pos = q_offset + torch.arange(Sq, device="cuda")
    k_pos = torch.arange(Sk, device="cuda")
    mask = (q_pos[:, None] >= k_pos[None, :]) if causal else None

    def library():
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
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
        ms=time_ms(torch, lambda: fops.flash_attention(q, k, v, **kw)),
        plain_ms=time_ms(torch, lambda: fops.attention_ref(q, k, v, **kw)),
        library_ms=time_ms(torch, library),
        **_bound(nbytes, flops, dtype))


def _bound(nbytes: float, flops: float, dtype: str) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def _print_row(name, row):
    print(f"  {name:17s} {row['dtype']:8s} {row['shape']:60s} "
          f"err={row['max_abs_err']:.2e} ms={row['ms']:.4f} "
          f"plain_ms={row['plain_ms']:.4f} library_ms={row['library_ms']:.4f} "
          f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']})", flush=True)


# ---------------------------------------------------------------------------
# Phases 3-5: the port's main path at full width
# ---------------------------------------------------------------------------


def reset_counts(dops, fops):
    dops.launches = fops.launches = 0
    dops.ref.calls = fops.ref.calls = 0


def phase_serve(torch, np, cfg, params, device, dops, fops, serve, slots=4,
                max_len=512, n_requests=8, max_new=32, prompt_range=(16, 257)):
    """Serve requests of seeded prompt lengths through BatchedServer; every
    decode call must launch the decode kernel once per layer."""
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
    reset_counts(dops, fops)
    steps_run = serve.run(server, queue)
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dops.launches
    check(all(r.done for r in queue), "not every request finished")
    check(all(len(r.out) == max_new for r in queue), "a request stopped early")
    check(all(0 <= t < cfg.vocab_size for r in queue for t in r.out),
          "token outside the vocabulary")
    check(launches == cfg.num_layers * decode_calls,
          f"decode kernel launched {launches} times for {decode_calls} "
          f"decode calls of {cfg.num_layers} layers")
    check(launches > 0, "decode kernel never launched")
    check(fops.launches == 0, "serving launched the prefill kernel")
    check(dops.ref.calls == 0 and fops.ref.calls == 0,
          "the plain versions ran on the card")
    toks = sum(len(r.out) for r in queue)
    print(f"prompt lengths {prompt_lens.tolist()}; served {len(queue)} "
          f"requests, {toks} tokens in {wall:.2f} s ({toks / wall:.1f} tok/s, "
          f"{steps_run} decode steps, {decode_calls} decode calls incl. "
          f"token-by-token prefill)")
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
    kernels = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or 0
        if us > 0 and e.device_type.name == "CUDA":
            kernels[e.key] = (us / n / 1e3, e.count / n)
    device_ms = sum(ms for ms, _ in kernels.values())
    launches = sum(c for _, c in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]
    if device_ms > 0:
        print(f"decode step (B={slots}): {step_ms:.2f} ms host wall, "
              f"{device_ms:.3f} ms device kernel time, {launches:.0f} device "
              f"ops/step; device idle {1 - device_ms / step_ms:.1%}")
        for name, (ms, count) in top:
            print(f"  {ms:8.4f} ms/step {count:6.0f}x  {name[:90]}")
    else:
        print(f"decode step (B={slots}): {step_ms:.2f} ms host wall; device "
              "time not measured (the profiler recorded no device kernels)")
    return dict(step_ms=step_ms, device_ms=device_ms or None,
                device_ops_per_step=launches,
                top=[(name, ms, count) for name, (ms, count) in top])


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


def phase_prefill(torch, np, cfg, params, device, dops, fops, steps, api,
                  batch=4, length=256):
    """Prefill through the flash kernel (one launch per layer); the last
    logits match the decode path fed the same prompts token by token."""
    rng = np.random.default_rng(1)
    prompts = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, size=(batch, length))).to(device)
    prefill = steps.make_prefill_step(cfg)
    reset_counts(dops, fops)
    t0 = time.perf_counter()
    last, cache = prefill(params, {"tokens": prompts})
    if device.type == "cuda":
        torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    launches = fops.launches
    check(launches == cfg.num_layers,
          f"flash kernel launched {launches} times, want {cfg.num_layers}")
    check(dops.launches == 0 and dops.ref.calls == 0 and fops.ref.calls == 0,
          "prefill ran another attention path")
    decode = steps.make_serve_step(cfg)
    st = api.allocate_decode_state(cfg, batch, length, device)
    for p in range(length):
        lg, st = decode(params, st, prompts[:, p],
                        torch.full((batch,), p, dtype=torch.int32,
                                   device=device))
    check(bool(torch.isfinite(last).all()), "non-finite prefill logits")
    err = (last[:, 0] - lg).abs().max().item()
    check(torch.allclose(last[:, 0], lg, rtol=2e-3, atol=2e-3),
          f"prefill vs decode last logits differ by {err}")
    a = cfg.attention
    kc = cache["periods"]["sub0"]["attn"]["k"]
    check(tuple(kc.shape) == (cfg.num_layers, batch, a.num_kv_heads, length,
                              a.head_dim), f"cache shape {tuple(kc.shape)}")
    print(f"prefill {prefill_s * 1e3:.1f} ms (first call); max |prefill - "
          f"decode| last logit = {err:.3e} (rtol/atol 2e-3)", flush=True)
    return dict(launches=launches, err=err, first_call_ms=prefill_s * 1e3)


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

    from repro_torch.core.config import get_arch
    from repro_torch.core.device import resolve_device
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.launch import serve, steps
    from repro_torch.models import api

    t_start = time.perf_counter()
    # ---- 1. build and device -------------------------------------------
    print("== 1. build and device", flush=True)
    device = resolve_device("cuda")        # also sets full-precision matmuls
    build_s = _build.build()
    print(f"built {_build.sources()} in {build_s:.1f} s "
          f"(nvcc {' '.join(_build.NVCC_FLAGS)})")
    for name, log in _build.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    card = gpu_name_and_power_limit()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)

    # ---- 2. kernels against plain versions ------------------------------
    print("== 2. kernels against their plain versions on the card", flush=True)
    gen = torch.Generator(device=device).manual_seed(0)
    rows = {"decode_attention": [], "flash_attention": []}
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
    for name, rs in rows.items():
        for row in rs:
            _print_row(name, row)
    # each kernel at the shape the main path gives it (f32, as served)
    main_rows = {
        "decode_attention": decode_case(torch, F, dops, 4, 16, 16, 512, 64,
                                        [17, 130, 256, 511], "float32", gen),
        "flash_attention": rows["flash_attention"][1],
    }
    _print_row("decode (main)", main_rows["decode_attention"])

    # ---- 3-5. the main path at full width -------------------------------
    cfg = dataclasses.replace(get_arch("qwen1.5-0.5b").model,
                              param_dtype="float32", compute_dtype="float32")
    params = api.init_params(torch.Generator(device=device).manual_seed(0), cfg)
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"== 3. serve {cfg.name} at full width ({cfg.num_layers} layers, "
          f"d_model {cfg.d_model}, vocab {cfg.vocab_size}, "
          f"{n_params / 1e6:.1f} M f32 params)", flush=True)
    served = phase_serve(torch, np, cfg, params, device, dops, fops, serve)
    prof = phase_profile(torch, cfg, params, device, steps, api)
    print("== 4. ragged batch equals solo decode at full width", flush=True)
    ragged_err = phase_ragged(torch, cfg, params, device, steps, api)
    print("== 5. prefill 4 x 256 tokens through flash_attention", flush=True)
    pre = phase_prefill(torch, np, cfg, params, device, dops, fops, steps, api)

    # ---- 6. summary ------------------------------------------------------
    launches = {"decode_attention": served["launches"],
                "flash_attention": pre["launches"]}
    print(f"kernels: decode_attention={launches['decode_attention']} "
          f"flash_attention={launches['flash_attention']}")
    source = {"decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                                   "src/repro/kernels/decode_attention/kernel.py:64"),
              "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                                  "src/repro/kernels/flash_attention/kernel.py:71")}
    kernels = []
    for name, row in main_rows.items():
        kernels.append({
            "name": name, "route": "cuda", "source": source[name][0],
            "replaces": source[name][1], "launches": launches[name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": row["shape"], "dtype": row["dtype"]})
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(
            {"card": card, "build_s": build_s, "cases": rows,
             "kernels": kernels, "serve": served, "profile": prof,
             "ragged_err": ragged_err, "prefill": pre,
             "total_s": time.perf_counter() - t_start}, indent=1))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    sys.exit(main())
