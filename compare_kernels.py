#!/usr/bin/env python3
"""Time one checkout's kernels on one NVIDIA Hopper card, so that two
checkouts (a change and its parent, unpacked by ``git archive``) can be
compared within one call, in turns.

    python3 compare_kernels.py [--root CHECKOUT] [--only scans|mla_decode]
                               [--out results.json]

``--root`` (default: this script's checkout) names the tree whose
``src/repro_torch`` is imported and whose CUDA sources are built (into its
own ``build/``).  For that tree it prints, and writes to ``--out``:

* each kernel's registers and spills, from ``nvcc -Xptxas -v``;
* the WKV scan's (K4) and the selective scan's (K3) backwards at their
  training shapes (rwkv6-1.6b: N 128, S 512, hd 64, f32 and bf16; jamba:
  Bz 2, S 512, d_inner 16384, d_state 16, bf16 and f32), held to their
  plain backwards and to autograd as ``chip_smoke.py`` holds them, with
  device ms a call and device µs a launch;
* the forwards at the serving shapes of ``chip_smoke.py``'s kernel table
  (K4 N 32, S 256; K3 Bz 1, S 256) and, under grad mode, at the training
  shapes (which also write the states their backwards start from);
* a SHA-256 digest of the outputs of K2's backward (flash attention, B 4,
  H 16, S 512, hd 64, causal, f32 and bf16) and of both scans' backwards
  on seeded inputs: equal digests mean equal bits;
* K2's backward at MLA's widths (bf16, B 2, H 128, S 512, hd 192, hd_v
  128, causal: deepseek TRAIN_CARD's step): device ms a call, µs a launch
  and its digest (or the refusal of a checkout that does not take them);
* the absorbed MLA decode (``mla_decode``, H 128, L 512, R 64) in bf16 at
  ``chip_smoke.py``'s main shape (B 4 over a 32k cache, kv_len 4096 ...
  32768), the same keys in rows of one length ([15360] x 4), the served
  step (B 4, T 128) and B 1 over a 32k cache (kv_len 21846): device ms a
  call and µs a launch, its error against the plain version, and the
  digests of its bf16 and f32 outputs (through the public op alone, so an
  older checkout's kernel is timed the same way).

``--only`` runs one of the two groups (the scans with K2's backward, or
``mla_decode``).

The card's name and power limit come first.  Exits non-zero without a
CUDA card.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

import chip_smoke as cs

SOURCES = ("rwkv6_scan", "rwkv6_scan_bwd", "ssm_scan", "ssm_scan_bwd",
           "flash_attention", "flash_attention_bwd", "mla_decode")
# mla_decode's shapes: (B, T, kv_len)
MLA_SHAPES = {"main": (4, 32768, [4096, 8192, 16384, 32768]),
              "balance": (4, 32768, [15360] * 4),
              "served": (4, 128, [97, 81, 65, 49]),
              "b1_32k": (1, 32768, [21846])}


def digest(torch, outs) -> str:
    h = hashlib.sha256()
    for t in outs:
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()[:16]


def mla_rows(torch, mops, digests) -> dict:
    """mla_decode at MLA_SHAPES in bf16 (timed) and f32 (digest only), on
    seeded inputs, through ``mla_decode`` and ``mla_decode_ref`` alone."""
    rows = {}
    for name, (B, T, kv_len) in MLA_SHAPES.items():
        for dtype in (torch.bfloat16, torch.float32):
            g = torch.Generator(device="cuda").manual_seed(7)
            args = [torch.randn(*shape, device="cuda", generator=g).to(dtype)
                    for shape in ((B, 128, 512), (B, 128, 64), (B, T, 512),
                                  (B, T, 64))]
            args += [torch.tensor(kv_len, dtype=torch.int32, device="cuda"),
                     1.0 / 192 ** 0.5]
            got = mops.mla_decode(*args)
            digests[f"mla_{name}_{str(dtype).split('.')[-1]}"] = digest(
                torch, [got])
            if dtype != torch.bfloat16:
                continue
            want = mops.mla_decode_ref(*args)
            fn = lambda: mops.mla_decode(*args)  # noqa: E731
            ms, wall = cs.time_ms(torch, fn)
            rows[f"mla_{name}"] = dict(
                ms=ms, wall_ms=wall, launch_us=cs.launch_us(torch, fn),
                max_abs_err=(got.float() - want.float()).abs().max().item())
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=cs.ROOT,
                    help="checkout whose kernels are timed")
    ap.add_argument("--only", choices=("scans", "mla_decode"),
                    help="run one group of kernels (default: both)")
    ap.add_argument("--out", type=Path, help="write every number here (JSON)")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("compare_kernels: no CUDA device; nothing was run",
              file=sys.stderr)
        return 2
    root = args.root.resolve()
    sys.path.insert(0, str(root / "src"))
    from repro_torch.core.device import resolve_device
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import bwd as bops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.mla_decode import ops as mops
    from repro_torch.kernels.rwkv6_scan import bwd as kbops
    from repro_torch.kernels.rwkv6_scan import ops as kops
    from repro_torch.kernels.ssm_scan import bwd as sbops
    from repro_torch.kernels.ssm_scan import ops as sops

    card = cs.gpu_name_and_power_limit()
    print(f"card: {card}; root {root}; torch {torch.__version__}", flush=True)
    resolve_device("cuda")
    sources = {"scans": SOURCES[:-1], "mla_decode": SOURCES[-1:]}.get(
        args.only, SOURCES)
    build_s = _build.build(sources)
    ptxas = {name: dict(cs._ptxas_summary(log))
             for name, log in _build.build_log.items()}
    for name, kernels in ptxas.items():
        for kernel, info in kernels.items():
            print(f"  {name}: {kernel}: {info}", flush=True)

    rows, digests = {}, {}
    if args.only != "mla_decode":
        scan_rows(torch, kops, kbops, sops, sbops, fops, bops, rows, digests)
    if args.only != "scans":
        rows.update(mla_rows(torch, mops, digests))
    for name, row in rows.items():
        print(f"  {name}: " + " ".join(
            f"{key}={val:.4f}" if isinstance(val, float) else f"{key}={val}"
            for key, val in row.items()), flush=True)
    print(f"  digests: {digests}", flush=True)
    result = dict(root=str(root), card=card, build_s=build_s, ptxas=ptxas,
                  rows=rows, digests=digests)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1, default=str))
    print(json.dumps(dict(root=str(root), ms={
        name: row["ms"] for name, row in rows.items()}, digests=digests)))
    return 0


def scan_rows(torch, kops, kbops, sops, sbops, fops, bops, rows,
              digests) -> None:
    """The scans' forwards and backwards and K2's backward: timings into
    ``rows``, output digests into ``digests``."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows.update({
        "k4_bwd_f32": cs.rwkv_bwd_case(torch, kops, kbops, 128, 512, 64,
                                       "float32", gen, profile=True),
        "k4_bwd_bf16": cs.rwkv_bwd_case(torch, kops, kbops, 128, 512, 64,
                                        "bfloat16", gen, profile=True),
        "k3_bwd_bf16": cs.ssm_bwd_case(torch, sops, sbops, 2, 512, 16384, 16,
                                       "bfloat16", gen, profile=True),
        "k3_bwd_f32": cs.ssm_bwd_case(torch, sops, sbops, 2, 512, 16384, 16,
                                      "float32", gen, profile=True),
        "k4_fwd": cs.rwkv_case(torch, kops, 32, 256, 64, "float32", gen,
                               profile=True),
        "k3_fwd": cs.ssm_case(torch, sops, 1, 256, 16384, 16, "bfloat16",
                              gen, h0_random=False, profile=True),
    })
    # the forwards under grad mode, at the training shapes: they also keep
    # the states the backwards start from
    g = torch.Generator(device="cuda").manual_seed(1)
    wkv = [torch.randn(128, 512, 64, device="cuda", generator=g)
           for _ in range(3)]
    wkv += [-torch.rand(128, 512, 64, device="cuda", generator=g) - 0.01,
            0.1 * torch.randn(128, 64, device="cuda", generator=g),
            0.1 * torch.randn(128, 64, 64, device="cuda", generator=g)]
    bf = torch.bfloat16
    ssm = [torch.randn(2, 512, 16384, device="cuda", generator=g).to(bf),
           torch.nn.functional.softplus(torch.randn(
               2, 512, 16384, device="cuda", generator=g) - 1),
           torch.log(torch.arange(1, 17, dtype=torch.float32,
                                  device="cuda")).repeat(16384, 1),
           torch.randn(2, 512, 16, device="cuda", generator=g).to(bf),
           torch.randn(2, 512, 16, device="cuda", generator=g).to(bf),
           torch.randn(16384, device="cuda", generator=g),
           0.1 * torch.randn(2, 16384, 16, device="cuda", generator=g)]
    for name, fn in (("k4_fwd_grad", lambda: kops.rwkv6_scan_fwd(*wkv)),
                     ("k3_fwd_grad", lambda: sops.ssm_scan_fwd(*ssm))):
        ms, wall = cs.time_ms(torch, fn)
        rows[name] = dict(ms=ms, wall_ms=wall,
                          launch_us=cs.launch_us(torch, fn))
    # bits: K2's backward and both scans' backwards on seeded inputs
    for dtype in (torch.float32, bf):
        q, k, v, do = (torch.randn(4, 16, 512, 64, device="cuda",
                                   generator=g).to(dtype) for _ in range(4))
        out, lse = fops.flash_attention_fwd(q, k, v, causal=True)
        fn = lambda: bops.flash_attention_bwd(q, k, v, out, lse, do,  # noqa
                                              causal=True)
        digests[f"k2_bwd_{dtype}"] = digest(torch, fn())
        if dtype == torch.float32:
            rows["k2_bwd_f32"] = dict(zip(("ms", "wall_ms"),
                                          cs.time_ms(torch, fn)))
    dout = torch.randn(128, 512, 64, device="cuda", generator=g)
    dstate = torch.randn(128, 64, 64, device="cuda", generator=g)
    states = kops.rwkv6_scan_fwd(*wkv)[2]
    digests["k4_bwd_f32"] = digest(torch, kbops.rwkv6_scan_bwd(
        *wkv, dout, dstate, states=states))
    dy = torch.randn(2, 512, 16384, device="cuda", generator=g)
    dh = torch.randn(2, 16384, 16, device="cuda", generator=g)
    ckpt = sops.ssm_scan_fwd(*ssm)[2]
    digests["k3_bwd_bf16"] = digest(torch, sbops.ssm_scan_bwd(
        *ssm, dy, dh, ckpt=ckpt))
    # K2's backward at MLA's widths, bf16, at deepseek TRAIN_CARD's step (B
    # 2, H 128, S 512, hd 192, hd_v 128, causal): time and bits; a checkout
    # whose backward does not take the widths records its refusal
    q, k = (torch.randn(2, 128, 512, 192, device="cuda", generator=g).to(bf)
            for _ in range(2))
    v, do = (torch.randn(2, 128, 512, 128, device="cuda", generator=g).to(bf)
             for _ in range(2))
    out, lse = fops.flash_attention_fwd(q, k, v, causal=True)
    fn = lambda: bops.flash_attention_bwd(q, k, v, out, lse, do,  # noqa
                                          causal=True)
    try:
        digests["k2_bwd_mla_bf16"] = digest(torch, fn())
    except ValueError as e:
        digests["k2_bwd_mla_bf16"] = f"refused: {e}"
    else:
        ms, wall = cs.time_ms(torch, fn)
        rows["k2_bwd_mla_bf16"] = dict(ms=ms, wall_ms=wall,
                                       launch_us=cs.launch_us(torch, fn))


if __name__ == "__main__":
    sys.exit(main())
