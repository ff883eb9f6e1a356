"""The port's dry run (``repro_torch.launch.dryrun``) and roofline harness
(``repro_torch.launch.perf``) against the reference's: the FLOPs the port
counts for a step equal the reference walker's (``analyze_compiled`` of the
jitted JAX step on one CPU device), at smoke size in f32, on fake CPU
tensors (the plain versions) and on ``meta`` (the kernels' formulas), where
the two packages differ by design only in the named ops of
``tests/_torch_dryrun_parity.py``.  Dense, GQA, MoE and MLA families here;
the recurrent ones in ``test_torch_dryrun_recurrent.py``, the VLM, the
enc-dec and DilatedVGG in ``test_torch_dryrun_stub.py``.
"""
import json
import time

import jax
import jax.numpy as jnp
import pytest

from _torch_dryrun_parity import (B, SEQ, attention_widths, check_cell,
                                  configs, f32, port_count)
from repro.core.hlo.analysis import analyze_compiled
from repro_torch.core.config import ShapeConfig, get_arch
from repro_torch.launch import dryrun, perf

CELLS = [(arch, mode) for arch in ("qwen1.5-0.5b", "minitron-8b",
                                   "granite-moe-1b-a400m", "qwen2.5-14b",
                                   "mistral-large-123b")
         for mode in ("train", "prefill", "decode")] \
    + [("deepseek-v2-236b", mode) for mode in ("train", "prefill", "decode")]


@pytest.mark.parametrize("arch,mode", CELLS)
def test_count_equals_the_walker(monkeypatch, arch, mode):
    check_cell(monkeypatch, arch, mode)


def test_qwen_prefill_counts_what_the_walker_counts():
    _, tcfg = configs("qwen1.5-0.5b")
    for device in ("cpu", "meta"):
        assert port_count(tcfg, "prefill", device=device)["flops"] \
            == 25_296_896


def test_remat_full_recomputes_as_the_walker(monkeypatch):
    """Under remat "full" each period's forward runs again in the backward,
    in both packages."""
    walker, fake, meta = check_cell(monkeypatch, "qwen1.5-0.5b", "train",
                                    remat="full")
    none = check_cell(monkeypatch, "qwen1.5-0.5b", "train")[0]
    assert walker > none


def test_mla_training_is_refused_on_meta_as_on_the_card(monkeypatch):
    """MLA training is counted on ``meta`` as the card runs it: the smoke's
    train step runs K2 and its backward once a layer at (24, 16), the
    backward noted at its seven products, 2 B Hq pairs (4 hd + 3 hd_v), and
    the meta count equals the walker's plus :func:`kernel_extra` (the
    backward's three recomputed products at their widths)."""
    _, tcfg = configs("deepseek-v2-236b")
    hd, hd_v = attention_widths(tcfg)
    assert (hd, hd_v) == (24, 16)
    _, _, meta = check_cell(monkeypatch, "deepseek-v2-236b", "train")
    a, S = tcfg.attention, SEQ["train"]
    for op in ("flash_attention", "flash_attention_bwd"):
        assert meta["by_op"][op]["count"] == tcfg.num_layers
    assert meta["by_op"]["flash_attention_bwd"]["flops"] == \
        tcfg.num_layers * 2 * B * a.num_heads * S * S * (4 * hd + 3 * hd_v)


@pytest.mark.parametrize("arch,mode", [
    (arch, mode) for arch in ("qwen1.5-0.5b", "minitron-8b",
                              "granite-moe-1b-a400m", "deepseek-v2-236b",
                              "rwkv6-1.6b", "jamba-1.5-large-398b",
                              "internvl2-2b", "seamless-m4t-large-v2")
    for mode in ("train", "prefill", "decode")])
def test_useful_flops_are_among_the_counted(arch, mode):
    """The products a step needs (``perf.useful_flops``) are among those
    its count holds, so ``roofline_fraction`` reads at most 1.  At smoke
    size the embedding table is a large share of the params, the case
    ``api.model_flops`` over-counts."""
    _, tcfg = configs(arch)
    rep = port_count(tcfg, mode, device="meta")
    useful = perf.useful_flops(tcfg, ShapeConfig("parity", SEQ[mode], B,
                                                 mode))
    assert 0 < useful <= rep["flops"]
    assert perf.roofline(rep, tcfg, useful)["roofline_fraction"] <= 1


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "rwkv6-1.6b"])
def test_prefill_roofline_fraction_at_full_size(arch):
    """The prefills of ``chip_smoke.py``'s phase 13 (4 x 256, f32, full
    size), where ``api.model_flops`` read 1.44 and 1.19 of the roofline:
    the useful work is at most the counted, and the fraction at most 1."""
    cfg = f32(get_arch(arch).model)
    shape = ShapeConfig("prefill", 256, 4, "prefill")
    rep = dryrun.count_cell(cfg, shape)
    useful = perf.useful_flops(cfg, shape)
    assert useful < perf.api.model_flops(cfg, shape)
    assert 0.9 * rep["flops"] < useful <= rep["flops"]
    assert perf.roofline(rep, cfg, useful)["roofline_fraction"] <= 1


# the reference artifact's keys that only a TPU dry run has: XLA's own cost
# and timing, and the f32 collective correction
XLA_ONLY = {"collective_bytes_f32", "collective_bytes_tpu_adjusted",
            "xla_cost_analysis_flops", "xla_bytes_accessed", "lower_seconds",
            "compile_seconds"}
# src/repro/launch/dryrun.py:107-115
REFERENCE_CELL_KEYS = {"arch", "shape", "mesh", "chips", "multi_pod",
                       "seq_parallel", "lower_seconds", "compile_seconds",
                       "model_flops", "param_count", "active_param_count"}
# src/repro/launch/perf.py:112-128
REFERENCE_PERF_KEYS = {"tag", "arch", "shape", "mesh", "remat",
                       "seq_parallel", "capacity_factor", "t_compute_ms",
                       "t_memory_ms", "t_collective_ms", "t_collective_raw_ms",
                       "bound_ms", "dominant", "useful_ratio",
                       "peak_bytes_gb", "roofline_fraction", "compile_s",
                       "collective_breakdown"}


def test_dryrun_main_writes_the_reference_artifact(tmp_path):
    """qwen1.5-0.5b's decode_32k at full size (128 rows, 32k positions,
    413 GB of cache as one device) on meta, in a few seconds."""
    walker_keys = set(analyze_compiled(jax.jit(lambda x: x @ x).lower(
        jnp.zeros((8, 8))).compile()))
    t0 = time.perf_counter()
    dryrun.main(["--arch", "qwen1.5-0.5b", "--shape", "decode_32k",
                 "--out", str(tmp_path)])
    assert time.perf_counter() - t0 < 30
    rep = json.loads((tmp_path / "qwen1.5-0.5b_decode_32k_1.json").read_text())
    want = (walker_keys | REFERENCE_CELL_KEYS) - XLA_ONLY
    assert want <= set(rep) and "trace_seconds" in rep and "by_op" in rep
    assert (rep["chips"], rep["mesh"], rep["collective_bytes"]) == (1, "1", 0)
    assert rep["trace_seconds"] < 10
    assert rep["by_op"]["decode_attention"]["count"] == 24
    assert rep["peak_bytes"] == rep["argument_bytes"] + rep["temp_bytes"]
    assert rep["argument_bytes"] > 400e9          # the cache, unallocated


def test_perf_main_appends_the_reference_fields(tmp_path, capsys):
    for tag in ("a", "b"):
        perf.main(["--arch", "qwen1.5-0.5b", "--shape", "decode_32k",
                   "--tag", tag, "--out", str(tmp_path)])
    lines = (tmp_path / "qwen1.5-0.5b_decode_32k.jsonl").read_text() \
        .splitlines()
    assert [json.loads(line)["tag"] for line in lines] == ["a", "b"]
    out = json.loads(lines[-1])
    want = REFERENCE_PERF_KEYS - {"t_collective_raw_ms", "compile_s"}
    assert want <= set(out) and "trace_s" in out
    assert out["dominant"] == "memory" and out["t_collective_ms"] == 0
    assert out["bound_ms"] == max(out["t_compute_ms"], out["t_memory_ms"])
    assert out["useful_flops"] <= out["model_flops"]
    assert 0 < out["roofline_fraction"] <= 1
    assert "top HBM contributors" in capsys.readouterr().out
