"""The sharded dry run on virtual meshes (``launch.mesh.virtual_group``):
per-device FLOPs are the one-chip count over the ranks and the reference
walker's per-device FLOPs of the same sharded step; collective bytes by
kind are the walker's, or differ from them as stated; one layer's
collective bytes are a closed form; the production meshes' decode state
fits the card only with the cache sharded along its keys.  Smoke sizes
in f32 on ``meta`` (the kernels' formulas), as ``test_torch_dryrun.py``
counts one chip."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch.distributed.device_mesh import init_device_mesh

from _torch_dryrun_parity import SCAN_KERNELS, attention_widths
from _torch_mesh_walker import B, SEQ
from repro_torch import sharding as sh
from repro_torch.core.config import LM_SHAPES, ShapeConfig, get_arch
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import perf
from repro_torch.models import api

HERE = Path(__file__).resolve().parent
MESHES = [(2, 2), (1, 4)]
MODES = ("train", "prefill", "decode")
GRANITE = "granite-moe-1b-a400m"
JAMBA = "jamba-1.5-large-398b"
RWKV = "rwkv6-1.6b"


def smoke(arch, dtype="float32", **kw):
    return dataclasses.replace(get_arch(arch).smoke, param_dtype=dtype,
                               compute_dtype=dtype, **kw)


def count(cfg, mode, dims=None, seq_parallel=None):
    """The port's meta count of one smoke step: one chip, or rank 0 of a
    virtual ("data", "model") mesh of ``dims``."""
    shape = ShapeConfig("parity", SEQ[mode], B, mode)
    if dims is None:
        return dryrun.count_cell(cfg, shape, remat="none")
    sp = mode == "decode" if seq_parallel is None else seq_parallel
    with mesh_lib.virtual_group(dims[0] * dims[1]):
        mesh = init_device_mesh("cpu", dims, mesh_dim_names=("data", "model"))
        return dryrun.count_cell(cfg, shape, remat="none", mesh=mesh,
                                 seq_parallel=sp)


def bwd_extra(rep, cfg) -> int:
    """K2's backward's three recomputed products (its formula counts seven,
    autograd over the reference's attention four): 3/7 of its FLOPs at
    hd = hd_v, as ``_torch_dryrun_parity.kernel_extra``."""
    bwd = rep["by_op"].get("flash_attention_bwd", {}).get("flops", 0)
    hd, hd_v = attention_widths(cfg)
    return bwd * (2 * hd + hd_v) // (4 * hd + 3 * hd_v)


@pytest.fixture(scope="module")
def walker():
    """The reference walker's counts of qwen1.5-0.5b's, granite-moe's,
    jamba's and rwkv6's smokes on both meshes, from one subprocess with four
    CPU devices (jamba's selective scan and rwkv6's WKV scan stood in for,
    as on one chip)."""
    cells = [f"{a}:{m}:{d[0]}x{d[1]}" for a in ("qwen1.5-0.5b", GRANITE,
                                                JAMBA, RWKV)
             for m in MODES for d in MESHES]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(HERE.parent / "src"), os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run([sys.executable, str(HERE / "_torch_mesh_walker.py")]
                         + cells, env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("dims", MESHES, ids=lambda d: f"{d[0]}x{d[1]}")
@pytest.mark.parametrize("mode", MODES)
def test_per_device_flops_are_the_chips_share_and_the_walkers(walker, mode,
                                                              dims):
    """Every product and kernel splits evenly over the 4 ranks (batch over
    "data", heads, d_ff and vocab over "model"), so a rank counts a quarter
    of the chip's FLOPs, with no exception; and what the walker counts for
    the reference's sharded step, less K2 backward's recomputed products
    (as on one chip).  Decode with the cache on its keys or on heads alike."""
    cfg = smoke("qwen1.5-0.5b")
    one = count(cfg, mode)["flops"]
    rep = count(cfg, mode, dims)
    assert rep["flops"] * 4 == one
    assert rep["flops"] - bwd_extra(rep, cfg) == \
        walker[f"qwen1.5-0.5b:{mode}:{dims[0]}x{dims[1]}"]["flops"]
    assert rep["collective_bytes"] > 0
    if mode == "decode":
        assert count(cfg, mode, dims, seq_parallel=False)["flops"] \
            == rep["flops"]


@pytest.mark.parametrize("dims", MESHES, ids=lambda d: f"{d[0]}x{d[1]}")
@pytest.mark.parametrize("mode", MODES)
def test_collective_bytes_against_the_walkers(walker, mode, dims):
    """The port's collective operand bytes by kind against the walker's
    for the same sharded step.  A reduce-scatter moves the operand an
    all-reduce would (DTensor scatters a pending sum that is laid out
    sharded next; GSPMD all-reduces it and slices), so the two count as
    one kind here.  Prefill and decode are equal but for the embedding
    lookup on a mesh with a "data" axis: the port gathers the table's FSDP
    shard and looks up its own rows; GSPMD instead gathers the tokens
    (a collective-permute and an all-gather), looks up every row in its
    (vocab, embed) block and permutes the rows back.  Training moves less
    in the port, of each kind: autograd keeps the gathered weights and
    block inputs that GSPMD gathers again in the backward, and the port
    sums the q/k/v (up/gate) input gradients before one reduce-scatter
    where GSPMD all-reduces each (PERF.md lists the differences)."""
    cfg = smoke("qwen1.5-0.5b")
    got = count(cfg, mode, dims)["collective_breakdown"]
    want = walker[f"qwen1.5-0.5b:{mode}:{dims[0]}x{dims[1]}"][
        "collective_breakdown"]
    gathers = got.get("all-gather", 0)
    reduces = got.get("all-reduce", 0) + got.get("reduce-scatter", 0)
    assert "all-to-all" not in got
    if mode == "train":
        assert gathers < want["all-gather"]
        assert reduces < want["all-reduce"]
        return
    d, m = dims
    rows = B // d * (1 if mode == "decode" else SEQ[mode])
    table = tokens = block = 0
    if d > 1:
        table = cfg.vocab_size // m * cfg.d_model // d * 4
        tokens = rows * 4
        block = rows * cfg.d_model // m * 4
    assert reduces == want["all-reduce"]
    assert gathers == want["all-gather"] + table - tokens
    assert want.get("collective-permute", 0) == tokens + block
    assert want.get("all-to-all", 0) == 0


@pytest.mark.parametrize("mode", MODES)
def test_minitron_flops_split_over_a_kv_replicated_mesh(mode):
    """minitron's smoke has 2 KV heads for 4 query heads: on (1, 4) each
    rank runs its one query head against the KV head it reads (the cache
    and K, V replicated over "model"), still a quarter of the chip."""
    cfg = smoke("minitron-8b")
    assert count(cfg, mode, (1, 4))["flops"] * 4 == count(cfg, mode)["flops"]


def _layer(cfg, mode="prefill", dims=(2, 2)):
    """Collective bytes by kind of one layer: two layers' less one's."""
    one = count(dataclasses.replace(cfg, num_layers=1), mode, dims)
    two = count(dataclasses.replace(cfg, num_layers=2), mode, dims)
    kinds = set(one["collective_breakdown"]) | set(two["collective_breakdown"])
    diff = {k: two["collective_breakdown"].get(k, 0)
            - one["collective_breakdown"].get(k, 0) for k in kinds}
    return {k: v for k, v in diff.items() if v}


def _closed_form(cfg, out_bytes):
    """One qwen smoke layer's collectives on (2, 2) in prefill: each weight
    matrix's FSDP shard gathered over "data" (a quarter of it, in the
    compute dtype), the attention's and the FFN's input gathered over
    "model" (half of a rank's rows), the row-parallel outputs of wo and
    w_down all-reduced over "model" (a rank's rows, ``out_bytes`` an
    element), and each norm's sum of squares all-reduced (f32)."""
    e = torch.empty((), dtype=getattr(torch, cfg.compute_dtype)).element_size()
    a, d, f = cfg.attention, cfg.d_model, cfg.d_ff
    rows = B // 2 * SEQ["prefill"]
    weights = (4 * d * a.num_heads * a.head_dim + 3 * d * f) // 4
    gather = weights * e + 2 * rows * d // 2 * e
    reduce = 2 * rows * d * out_bytes + 2 * rows * 4
    return {"all-gather": gather, "all-reduce": reduce}


def test_one_layer_collectives_are_the_closed_form(monkeypatch):
    cfg = smoke("qwen1.5-0.5b")
    assert _layer(cfg) == _closed_form(cfg, 4)
    bf16 = smoke("qwen1.5-0.5b", "bfloat16")
    on = _layer(bf16)
    assert on == _closed_form(bf16, 2)
    monkeypatch.setenv("REPRO_BF16_AR", "0")
    off = _layer(bf16)
    assert off == _closed_form(bf16, 4)
    # the row-parallel all-reduce halves in bf16; nothing else moves
    rows = B // 2 * SEQ["prefill"]
    assert off["all-reduce"] - on["all-reduce"] == 2 * rows * bf16.d_model * 2
    assert off["all-gather"] == on["all-gather"]


def test_decode_cells_count_collectives_at_full_width():
    """qwen1.5-0.5b decode_32k on (16, 16) at full width (a cut of 2
    layers): the cache sharded on its keys, K1 once a layer over a
    rank's 2,048 keys for all 16 heads, its (out, lse) all-gathered."""
    cfg = dataclasses.replace(get_arch("qwen1.5-0.5b").model, num_layers=2)
    rep = dryrun.count_on_mesh(cfg, LM_SHAPES["decode_32k"], multi_pod=False)
    assert rep["seq_parallel"] and rep["mesh"] == "16x16"
    k1 = rep["by_op"]["decode_attention"]
    a = cfg.attention
    rows, keys = 128 // 16, 32768 // 16
    assert k1["count"] == 2
    assert k1["flops"] == 2 * 4 * a.num_heads * a.head_dim * rows * keys
    assert rep["collective_breakdown"]["all-gather"] > 0


def test_mistral_decode_fits_the_card_only_with_the_cache_on_keys():
    """mistral-large-123b decode_32k on (16, 16): params and state per
    device from ``shardings_for`` (no trace) fit 80 GB with the KV cache
    sharded along its keys, and do not without."""
    cfg, shape = get_arch("mistral-large-123b").model, LM_SHAPES["decode_32k"]
    params, ins = api.param_shapes(cfg), api.input_specs(cfg, shape)
    with mesh_lib.virtual_group(256):
        mesh = mesh_lib.make_production_mesh()
        per_device = {}
        for sp in (True, False):
            specs = mesh_lib.shardings_for(cfg, shape, mesh, params, None,
                                           ins, seq_parallel=sp)
            per_device[sp] = sh.local_bytes(params, specs["params"], mesh) \
                + sh.local_bytes(ins["state"], specs["state"], mesh)
    assert per_device[True] < 80e9 < per_device[False]
    # the cache alone: 88 x 2 x 8 heads x 128 x 32768 x 8 rows x 2 bytes
    cache = 88 * 2 * 8 * 128 * 32768 * 8 * 2
    assert per_device[False] - per_device[True] == cache - cache // 16


def test_non_dense_families_are_not_ported_under_a_mesh():
    """The families the mesh does not run yet: deepseek-v2 (family "moe")
    is refused by its MLA attention, seamless (family "audio") by its
    family."""
    with pytest.raises(NotImplementedError, match="item 14b"):
        count(smoke("deepseek-v2-236b"), "prefill", (2, 2))
    with pytest.raises(NotImplementedError, match="item 14b"):
        dryrun.count_on_mesh(get_arch("seamless-m4t-large-v2").model,
                             LM_SHAPES["decode_32k"], multi_pod=True)


def test_sequence_parallel_training_is_refused():
    with pytest.raises(NotImplementedError, match="item 14b"):
        count(smoke("qwen1.5-0.5b"), "train", (2, 2), seq_parallel=True)


# ---------------------------------------------------------------------------
# The MoE family: granite-moe-1b-a400m, its experts on "model"
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dims", MESHES, ids=lambda d: f"{d[0]}x{d[1]}")
@pytest.mark.parametrize("mode", MODES)
def test_granite_per_device_flops_are_the_chips_share_and_the_walkers(
        walker, mode, dims):
    """granite's smoke (4 experts, top-2) with its experts on "model": each
    rank routes its own batch rows and runs its E/m experts (the dispatch
    product, the three expert ``bmm``s and the combine over E/m), and the
    router's product is split over "model" as x's d_model is: a quarter
    of the chip's FLOPs, and the walker's less K2 backward's recomputed
    products."""
    cfg = smoke(GRANITE)
    one = count(cfg, mode)["flops"]
    rep = count(cfg, mode, dims)
    assert rep["flops"] * 4 == one
    assert rep["flops"] - bwd_extra(rep, cfg) == \
        walker[f"{GRANITE}:{mode}:{dims[0]}x{dims[1]}"]["flops"]


@pytest.mark.parametrize("dims", MESHES, ids=lambda d: f"{d[0]}x{d[1]}")
@pytest.mark.parametrize("mode", MODES)
def test_granite_collective_bytes_against_the_walkers(walker, mode, dims):
    """granite's collective operand bytes by kind against the walker's.
    The MoE layer moves what GSPMD's moves: the router's logits
    all-reduced over "model" (rows E f32), x all-gathered over "model"
    before the dispatch, the experts' FSDP shards all-gathered over
    "data", and the combined output all-reduced over "model" (rows D).
    Prefill and decode differ only as follows (a reduce-scatter counts as
    an all-reduce, as for the dense family):

    * the embedding lookup on a "data" axis, as the dense family's;
    * the router's top-k: GSPMD all-gathers the (G, S, E) probabilities
      over "data" before its top_k (rows E f32 a layer); the port routes
      each rank's own rows;
    * on (1, 4) granite's 2 KV heads of 16 put half a head's K on each
      rank, and GSPMD trades the rope's halves between ranks (two
      collective-permutes of rows hd/4 f32 a layer, and all-to-alls of
      twice their bytes); the port gathers K's heads and rotates them on
      each rank;
    * decode on (1, 4) lays the cache on its keys: GSPMD all-reduces the
      softmax's max and sum (B Hq f32 each) and its P.V product twice
      (B Hq hd f32 each) a layer, where the port all-gathers K1's (out,
      lse); it gathers B Hq f32 a layer more than GSPMD, its q, new K and
      V rows and (out, lse) against GSPMD's q and written cache rows.

    No all-to-all of the walker's sits at the experts: besides the rope's,
    the one of training on (2, 2) is the embedding gradient's
    scatter-add.  Training moves less in the port, of each kind, as the
    dense family's, and no collective-permute or all-to-all."""
    cfg = smoke(GRANITE)
    got = count(cfg, mode, dims)["collective_breakdown"]
    want = walker[f"{GRANITE}:{mode}:{dims[0]}x{dims[1]}"][
        "collective_breakdown"]
    gathers = got.get("all-gather", 0)
    reduces = got.get("all-reduce", 0) + got.get("reduce-scatter", 0)
    assert set(got) <= {"all-gather", "all-reduce", "reduce-scatter"}
    if mode == "train":
        assert gathers < want["all-gather"]
        assert reduces < want["all-reduce"]
        return
    d, m = dims
    a, L, E = cfg.attention, cfg.num_layers, cfg.moe.num_experts
    rows = B // d * (1 if mode == "decode" else SEQ[mode])
    table = tokens = block = topk = rope = keys = lse = 0
    if d > 1:
        table = cfg.vocab_size // m * cfg.d_model // d * 4
        tokens = rows * 4
        block = rows * cfg.d_model // m * 4
        topk = L * rows * E * 4
    if a.num_kv_heads % m:
        rope = L * 2 * rows * a.head_dim // 4 * 4
        if mode == "decode":
            keys = L * 2 * rows * a.num_heads * (1 + a.head_dim) * 4
            lse = L * rows * a.num_heads * 4
    assert reduces == want["all-reduce"] - keys
    assert gathers == want["all-gather"] + table - tokens - topk + lse
    assert want.get("collective-permute", 0) == tokens + block + rope
    assert want.get("all-to-all", 0) == 2 * rope


def test_granite_ranks_hold_their_experts_at_full_size():
    """granite-moe-1b-a400m on (16, 16), its params laid out by
    ``shardings_for`` (no trace): each rank holds 2 of the 32 experts'
    banks ("model"), a sixteenth of each one's d_model rows ("data"), and
    the whole f32 router."""
    cfg = get_arch(GRANITE).model
    params = api.param_shapes(cfg)
    shape = LM_SHAPES["train_4k"]
    moe = params["stack"]["periods"]["sub0"]["ffn_moe"]
    with mesh_lib.virtual_group(256):
        mesh = mesh_lib.make_production_mesh()
        specs = mesh_lib.shardings_for(cfg, shape, mesh, params)["params"]
        spec = specs["stack"]["periods"]["sub0"]["ffn_moe"]
        held = {k: sh.local_bytes(moe[k], spec[k], mesh)
                for k in ("w_up", "w_gate", "w_down", "router")}
        local, off = sh.local_extent(moe["w_up"].shape, sh.placements(
            spec["w_up"], mesh), mesh, coord=(3, 5))
    L, E, d, f = cfg.num_layers, 32, cfg.d_model, cfg.moe.d_ff_expert
    assert (L, d, f) == (24, 1024, 512) and cfg.moe.num_experts == E
    assert spec["w_up"] == spec["w_gate"] == (None, "model", "data", None)
    assert spec["w_down"] == (None, "model", None, "data")
    for k in ("w_up", "w_gate", "w_down"):
        assert held[k] == L * (E // 16) * (d // 16) * f * 2
    assert held["router"] == L * d * E * 4
    # rank (3, 5): experts 10 and 11, rows 192-255
    assert local == (L, 2, 64, f) and off == (0, 10, 192, 0)


def test_first_k_dense_prefix_splits_over_the_mesh():
    """A dense prefix block in front of the MoE stack (``first_k_dense``,
    deepseek-v2's layout) runs under a mesh as the dense family's blocks
    do: still a quarter of the chip.  ``test_torch_mesh_numerics.py``
    holds its numbers to the reference's."""
    cfg = smoke(GRANITE)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, first_k_dense=1))
    for mode in MODES:
        assert count(cfg, mode, (2, 2))["flops"] * 4 == \
            count(cfg, mode)["flops"]


def test_perf_capacity_factor_sets_the_capacity(tmp_path):
    """``perf --capacity-factor`` replaces the config's factor, as the
    reference's harness does: granite's decode_32k (128 rows, 8 of 32
    experts a token) at the default 1.25 gives each expert C = 4 slots,
    dropless (-1) C = 8, and the extra slots cost their products, the
    combine (2 G E dC D) and the three expert products (2 E G dC D F
    each), a layer.  (The dispatch contracts over one token a row, an
    elementwise product in both packages, which counts no FLOPs.)"""
    args = ["--arch", GRANITE, "--shape", "decode_32k", "--out",
            str(tmp_path)]
    perf.main(args)
    perf.main(args + ["--capacity-factor", "-1"])
    lines = (tmp_path / f"{GRANITE}_decode_32k.jsonl").read_text()
    default, dropless = (json.loads(line) for line in lines.splitlines())
    assert (default["capacity_factor"], dropless["capacity_factor"]) == \
        (1.25, -1.0)
    cfg = get_arch(GRANITE).model
    G, E, D, F = 128, 32, cfg.d_model, cfg.moe.d_ff_expert
    dC = 8 - 4
    per_layer = 2 * G * E * dC * D + 3 * (2 * E * G * dC * D * F)
    assert dropless["flops"] - default["flops"] == cfg.num_layers * per_layer


# ---------------------------------------------------------------------------
# The hybrid family: jamba, its Mamba mixers' channels on "model"
# ---------------------------------------------------------------------------

# the f32 columns a row that GSPMD moves by collective-permute a Mamba layer
# of jamba's smoke (2 d_inner = 256, dt_rank + 2 d_state = 20): the u/z
# split's (xz's local columns that belong to other ranks' u or z: 128 on
# (2, 2), 160 on (1, 4)) and the dt_in/B/C split's of x_proj's output (10
# and 12), read from its compiled program
GSPMD_PERMUTE_COLUMNS = {(2, 2): 128 + 10, (1, 4): 160 + 12}


def _mamba_layers(cfg) -> int:
    return cfg.layer_kinds().count("ssm")


def _rows(mode, d) -> int:
    return B // d * (1 if mode == "decode" else SEQ[mode])


@pytest.mark.parametrize("dims", MESHES, ids=lambda d: f"{d[0]}x{d[1]}")
@pytest.mark.parametrize("mode", MODES)
def test_jamba_per_device_flops_are_the_chips_share_and_the_walkers(
        walker, mode, dims):
    """jamba's smoke with its Mamba mixers' d_inner channels on "model"
    (in_proj column-parallel, x_proj, dt_proj and out_proj row-parallel,
    K3 and its backward on each rank's rows and channels), its MoE's
    experts and its attention's heads on "model": a quarter of the chip's
    FLOPs.  Against the walker's (the selective scan stood in for in the
    reference): less K3's (and its backward's) formula and K2 backward's
    recomputed products, and less dt_proj's forward where GSPMD gives a
    rank one of its dt_rank rows (dt_rank 4 on (1, 4)): XLA turns a
    product that contracts one element into a multiply, which the walker
    does not count (2 rows d_inner a Mamba layer, the port's product on a
    rank's d_inner / m columns of all dt_rank rows)."""
    cfg = smoke(JAMBA)
    one = count(cfg, mode)["flops"]
    rep = count(cfg, mode, dims)
    assert rep["flops"] * 4 == one
    d, m = dims
    di = cfg.ssm.expand * cfg.d_model
    scans = sum(rep["by_op"].get(k, {}).get("flops", 0)
                for k in SCAN_KERNELS)
    assert scans > 0
    one_row = cfg.ssm.resolved_dt_rank(cfg.d_model) // m == 1
    dt_fwd = _mamba_layers(cfg) * 2 * _rows(mode, d) * di if one_row else 0
    assert rep["flops"] - scans - bwd_extra(rep, cfg) - dt_fwd == \
        walker[f"{JAMBA}:{mode}:{dims[0]}x{dims[1]}"]["flops"]


@pytest.mark.parametrize("dims", MESHES, ids=lambda d: f"{d[0]}x{d[1]}")
@pytest.mark.parametrize("mode", MODES)
def test_jamba_collective_bytes_against_the_walkers(walker, mode, dims):
    """jamba's collective operand bytes by kind against the walker's.  Its
    attention and MoE layers differ as granite's do (the embedding lookup
    and the router's top-k on a "data" axis; on (1, 4) the rope's halves
    and decode over the keys).  Each Mamba layer (a reduce-scatter counted
    as an all-reduce) differs as follows, rows being a rank's (batch rows
    x positions), all f32:

    * the u/z split: the port's one all-to-all of a rank's xz (rows x
      2 d_inner / m); GSPMD's collective-permutes of the columns that
      belong to other ranks (``GSPMD_PERMUTE_COLUMNS``);
    * x_proj: the port lays the weight out by its d_inner rows (an
      all-gather of its (d_inner, 20 / m) shard on a CPU mesh, an
      all-to-all under NCCL) and all-reduces the (rows, 20) sum; GSPMD
      all-gathers u_act (rows x d_inner / m) and permutes the dt_in/B/C
      split of its output (in the permute columns);
    * dt_proj: the port lays the weight out by its d_inner columns (its
      (dt_rank / m, d_inner) shard, gathered as x_proj's) and reads the
      whole dt_in that x_proj's sum left on every rank: no activation
      moves; GSPMD runs it row-parallel over dt_rank and all-reduces
      (rows x d_inner);
    * the walker's scan stand-in sums B C over d_state, B and C lying on
      "model" there: one all-reduce of rows f32 more; the port's B and C
      are replicated over "model" (x_proj's all-reduce).

    Training moves less of each kind in the port but all-to-all (the
    split's, forward and backward, against the walker's permutes)."""
    cfg = smoke(JAMBA)
    got = count(cfg, mode, dims)["collective_breakdown"]
    want = walker[f"{JAMBA}:{mode}:{dims[0]}x{dims[1]}"][
        "collective_breakdown"]
    gathers = got.get("all-gather", 0)
    reduces = got.get("all-reduce", 0) + got.get("reduce-scatter", 0)
    assert set(got) <= {"all-gather", "all-reduce", "reduce-scatter",
                        "all-to-all"}
    d, m = dims
    a, E = cfg.attention, cfg.moe.num_experts
    n, di = _mamba_layers(cfg), cfg.ssm.expand * cfg.d_model
    n_out = cfg.ssm.resolved_dt_rank(cfg.d_model) + 2 * cfg.ssm.d_state
    L_moe, L_attn = cfg.ffn_kinds().count("moe"), cfg.layer_kinds().count(
        "attn")
    rows = _rows(mode, d)
    split = n * rows * 2 * di // m * 4
    if mode == "train":
        assert got["all-to-all"] == 2 * split
        assert gathers < want["all-gather"]
        assert reduces < want["all-reduce"]
        return
    assert got["all-to-all"] == split
    table = tokens = block = topk = rope = keys = lse = 0
    if d > 1:
        table = cfg.vocab_size // m * cfg.d_model // d * 4
        tokens = rows * 4
        block = rows * cfg.d_model // m * 4
        topk = L_moe * rows * E * 4
    if a.num_kv_heads % m:
        rope = L_attn * 2 * rows * a.head_dim // 4 * 4
        if mode == "decode":
            keys = L_attn * 2 * rows * a.num_heads * (1 + a.head_dim) * 4
            lse = L_attn * rows * a.num_heads * 4
    dtr = cfg.ssm.resolved_dt_rank(cfg.d_model)
    weights = di * n_out // m * 4 + dtr // m * di * 4
    u_act = rows * di // m * 4
    x_sum, dt_sum, bc = rows * n_out * 4, rows * di * 4, rows * 4
    assert reduces == want["all-reduce"] - keys \
        + n * (x_sum - dt_sum - bc)
    assert gathers == want["all-gather"] + table - tokens - topk + lse \
        + n * (weights - u_act)
    assert want["collective-permute"] == tokens + block + rope \
        + n * rows * 4 * GSPMD_PERMUTE_COLUMNS[dims]
    assert want.get("all-to-all", 0) == 2 * rope


def test_jamba_long_500k_fits_the_card_with_the_cache_on_keys():
    """jamba-1.5-large-398b long_500k (one row, 524,288 positions) on
    (16, 16) at full width and depth: its params and decode state per
    device (``shardings_for``, no trace) fit 80 GB, the 9 attention
    layers' cache (8 KV heads, which do not divide 16) on its keys a
    sixteenth of what it is replicated; the Mamba state lies on "mlp".
    The traced cell runs K1 once an attention layer over a rank's 32,768
    keys, K3 once a Mamba layer on a rank's 1,024 channels, the u/z
    split's all-to-all once a Mamba layer, and peaks within the card."""
    cfg, shape = get_arch(JAMBA).model, LM_SHAPES["long_500k"]
    params, ins = api.param_shapes(cfg), api.input_specs(cfg, shape)
    with mesh_lib.virtual_group(256):
        mesh = mesh_lib.make_production_mesh()
        per_device = {}
        for sp in (True, False):
            specs = mesh_lib.shardings_for(cfg, shape, mesh, params, None,
                                           ins, seq_parallel=sp)
            per_device[sp] = sh.local_bytes(params, specs["params"], mesh) \
                + sh.local_bytes(ins["state"], specs["state"], mesh)
        state = specs["state"]["periods"]
    assert state["sub4"]["attn"]["k"] == (None, None, None, None, None)
    assert state["sub0"]["ssm"]["state"] == (None, None, "model", None)
    a, S = cfg.attention, shape.seq_len
    n_attn, n_mamba = cfg.layer_kinds().count("attn"), \
        cfg.layer_kinds().count("ssm")
    cache = n_attn * 2 * a.num_kv_heads * S * a.head_dim * 2
    assert per_device[True] < 80e9
    assert per_device[False] - per_device[True] == cache - cache // 16
    rep = dryrun.count_on_mesh(cfg, shape, multi_pod=False)
    assert rep["seq_parallel"] and rep["peak_bytes"] < 80e9
    k1, k3 = rep["by_op"]["decode_attention"], rep["by_op"]["ssm_scan"]
    di = cfg.ssm.expand * cfg.d_model
    assert (k1["count"], k3["count"]) == (n_attn, n_mamba)
    assert k1["flops"] == n_attn * 4 * a.num_heads * a.head_dim * S // 16
    assert k3["flops"] == n_mamba * 4 * di // 16 * cfg.ssm.d_state
    assert rep["collective_breakdown"]["all-to-all"] == \
        n_mamba * 2 * di // 16 * 2


# ---------------------------------------------------------------------------
# The RWKV-6 family: rwkv6-1.6b, its heads on "model"
# ---------------------------------------------------------------------------


def _norms(cfg) -> int:
    """The LayerNorms a step runs: three a layer (the block's two and the
    time mix's ``ln_x``) and the final one."""
    return 3 * cfg.num_layers + 1


@pytest.mark.parametrize("dims", MESHES, ids=lambda d: f"{d[0]}x{d[1]}")
@pytest.mark.parametrize("mode", MODES)
def test_rwkv_per_device_flops_are_the_chips_share_and_the_walkers(
        walker, mode, dims):
    """rwkv6's smoke with its heads on "model": the four column-parallel
    time-mix products and ``wo`` row-parallel, K4 (a decode step's closed
    form) on each rank's rows and heads, the lora products on the rank's
    slice of d_model (down products over its rows, up products onto its
    columns), the channel mix as a dense FFN: a quarter of the chip's
    FLOPs, and the walker's (the WKV scan stood in for in the reference)
    less K4's and its backward's formulas, with no other difference."""
    cfg = smoke(RWKV)
    one = count(cfg, mode)["flops"]
    rep = count(cfg, mode, dims)
    assert rep["flops"] * 4 == one
    scans = sum(rep["by_op"].get(k, {}).get("flops", 0)
                for k in SCAN_KERNELS)
    assert (scans > 0) == (mode != "decode")
    assert rep["flops"] - scans == \
        walker[f"{RWKV}:{mode}:{dims[0]}x{dims[1]}"]["flops"]


@pytest.mark.parametrize("dims", MESHES, ids=lambda d: f"{d[0]}x{d[1]}")
@pytest.mark.parametrize("mode", MODES)
def test_rwkv_collective_bytes_against_the_walkers(walker, mode, dims):
    """rwkv6's collective operand bytes by kind against the walker's (a
    reduce-scatter counted as an all-reduce).  Prefill and decode move what
    GSPMD's program moves but for two things, rows being a rank's (batch
    rows x positions), all f32:

    * each LayerNorm over a d_model on "model": the port all-reduces its
      sum and then its sum of squares about the mean (2 x rows); GSPMD
      all-reduces the sum, then the sum of squares and the sum again in
      one tuple (3 x rows), ``_norms`` of them a step;
    * on a mesh with a "data" axis the embedding lookup, as qwen's: the
      port gathers the table's FSDP shard, GSPMD the tokens, and permutes
      the looked-up rows back.

    The time mix's products match GSPMD's collective for collective: the
    lora down products all-reduce (rows, 40) and (rows, 8), the up products
    move nothing, r, k, v and g each gather their stream (rows, d_model /
    m), ``wo`` and the channel mix's ``w_down`` all-reduce (rows,
    d_model), K4 and the decode step move nothing.  Training moves less in
    the port in all and gathers at most 0.7 of GSPMD's bytes; its
    reductions are 1% fewer than GSPMD's on (1, 4) and 3.8% more on (2, 2)
    (held within 4%), where DTensor gathers each replicated param's
    gradient slices over "model" before it all-reduces the whole over
    "data"."""
    cfg = smoke(RWKV)
    got = count(cfg, mode, dims)["collective_breakdown"]
    want = walker[f"{RWKV}:{mode}:{dims[0]}x{dims[1]}"][
        "collective_breakdown"]
    gathers = got.get("all-gather", 0)
    reduces = got.get("all-reduce", 0) + got.get("reduce-scatter", 0)
    assert set(got) <= {"all-gather", "all-reduce", "reduce-scatter"}
    d, m = dims
    if mode == "train":
        # the port's gathers are 0.68 (2, 2) and 0.67 (1, 4) of GSPMD's;
        # its reductions 1.038 and 0.990 of them
        assert gathers <= 0.7 * want["all-gather"]
        assert sum(got.values()) < sum(want.values())
        ratio = reduces / want["all-reduce"]
        assert (1 < ratio <= 1.04) if d > 1 else (0.99 <= ratio < 1)
        return
    rows = _rows(mode, d)
    table = tokens = block = 0
    if d > 1:
        table = cfg.vocab_size // m * cfg.d_model // d * 4
        tokens = rows * 4
        block = rows * cfg.d_model // m * 4
    assert reduces == want["all-reduce"] - _norms(cfg) * rows * 4
    assert gathers == want["all-gather"] + table - tokens
    assert want.get("collective-permute", 0) == tokens + block
    assert "all-to-all" not in want


def test_rwkv_sequence_parallel_train_and_prefill_are_refused():
    for mode in ("train", "prefill"):
        with pytest.raises(NotImplementedError, match="item 14b"):
            count(smoke(RWKV), mode, (1, 4), seq_parallel=True)


def test_rwkv_long_500k_fits_the_card_with_the_state_on_heads():
    """rwkv6-1.6b long_500k (one row, 524,288 positions) on (16, 16) at
    full width and depth: its state is O(1) in the context, each layer's
    ``wkv`` (32 heads of 64 x 64) on its heads, 2 a rank, and ``shift_t``
    / ``shift_c`` on d_model; the batch of one row is replicated over
    "data".  Params and state per device (``shardings_for``, no trace) fit
    80 GB with the state a sixteenth of its whole.  The traced decode step
    launches no K4 (the closed form), its one product a layer on a rank's
    heads, and peaks within the card."""
    cfg, shape = get_arch(RWKV).model, LM_SHAPES["long_500k"]
    params, ins = api.param_shapes(cfg), api.input_specs(cfg, shape)
    with mesh_lib.virtual_group(256):
        mesh = mesh_lib.make_production_mesh()
        specs = mesh_lib.shardings_for(cfg, shape, mesh, params, None, ins,
                                       seq_parallel=True)
        per_param = sh.local_bytes(params, specs["params"], mesh)
        per_state = sh.local_bytes(ins["state"], specs["state"], mesh)
        state = specs["state"]["periods"]["sub0"]["rwkv_tm"]
    assert state["wkv"] == (None, None, "model", None, None)
    assert state["shift_t"] == state["shift_c"] == (None, None, "model")
    L, D, hd = cfg.num_layers, cfg.d_model, cfg.rwkv.head_dim
    H = D // hd
    whole = L * (H * hd * hd + 2 * D) * 4
    assert per_state * 16 == whole
    assert per_param + per_state < 80e9
    rep = dryrun.count_on_mesh(cfg, shape, multi_pod=False)
    assert rep["seq_parallel"] and rep["peak_bytes"] < 80e9
    assert not any(k in rep["by_op"] for k in SCAN_KERNELS)
    assert rep["by_op"]["aten.bmm"]["flops"] == L * 2 * (H // 16) * hd * hd
    assert rep["collective_bytes"] > 0

if __name__ == "__main__":
    # the smoke cells' collective bytes by kind, the port's and the
    # walker's:  PYTHONPATH=src python tests/test_torch_mesh_dryrun.py
    ref = walker.__wrapped__()
    for arch in ("qwen1.5-0.5b", GRANITE, JAMBA, RWKV):
        for mode in MODES:
            for dims in MESHES:
                cell = f"{arch}:{mode}:{dims[0]}x{dims[1]}"
                got = count(smoke(arch), mode, dims)
                print(cell, "port", got["collective_breakdown"], "walker",
                      ref[cell]["collective_breakdown"])
