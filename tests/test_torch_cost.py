"""The port's cost extraction: the counter (``repro_torch.core.cost``, the
twin of ``tests/test_hlo.py``'s walker tests), each kernel wrapper's meta
route and cost formula, and the roofline against the reference's.

Products count 2 * m * n * k FLOPs each; bytes count each operand read once
and each output written once; views count nothing.  On ``meta`` tensors a
kernel wrapper takes the card's route up to the launch and notes its cost
instead; its outputs have the plain version's shapes and dtypes, and its
``launches`` do not move.
"""
import json

import numpy as np
import pytest
import torch

from repro.core import hw as jhw
from repro.core.estimator import roofline as jroofline
from repro.core.taskgraph.compiler import CompilePlan as JPlan
from repro_torch.core import hw
from repro_torch.core.cost.analysis import (CostCounter, analyze_step, note,
                                            top_contributors)
from repro_torch.core.estimator.roofline import (CompilePlan, rate_table,
                                                 roofline_terms)
from repro_torch.kernels.decode_attention import ops as dops
from repro_torch.kernels.flash_attention import bwd as fbwd
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.mla_decode import ops as mops
from repro_torch.kernels.rwkv6_scan import bwd as kbwd
from repro_torch.kernels.rwkv6_scan import ops as kops
from repro_torch.kernels.ssm_scan import bwd as sbwd
from repro_torch.kernels.ssm_scan import ops as sops

DEVICES = ["cpu", "meta"]


def _rand(*shape, dtype=torch.float32, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) \
        .to(dtype)


# ---------------------------------------------------------------------------
# the counter
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("device", DEVICES)
def test_product_chain_counts_each_product(device):
    x = torch.zeros(64, 128, device=device)
    w = torch.zeros(128, 128, device=device)

    def chain(x, w):
        for _ in range(6):
            x = x @ w
        return x

    rep = analyze_step(chain, x, w)
    assert rep["flops"] == 6 * 2 * 64 * 128 * 128
    assert rep["by_op"]["aten.mm"]["count"] == 6


@pytest.mark.parametrize("device", DEVICES)
def test_loops_count_every_trip(device):
    x = torch.zeros(8, 32, device=device)
    w = torch.zeros(32, 32, device=device)
    one = analyze_step(lambda x, w: x @ w, x, w)["flops"]

    def loop(x, w):
        for _ in range(10):
            x = torch.tanh(x @ w)
        return x

    def nested(x, w):
        for _ in range(4):
            for _ in range(3):
                x = x @ w
        return x

    assert analyze_step(loop, x, w)["flops"] == 10 * one
    assert analyze_step(nested, x, w)["flops"] == 12 * one


@pytest.mark.parametrize("device", DEVICES)
def test_bytes_of_an_elementwise_chain(device):
    n = 1000
    x = torch.zeros(n, device=device)
    rep = analyze_step(lambda x: torch.exp(x * 2.0) + 1.0, x)
    # three ops, each reads n f32 and writes n f32
    assert rep["hbm_bytes"] == 3 * 2 * 4 * n
    assert rep["flops"] == 0
    half = analyze_step(lambda x: torch.exp(x.to(torch.bfloat16)), x)
    assert half["hbm_bytes"] == (4 + 2) * n + (2 + 2) * n


@pytest.mark.parametrize("device", DEVICES)
def test_views_count_nothing(device):
    x = torch.zeros(4, 6, 8, device=device)

    def views(x):
        return (x.transpose(0, 2), x.reshape(24, 8), x[:, 1:3],
                x[None].expand(5, 4, 6, 8), x.permute(2, 0, 1), x.detach())

    rep = analyze_step(views, x)
    assert rep["hbm_bytes"] == 0 and rep["temp_bytes"] == 0


@pytest.mark.parametrize("device", DEVICES)
def test_an_expanded_operand_counts_what_it_holds(device):
    m, n = 64, 32
    row = torch.zeros(n, device=device)
    y = torch.zeros(m, n, device=device)
    rep = analyze_step(lambda r, y: r.expand(m, n) + y, row, y)
    assert rep["hbm_bytes"] == 4 * (n + m * n + m * n)
    # a slice reads the elements it holds, not its storage
    big = torch.zeros(100, n, device=device)
    rep = analyze_step(lambda b: b[10:20] * 2.0, big)
    assert rep["hbm_bytes"] == 4 * 2 * 10 * n


@pytest.mark.parametrize("device", DEVICES)
def test_in_place_ops_read_and_write_their_target_once(device):
    n = 500
    x, y = torch.zeros(n, device=device), torch.zeros(n, device=device)
    rep = analyze_step(lambda x, y: x.add_(y), x, y)
    assert rep["hbm_bytes"] == 3 * 4 * n          # x read, y read, x written
    # an indexed write touches the rows it indexes
    cache = torch.zeros(4, 2, 64, 8, device=device)
    new = torch.zeros(4, 2, 8, device=device)
    rows = torch.arange(4, device=device)
    at = torch.zeros(4, dtype=torch.long, device=device)

    def write(cache, new, rows, at):
        cache[rows, :, at] = new

    rep = analyze_step(write, cache, new, rows, at)
    assert rep["by_op"]["aten.index_put_"]["bytes"] == \
        8 * 4 + 8 * 4 + 4 * 64 + 2 * 4 * 64
    # an indexed read (an embedding lookup) reads the rows it gathers
    table = torch.zeros(1000, 16, device=device)
    ids = torch.zeros(3, 5, dtype=torch.long, device=device)
    rep = analyze_step(lambda t, i: t[i], table, ids)
    assert rep["hbm_bytes"] == 8 * 15 + 2 * 4 * 15 * 16


@pytest.mark.parametrize("device", DEVICES)
def test_peak_bytes_of_a_known_sequence(device):
    n = 1 << 16
    x = torch.zeros(n, device=device)

    def seq(x):
        a = x * 2.0
        b = a * 2.0
        c = a + b                 # x, a, b, c live: the peak
        del a, b
        return c * 2.0            # x, c, the result

    rep = analyze_step(seq, x)
    assert rep["argument_bytes"] == 4 * n
    assert rep["peak_bytes"] == 4 * 4 * n
    assert rep["temp_bytes"] == 3 * 4 * n
    assert rep["output_bytes"] == 4 * n
    assert rep["storages"] == 4               # a, b, c, the result


def test_note_adds_a_kernel_only_under_a_counter():
    def unreachable():
        raise AssertionError("a cost formula evaluated with no counter")

    note("some_kernel", unreachable)                # no counter: not called
    with CostCounter() as counter:
        note("some_kernel", lambda: (10, 20))
        note("some_kernel", lambda f, b: (f, b), 1, b=2)
    rep = counter.report()
    assert (rep["flops"], rep["hbm_bytes"]) == (11, 22)
    assert rep["by_op"]["some_kernel"] == {"flops": 11, "bytes": 22,
                                           "count": 2}
    assert top_contributors(rep, 1, "flops") == [(11, 2, "some_kernel")]


def test_backward_and_recomputation_are_counted():
    w = torch.zeros(32, 32, device="meta", requires_grad=True)
    x = torch.zeros(16, 32, device="meta")

    def loss(x, w):
        return torch.tanh(x @ w).sum()

    def plain(x, w):
        return torch.autograd.grad(loss(x, w), [w])

    def remat(x, w):
        from torch.utils.checkpoint import checkpoint
        return torch.autograd.grad(checkpoint(loss, x, w, use_reentrant=False),
                                   [w])

    one = 2 * 16 * 32 * 32
    # forward, and the backward's product for w (x needs no gradient)
    assert analyze_step(plain, x, w)["flops"] == 2 * one
    # the forward's product again in the backward
    assert analyze_step(remat, x, w)["flops"] == 3 * one


# ---------------------------------------------------------------------------
# the kernels' meta routes and cost formulas
# ---------------------------------------------------------------------------


def _meta(*tensors):
    return [t.to("meta") for t in tensors]


def _noted(fn, *args, **kw):
    """(out, the by_op row fn noted, launches moved?) of fn on meta args."""
    with CostCounter() as counter:
        out = fn(*args, **kw)
    rows = {k: v for k, v in counter.report()["by_op"].items()
            if not k.startswith("aten.")}
    return out, rows


def _like(got, want):
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    assert [(tuple(g.shape), g.dtype, g.device.type) for g in got] == \
        [(tuple(w.shape), w.dtype, "meta") for w in want]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_meta_route(dtype):
    B, Hq, Hkv, S, hd = 2, 4, 2, 24, 16
    q, k, v = _rand(B, Hq, hd, dtype=dtype), _rand(B, Hkv, S, hd, dtype=dtype,
                                                   seed=1), \
        _rand(B, Hkv, S, hd, dtype=dtype, seed=2)
    lens = torch.tensor([5, 24], dtype=torch.int32)
    launches = dops.launches
    out, rows = _noted(dops.decode_attention, *_meta(q, k, v, lens))
    _like(out, dops.decode_attention_ref(q, k, v, lens))
    e = q.element_size()
    assert dops.launches == launches
    assert rows == {"decode_attention": {
        "flops": 4 * B * Hq * S * hd,
        "bytes": 2 * B * Hq * hd * e + 4 * B + 2 * B * Hkv * S * hd * e,
        "count": 1}}
    # the positions kv_len covers, as a caller that knows them passes
    assert dops.cost(q, k, v, lens, keys=29)[0] == 4 * Hq * hd * 29


@pytest.mark.parametrize("hd,hd_v", [(16, 16), (24, 16), (192, 128)])
def test_flash_attention_meta_route(hd, hd_v):
    B, Hq, Hkv, Sq, Sk = 1, 4, 2, 8, 12
    q, k, v = _rand(B, Hq, Sq, hd), _rand(B, Hkv, Sk, hd, seed=1), \
        _rand(B, Hkv, Sk, hd_v, seed=2)
    launches = fops.launches
    with torch.no_grad():
        out, rows = _noted(fops.flash_attention, *_meta(q, k, v),
                           causal=True, q_offset=Sk - Sq)
    _like(out, fops.attention_ref(q, k, v, causal=True, q_offset=Sk - Sq))
    assert fops.launches == launches
    assert rows == {"flash_attention": {
        "flops": 2 * B * Hq * Sq * Sk * (hd + hd_v),
        "bytes": 4 * (B * Hq * Sq * hd + B * Hkv * Sk * (hd + hd_v)
                      + B * Hq * Sq * hd_v),
        "count": 1}}
    # the log-sum-exp the grad-mode forward writes besides
    out, rows = _noted(fops.flash_attention_fwd, *_meta(q, k, v))
    _like(out, (fops.attention_ref(q, k, v), torch.zeros(B, Hq, Sq)))
    assert rows["flash_attention"]["bytes"] == fops.cost(q, k, v)[1] \
        + 4 * B * Hq * Sq


def test_flash_attention_bwd_meta_route():
    B, Hq, Hkv, Sq, Sk, hd = 2, 4, 2, 8, 8, 16
    q, k, v, do = (_rand(*s, seed=i) for i, s in enumerate(
        ((B, Hq, Sq, hd), (B, Hkv, Sk, hd), (B, Hkv, Sk, hd),
         (B, Hq, Sq, hd))))
    o = fops.attention_ref(q, k, v)
    lse = fops.ref.attention_lse_ref(q, k)
    launches = fbwd.launches
    out, rows = _noted(fbwd.flash_attention_bwd, *_meta(q, k, v, o, lse, do))
    _like(out, fbwd.attention_bwd_ref(q, k, v, o, lse, do))
    assert fbwd.launches == launches
    assert rows == {"flash_attention_bwd": {
        "flops": 7 * 2 * B * Hq * Sq * Sk * hd,
        "bytes": 4 * (4 * B * Hq * Sq * hd + 4 * B * Hkv * Sk * hd)
        + 4 * B * Hq * Sq,
        "count": 1}}


def test_flash_attention_bwd_cost_at_mla_widths():
    """At MLA's (192, 128) the backward's seven products count their own
    widths, 2 B Hq pairs (4 hd + 3 hd_v): S and dK at hd and dP and dV at
    hd_v in the dK/dV pass, S and dQ at hd and dP at hd_v in the dQ pass;
    bytes: q, k, dq, dk at hd, v, o, do, dv at hd_v, and lse."""
    B, Hq, Hkv, Sq, Sk, hd, hd_v = 2, 4, 4, 8, 12, 192, 128
    q, k, v, o, do = (_rand(*s, seed=i) for i, s in enumerate(
        ((B, Hq, Sq, hd), (B, Hkv, Sk, hd), (B, Hkv, Sk, hd_v),
         (B, Hq, Sq, hd_v), (B, Hq, Sq, hd_v))))
    lse = fops.ref.attention_lse_ref(q, k, causal=True, q_offset=Sk - Sq)
    out, rows = _noted(fbwd.flash_attention_bwd,
                       *_meta(q, k, v, o, lse, do), q_offset=Sk - Sq)
    _like(out, (q, k, v))
    flops = 2 * B * Hq * Sq * Sk * (4 * hd + 3 * hd_v)
    assert flops == 7 * 2 * B * Hq * Sq * Sk * hd * 1152 // 1344
    assert rows == {"flash_attention_bwd": {
        "flops": flops,
        "bytes": 4 * (2 * (B * Hq * Sq * hd + B * Hkv * Sk * (hd + hd_v))
                      + 2 * B * Hq * Sq * hd_v + B * Hq * Sq),
        "count": 1}}
    # the visible pairs a caller passes
    assert fbwd.cost(q, k, v, o, lse, do, pairs=50)[0] == \
        2 * B * Hq * 50 * (4 * hd + 3 * hd_v)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mla_decode_meta_route(dtype):
    B, H, L, R, T = 2, 4, 32, 8, 16
    q, qr = _rand(B, H, L, dtype=dtype), _rand(B, H, R, dtype=dtype, seed=1)
    ckv, kr = _rand(B, T, L, dtype=dtype, seed=2), _rand(B, T, R, dtype=dtype,
                                                         seed=3)
    lens = torch.tensor([3, 16], dtype=torch.int32)
    launches = mops.launches
    out, rows = _noted(mops.mla_decode, *_meta(q, qr, ckv, kr, lens), 0.1)
    _like(out, mops.mla_decode_ref(q, qr, ckv, kr, lens, 0.1))
    e = q.element_size()
    assert mops.launches == launches
    assert rows == {"mla_decode": {
        "flops": 2 * B * H * T * (2 * L + R),
        "bytes": (2 * B * H * L + B * H * R) * e + 4 * B
        + B * T * (L + R) * e,
        "count": 1}}


def _ssm_inputs(Bz=2, S=20, di=12, ds=8):
    return (_rand(Bz, S, di), torch.rand(Bz, S, di) * 0.1,
            _rand(di, ds, seed=1), _rand(Bz, S, ds, seed=2),
            _rand(Bz, S, ds, seed=3), _rand(di, seed=4),
            _rand(Bz, di, ds, seed=5))


def test_ssm_scan_meta_route():
    args = _ssm_inputs()
    Bz, S, di = args[0].shape
    ds = args[2].shape[1]
    launches = sops.launches
    out, rows = _noted(sops.ssm_scan, *_meta(*args))
    _like(out, sops.ssm_scan_ref(*args))
    assert sops.launches == launches
    ins = 4 * (2 * Bz * S * di + di * ds + 2 * Bz * S * ds + di
               + Bz * di * ds)
    assert rows == {"ssm_scan": {
        "flops": 4 * Bz * S * di * ds,
        "bytes": ins + 4 * (Bz * S * di + Bz * di * ds), "count": 1}}
    # the grad-mode forward writes its checkpoints besides
    out, rows = _noted(sops.ssm_scan_fwd, *_meta(*args))
    ckpt = sbwd.checkpoint_shape(Bz, S, di, ds)
    assert tuple(out[2].shape) == ckpt
    assert rows["ssm_scan"]["bytes"] == ins + 4 * (
        Bz * S * di + Bz * di * ds + int(np.prod(ckpt)))


def test_ssm_scan_bwd_meta_route():
    args = _ssm_inputs()
    Bz, S, di = args[0].shape
    ds = args[2].shape[1]
    dy, dh = _rand(Bz, S, di, seed=6), _rand(Bz, di, ds, seed=7)
    ckpt = torch.zeros(sbwd.checkpoint_shape(Bz, S, di, ds))
    launches = sbwd.launches
    out, rows = _noted(sbwd.ssm_scan_bwd, *_meta(*args, dy, dh), ckpt=ckpt.to(
        "meta"))
    _like(out, sbwd.ssm_scan_bwd(*args, dy, dh))
    assert sbwd.launches == launches
    n, m = Bz * S * di, Bz * S * ds
    ins = 4 * (n + n + di * ds + 2 * m + di + ckpt.numel() + n + Bz * di * ds)
    outs = 4 * (n + n + di * ds + 2 * m + di + Bz * di * ds)
    assert rows == {"ssm_scan_bwd": {
        "flops": 12 * Bz * S * di * ds, "bytes": ins + outs, "count": 1}}


def _wkv_inputs(N=3, S=37, hd=8):
    return (_rand(N, S, hd), _rand(N, S, hd, seed=1), _rand(N, S, hd, seed=2),
            -torch.rand(N, S, hd) - 0.1, _rand(N, hd, seed=3) * 0.1,
            _rand(N, hd, hd, seed=4) * 0.1)


def test_rwkv6_scan_meta_route():
    args = _wkv_inputs()
    N, S, hd = args[0].shape
    launches = kops.launches
    out, rows = _noted(kops.rwkv6_scan, *_meta(*args))
    _like(out, kops.rwkv6_scan_ref(*args))
    assert kops.launches == launches
    # chunks of 32 and 5 steps
    chunks = 32 ** 2 + 5 ** 2
    assert rows == {"rwkv6_scan": {
        "flops": 4 * N * (S * hd * hd + hd * chunks),
        "bytes": 4 * (5 * N * S * hd + N * hd + 2 * N * hd * hd),
        "count": 1}}


def test_rwkv6_scan_bwd_meta_route():
    args = _wkv_inputs()
    N, S, hd = args[0].shape
    dout, dstate = _rand(N, S, hd, seed=5), _rand(N, hd, hd, seed=6)
    states = torch.zeros(kops.scratch_shapes(N, S, hd)[0])
    launches = kbwd.launches
    out, rows = _noted(kbwd.rwkv6_scan_bwd, *_meta(*args, dout, dstate),
                       states=states.to("meta"))
    _like(out, kbwd.rwkv6_scan_bwd(*args, dout, dstate))
    assert kbwd.launches == launches
    chunks = 32 ** 2 + 5 ** 2
    ins = 4 * (5 * N * S * hd + N * hd + states.numel() + N * hd * hd)
    outs = 4 * (4 * N * S * hd + N * hd + N * hd * hd)
    assert rows == {"rwkv6_scan_bwd": {
        "flops": N * (8 * S * hd * hd + 10 * hd * chunks),
        "bytes": ins + outs, "count": 1}}


def test_scratch_bytes_closed_forms():
    """The split scratch a card's call allocates beyond its outputs, which
    a dry run leaves out, at 132 SMs: K1 f32 B 1, 16 heads over 32768 keys
    takes 32 splits of (m, l, acc); K2's backward splits a 64-query walk
    over 1024 keys 8 ways, one (64 x 64) f32 slot a split of each dQ tile;
    mla_decode at deepseek's served step, 2 head chunks x (8 blocks + 4
    rows) x 64 heads of (L + 2) f32; none where nothing splits."""
    def m(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    assert dops.scratch_bytes(m(1, 16, 64), m(1, 16, 32768, 64), 132) \
        == 4 * 16 * 32 * (64 + 2)
    assert dops.scratch_bytes(m(4, 16, 64), m(4, 16, 512, 64), 132) == 0
    q, k = m(1, 2, 64, 64), m(1, 2, 1024, 64)
    assert fbwd.scratch_bytes(q, k, 132, causal=False) == 4 * 2 * 8 * 64 * 64
    assert fbwd.scratch_bytes(q, k, 132, causal=False, via="cuda_cores") == 0
    assert fbwd.scratch_bytes(m(4, 16, 512, 64), m(4, 16, 512, 64), 132) == 0
    bf = torch.bfloat16
    assert mops.scratch_bytes(m(4, 128, 512, dtype=bf), m(4, 128, 64, dtype=bf),
                              132) == 4 * 2 * (8 + 4) * 64 * (512 + 2)


def test_cpu_tensors_run_the_plain_versions_and_note_nothing():
    q, k, v = _rand(1, 2, 4, 16), _rand(1, 2, 4, 16, seed=1), \
        _rand(1, 2, 4, 16, seed=2)
    out, rows = _noted(fops.flash_attention, q, k, v)
    assert rows == {} and out.device.type == "cpu"


# ---------------------------------------------------------------------------
# the roofline against the reference's
# ---------------------------------------------------------------------------


def test_h100_description_loads_in_the_reference():
    text = hw.h100_sxm().to_json()
    ref = jhw.SystemDescription.from_json(text)
    assert json.loads(text) == json.loads(ref.to_json())
    assert hw.SystemDescription.from_json(text) == hw.h100_sxm()
    assert ref.num_chips == 1 and ref.chip.memory.bandwidth == 3.35e12


@pytest.mark.parametrize("flops,nbytes,coll,dtype", [
    (6.9e12, 1.9e11, 0.0, "float32"),
    (1.67e12, 5.97e9, 0.0, "bfloat16"),
    (3.9e9, 2.3e9, 1e6, "float32"),
    (0.0, 0.0, 0.0, "bfloat16"),
])
def test_roofline_terms_equal_the_reference(flops, nbytes, coll, dtype):
    ref_system = jhw.SystemDescription.from_json(hw.h100_sxm().to_json())
    got = roofline_terms(flops, nbytes, coll, hw.h100_sxm(),
                         CompilePlan(dtype=dtype))
    want = jroofline.roofline_terms(
        flops, nbytes, coll, ref_system,
        JPlan(dtype=dtype, bidirectional_ici=False))
    assert got == want
    rates = rate_table(hw.h100_sxm(), CompilePlan(dtype=dtype))
    assert rates["matrix"] == (67e12 if dtype == "float32" else 989e12)
