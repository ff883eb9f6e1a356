"""The rounding of the flash-attention backward kernel's tensor-core routes,
emulated in plain PyTorch on the CPU.

``csrc/flash_attention_bwd.cu`` runs its products on the tensor cores: in
bf16 (wgmma) it rounds P and dS to bf16 before the dV, dK and dQ products;
in f32 it splits every operand x into hi = tf32(x) and lo = tf32(x - hi)
(``cvt.rna.tf32.f32``: round to nearest on 10 mantissa bits, ties away
from zero) and takes each product as lo*hi + hi*lo + hi*hi (3xTF32).  Each
emulation is held to ``attention_bwd_ref`` within the card's tolerance
(``chip_smoke.py`` ``BWD_TOL``) at every ``BWD_CASES`` shape, and one
TF32 product a term (1xTF32) is shown to land much further away: it
misses the f32 tolerance wherever more than one query row sums.  The
emulation lives here only; the kernels themselves run on the card.
"""
import math

import pytest
import torch

from repro_torch.kernels.flash_attention import ref as fref
from test_torch_kernels_flash_bwd import BWD_CASES, _inputs

BWD_TOL = {torch.float32: dict(atol=3e-5, rtol=1e-2),
           torch.bfloat16: dict(atol=3e-2, rtol=1e-2)}


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32 (10 mantissa bits), to nearest, ties away from
    zero: add half a unit of the 13 dropped bits to the magnitude, then cut
    them (f32 is sign and magnitude, so the raw bits do both)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def mm_3xtf32(a, b):
    a_hi, b_hi = tf32(a), tf32(b)
    a_lo, b_lo = tf32(a - a_hi), tf32(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def mm_1xtf32(a, b):
    return tf32(a) @ tf32(b)


def mm_f32(a, b):
    return a @ b


def bwd_emulated(q, k, v, o, lse, do, causal, q_offset, mm,
                 round_p_ds=lambda t: t):
    """The kernel's backward with its rounding points: every product by
    ``mm``, P and dS by ``round_p_ds`` before the dV, dK and dQ products;
    gradients in the inputs' dtype."""
    B, Hq, Sq, hd = q.shape
    _, Hkv, Sk, _ = k.shape
    group = Hq // Hkv
    scale = 1.0 / math.sqrt(hd)

    def grouped(t):
        return t.reshape(B, Hkv, group, *t.shape[2:]).float()

    qg, og, dog = grouped(q), grouped(o), grouped(do)
    kf, vf = k.float()[:, :, None], v.float()[:, :, None]
    s = mm(qg, kf.transpose(-1, -2)) * scale
    if causal:
        q_pos = q_offset + torch.arange(Sq)
        s = s.masked_fill(q_pos[:, None] < torch.arange(Sk)[None, :],
                          -math.inf)
    p = torch.exp(s - grouped(lse)[..., None])
    dp = mm(dog, vf.transpose(-1, -2))
    ds = p * (dp - (dog * og).sum(-1, keepdim=True))
    p, ds = round_p_ds(p), round_p_ds(ds)
    dv = mm(p.transpose(-1, -2), dog).sum(2)
    dk = mm(ds.transpose(-1, -2), qg).sum(2) * scale
    dq = mm(ds, kf) * scale
    return (dq.reshape(B, Hq, Sq, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _case(case, dtype, seed=0):
    B, Hq, Hkv, Sq, Sk, hd, causal, off = case
    q, k, v, do = (torch.from_numpy(x).to(dtype)
                   for x in _inputs(B, Hq, Hkv, Sq, Sk, hd, seed=seed))
    kw = dict(causal=causal, q_offset=off)
    o = fref.attention_ref(q, k, v, **kw)
    lse = fref.attention_lse_ref(q, k, **kw)
    return (q, k, v, o, lse, do), kw, fref.attention_bwd_ref(
        q, k, v, o, lse, do, **kw)


def _excess(got, want, tol):
    """(max |got - want|, the largest ratio of an element's error to its
    allowance atol + rtol |want|) over the three gradients."""
    err, ratio = 0.0, 0.0
    for g, w in zip(got, want):
        d = (g.float() - w.float()).abs()
        err = max(err, d.max().item())
        ratio = max(ratio, (d / (tol["atol"] + tol["rtol"]
                                 * w.float().abs())).max().item())
    return err, ratio


def test_tf32_rounds_to_nearest_ties_away_on_ten_mantissa_bits():
    one_ulp = 2.0 ** -10
    x = torch.tensor([1.0, 1.0 + one_ulp / 2, 1.0 + one_ulp / 2 * 0.999,
                      -(1.0 + one_ulp / 2), 1.0 + 1.5 * one_ulp, 3.0e-3])
    got = tf32(x)
    assert got.tolist()[:5] == [1.0, 1.0 + one_ulp, 1.0, -(1.0 + one_ulp),
                                1.0 + 2 * one_ulp]
    # ten mantissa bits kept: the low 13 bits are zero, the error is at
    # most half a TF32 unit
    assert ((got.view(torch.int32) & 0x1FFF) == 0).all()
    assert abs(got[5].item() - 3.0e-3) <= 3.0e-3 * 2.0 ** -11
    hi = tf32(x)
    assert torch.equal(hi + tf32(x - hi), x)    # two parts carry all 24 bits


@pytest.mark.parametrize("case", BWD_CASES)
def test_bf16_p_and_ds_rounding_is_within_the_card_tolerance(case):
    args, kw, want = _case(case, torch.bfloat16)
    got = bwd_emulated(*args, **kw, mm=mm_f32,
                       round_p_ds=lambda t: t.bfloat16().float())
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == torch.bfloat16
    err, ratio = _excess(got, want, BWD_TOL[torch.bfloat16])
    assert ratio <= 1.0, f"max err {err}"


@pytest.mark.parametrize("case", BWD_CASES)
def test_3xtf32_is_within_the_f32_tolerance_and_1xtf32_is_not(case):
    args, kw, want = _case(case, torch.float32)
    err3, ratio3 = _excess(bwd_emulated(*args, **kw, mm=mm_3xtf32), want,
                           BWD_TOL[torch.float32])
    err1, ratio1 = _excess(bwd_emulated(*args, **kw, mm=mm_1xtf32), want,
                           BWD_TOL[torch.float32])
    assert ratio3 <= 0.25, f"3xTF32 max err {err3}"
    # one TF32 product keeps ~2^-11 of each operand, three keep ~2^-21:
    # 1xTF32 lands 580-2,500x further away at these shapes
    assert err1 >= 300 * err3, (err1, err3)
    if case[3] > 1:   # with one query the rtol still covers it
        assert ratio1 > 1.0, f"1xTF32 within the f32 tolerance: {err1}"


def test_emulation_with_exact_products_is_the_plain_backward():
    """With exact f32 products and no rounding the emulation is the plain
    backward to f32 summation order: the two share every formula."""
    args, kw, want = _case(BWD_CASES[1], torch.float32, seed=2)
    err, _ = _excess(bwd_emulated(*args, **kw, mm=mm_f32), want,
                     BWD_TOL[torch.float32])
    assert err <= 1e-5
