"""Port parity for training the recurrent models: the loss and every
gradient of rwkv6 and jamba smoke against JAX's, and the scans' plain
backwards (the yardsticks of the backward kernels on the card) against
autograd and against ``jax.vjp`` of the JAX model's chunked scans.

The JAX params are converted key for key; inputs come from seeded NumPy.
Tolerances: the reference's own 2e-3 for the models (``tests/test_models.py``),
1e-10 for the plain backwards against autograd in f64 (the same sums in
another order), 1e-3 for them against JAX's chunked scans in f32
(``tests/test_kernels.py``'s tolerance for the scans).  The CPU runs the
plain versions; the kernels run only on the card, where ``chip_smoke.py``
holds them against these plain backwards.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.config import get_arch as jax_get_arch
from repro.models import api as japi
from repro.models.rwkv6 import wkv_chunked
from repro.models.ssm import selective_scan_chunked
from repro_torch.convert import params_from_jax
from repro_torch.core import config as tconfig
from repro_torch.kernels.rwkv6_scan import ref as kref
from repro_torch.kernels.ssm_scan import ref as sref
from repro_torch.models import api as tapi
from repro_torch.optim import adamw as tadamw

TOL = dict(atol=2e-3, rtol=2e-3)
B, S = 2, 12
ARCHS = ["rwkv6-1.6b", "jamba-1.5-large-398b"]


def _f32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32",
                               compute_dtype="float32")


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(JAX config, port config, JAX params, their NumPy twin) of one arch's
    smoke config in f32."""
    jcfg = _f32(jax_get_arch(request.param).smoke)
    tcfg = _f32(tconfig.get_arch(request.param).smoke)
    jp = japi.init_params(jax.random.key(1), jcfg)
    return jcfg, tcfg, jp, jax.tree.map(np.asarray, jp)


@pytest.mark.parametrize("masked", [False, True])
def test_loss_and_grads_match_jax(pair, masked):
    jcfg, tcfg, jp, np_params = pair
    toks = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (B, S)).astype(np.int32)
    jbatch = {"tokens": jnp.asarray(toks)}
    tbatch = {"tokens": torch.from_numpy(toks)}
    if masked:
        mask = (np.random.default_rng(5).random((B, S)) < 0.6)
        mask = mask.astype(np.float32)
        jbatch["loss_mask"] = jnp.asarray(mask)
        tbatch["loss_mask"] = torch.from_numpy(mask)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: japi.loss_fn(p, jcfg, b, remat="none"), has_aux=True))(
        jp, jbatch)
    tparams = params_from_jax(np_params, "cpu")
    named = tadamw.named_leaves(tparams)
    alias = {p: t.detach().requires_grad_() for p, t in named}
    loss, metrics = tapi.loss_fn(tadamw.tree_like(tparams, alias), tcfg,
                                 tbatch, remat="none")
    grads = torch.autograd.grad(loss, [alias[p] for p, _ in named])
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **TOL)
    for key in ("loss", "aux", "total"):
        np.testing.assert_allclose(float(metrics[key].detach()),
                                   float(jmet[key]), **TOL)
    jnamed = dict(tadamw.named_leaves(jax.tree.map(np.asarray, jgrads)))
    assert jnamed.keys() == {p for p, _ in named}
    for (path, _), g in zip(named, grads):
        np.testing.assert_allclose(g.numpy(), jnamed[path], **TOL,
                                   err_msg=path)


# ---------------------------------------------------------------------------
# The scans' plain backwards
# ---------------------------------------------------------------------------

def _ssm_inputs(Bz, S_, di, ds, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((Bz, S_, di))
    dt = np.log1p(np.exp(rng.standard_normal((Bz, S_, di)) - 1))
    A = np.log(np.tile(np.arange(1, ds + 1, dtype=np.float64)[None], (di, 1)))
    Bm, Cm = (rng.standard_normal((Bz, S_, ds)) for _ in range(2))
    D = rng.standard_normal(di)
    h0 = rng.standard_normal((Bz, di, ds)) * 0.1
    dy = rng.standard_normal((Bz, S_, di))
    dh = rng.standard_normal((Bz, di, ds))
    return [x.astype(dtype) for x in (u, dt, A, Bm, Cm, D, h0, dy, dh)]


def _wkv_inputs(N, S_, hd, seed, logw_value=None, dtype=np.float64):
    rng = np.random.default_rng(seed)
    r, k, v, z = (rng.standard_normal((N, S_, hd)) for _ in range(4))
    logw = np.clip(-np.exp(z * 0.5 - 1), -8.0, -1e-6) if logw_value is None \
        else np.full((N, S_, hd), logw_value)
    u = rng.standard_normal((N, hd)) * 0.1
    s0 = rng.standard_normal((N, hd, hd)) * 0.1
    dout = rng.standard_normal((N, S_, hd))
    dstate = rng.standard_normal((N, hd, hd))
    return [x.astype(dtype) for x in (r, k, v, logw, u, s0, dout, dstate)]


def _torch(xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


@pytest.mark.parametrize("shape", [(2, 9, 6, 4), (1, 17, 5, 8), (2, 1, 3, 16)])
def test_ssm_bwd_ref_matches_autograd_f64(shape):
    *ins, dy, dh = _torch(_ssm_inputs(*shape, seed=1))
    leaves = [t.clone().requires_grad_() for t in ins]
    auto = torch.autograd.grad(sref.ssm_scan_ref(*leaves), leaves, (dy, dh))
    got = sref.ssm_scan_bwd_ref(*ins, dy, dh)
    assert all(g.dtype == torch.float64 for g in got)
    for g, a in zip(got, auto):
        np.testing.assert_allclose(g.numpy(), a.numpy(), atol=1e-10, rtol=0)


@pytest.mark.parametrize("shape", [(2, 9, 4), (3, 40, 8), (1, 1, 16)])
def test_rwkv6_bwd_ref_matches_autograd_f64(shape):
    *ins, dout, dstate = _torch(_wkv_inputs(*shape, seed=1))
    leaves = [t.clone().requires_grad_() for t in ins]
    auto = torch.autograd.grad(kref.rwkv6_scan_ref(*leaves), leaves,
                               (dout, dstate))
    got = kref.rwkv6_scan_bwd_ref(*ins, dout, dstate)
    assert all(g.dtype == torch.float64 for g in got)
    for g, a in zip(got, auto):
        np.testing.assert_allclose(g.numpy(), a.numpy(), atol=1e-10, rtol=0)


def test_bwd_refs_take_no_final_state_gradient_as_zero():
    *ins, dy, dh = _torch(_ssm_inputs(2, 7, 4, 8, seed=2))
    for a, b in zip(sref.ssm_scan_bwd_ref(*ins, dy),
                    sref.ssm_scan_bwd_ref(*ins, dy, torch.zeros_like(dh))):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    *ins, dout, dstate = _torch(_wkv_inputs(2, 7, 4, seed=2))
    for a, b in zip(kref.rwkv6_scan_bwd_ref(*ins, dout),
                    kref.rwkv6_scan_bwd_ref(*ins, dout,
                                            torch.zeros_like(dstate))):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


_ssm_vjp = jax.jit(lambda args, cot: jax.vjp(
    lambda *a: selective_scan_chunked(*a, chunk=16), *args)[1](cot))


# (Bz, S, di, ds): a ragged last chunk of JAX's 16, two chunks, one step
@pytest.mark.parametrize("shape", [(2, 37, 24, 16), (1, 32, 16, 8),
                                   (2, 1, 8, 16)])
def test_ssm_bwd_ref_matches_jax_vjp(shape):
    xs = _ssm_inputs(*shape, seed=3, dtype=np.float32)
    *ins, dy, dh = xs
    want = _ssm_vjp(tuple(jnp.asarray(x) for x in ins),
                    (jnp.asarray(dy), jnp.asarray(dh)))
    got = sref.ssm_scan_bwd_ref(*_torch(xs))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-3,
                                   rtol=0)


_wkv_vjp = jax.jit(lambda args, cot: jax.vjp(wkv_chunked, *args)[1](cot))


def _wkv_vjp_rows(r, k, v, logw, u, s0, dout, dstate):
    """jax.vjp of ``wkv_chunked`` with the op's N rows as heads of one batch
    row, so that u is one per row as the op takes it."""
    head = [jnp.asarray(x)[None] for x in (r, k, v, logw)]
    dr, dk, dv, dlogw, du, ds0 = _wkv_vjp(
        (*head, jnp.asarray(u), jnp.asarray(s0)[None]),
        (jnp.asarray(dout)[None], jnp.asarray(dstate)[None]))
    return [np.asarray(x)[0] for x in (dr, dk, dv, dlogw)] + \
        [np.asarray(du), np.asarray(ds0)[0]]


# (N, S, hd, logw): a ragged last chunk of JAX's 16, and both decay extremes
@pytest.mark.parametrize("N,S_,hd,logw_value", [
    (3, 37, 8, None), (2, 20, 16, -8.0), (2, 20, 16, -1e-6)])
def test_rwkv6_bwd_ref_matches_jax_vjp(N, S_, hd, logw_value):
    xs = _wkv_inputs(N, S_, hd, seed=4, logw_value=logw_value,
                     dtype=np.float32)
    want = _wkv_vjp_rows(*xs)
    got = kref.rwkv6_scan_bwd_ref(*_torch(xs))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-3, rtol=0)


def _dlogw_closed_form(r, k, u, v, dout, dr, dk, dstate, state):
    """dlogw_t = sum_{s>t} r o dr - sum_{s>=t} k o dk + r_t o u o k_t (v_t .
    dy_t) + sum_v dS_final o S_final, from the other gradients."""
    x = r * dr - k * dk
    suffix = torch.flip(torch.cumsum(torch.flip(x, [1]), 1), [1])  # s >= t
    bonus = r * u[:, None] * k * (v * dout).sum(-1, keepdim=True)
    return (dstate * state).sum(-1)[:, None] + suffix - x - k * dk + bonus


@pytest.mark.parametrize("logw_value,rel,rel_direct", [
    (None, 1e-5, 1e-5), (-8.0, 1e-2, 1e-6), (-1e-6, 1e-5, 1e-5)])
def test_dlogw_closed_form_in_f32_against_f64(logw_value, rel, rel_direct):
    """The closed form is exact (f64 against the recurrence: 1e-10), but in
    f32 it is a difference of large sums: at N 4, S 512, hd 64 it is 1.6e-4
    off f64 at random decays (|dlogw| up to 141: 1.2e-6 of it), 1.2e-4 at
    logw = -8 (|dlogw| up to 0.043: 2.8e-3 of it, where the recurrence in
    f32 is 8.6e-9 off) and 3.0e-2 at -1e-6 (|dlogw| up to 8.0e3: 3.7e-6 of
    it).  That loss at logw = -8 is why the backward kernel does not use
    it: it expands w_t sum_v G_t o S_{t-1} term by term instead
    (``csrc/rwkv6_scan_bwd.cu``; ``_wkv_bwd_chunked`` below).  ``rel`` / ``rel_direct``: the bounds on
    the closed form's and the recurrence's f32 errors as a share of dlogw's
    largest value."""
    xs = _wkv_inputs(4, 512, 64, seed=5, logw_value=logw_value)
    exact = kref.rwkv6_scan_bwd_ref(*_torch(xs))[3]
    ins64 = _torch(xs)
    r, k, v, logw, u, s0, dout, dstate = ins64
    _, state = kref.rwkv6_scan_ref(r, k, v, logw, u, s0)
    dr, dk = kref.rwkv6_scan_bwd_ref(*ins64)[:2]
    closed64 = _dlogw_closed_form(r, k, u, v, dout, dr, dk, dstate, state)
    np.testing.assert_allclose(closed64.numpy(), exact.numpy(), atol=1e-10,
                               rtol=0)
    ins32 = [t.float() for t in ins64]
    r, k, v, logw, u, s0, dout, dstate = ins32
    _, state = kref.rwkv6_scan_ref(r, k, v, logw, u, s0)
    dr, dk, _, direct = kref.rwkv6_scan_bwd_ref(*ins32)[:4]
    closed = _dlogw_closed_form(r, k, u, v, dout, dr, dk, dstate, state)
    scale = exact.abs().max().item()
    err = (closed.double() - exact).abs().max().item()
    err_direct = (direct.double() - exact).abs().max().item()
    assert err <= rel * scale
    assert err_direct <= rel_direct * scale


def _wkv_bwd_chunked(r, k, v, logw, u, s0, dout, dstate, C=32):
    """The WKV backward as ``csrc/rwkv6_scan_bwd.cu`` computes it, in
    PyTorch and in the inputs' dtype: chunks of C steps, the state entering
    each chunk, the chunk's own dG, the reverse pass over chunks (G_end and
    Q = sum_v S_in o G_end), then per chunk dr, dk, dv and dlogw expanded
    term by term, the adjacent-step terms (decay 1) left out of the
    in-chunk sums that feed dlogw."""
    N, S_, hd = r.shape
    nc = -(-S_ // C)
    pad = lambda t: torch.nn.functional.pad(t, (0, 0, 0, nc * C - S_))
    r, k, v, logw, dout = map(pad, (r, k, v, logw, dout))
    part = lambda t, c: t[:, c * C:(c + 1) * C]
    w, s_in, s = torch.exp(logw), [], s0
    for c in range(nc):                             # the forward's scratch
        s_in.append(s)
        for t in range(c * C, (c + 1) * C):
            s = w[:, t, :, None] * s + k[:, t, :, None] * v[:, t, None, :]
    dg, decay = [], []
    for c in range(nc):                             # launch 1
        cum = torch.cumsum(part(logw, c), 1)
        dg.append(torch.einsum("ntk,ntv->nkv", part(r, c)
                               * torch.exp(cum - part(logw, c)), part(dout, c)))
        decay.append(cum[:, -1])
    du = sum(((part(r, c) * part(k, c) * (part(v, c) * part(dout, c)).sum(
        -1, keepdim=True)).sum(1) for c in range(nc)))
    G, g_end, q = dstate, [None] * nc, [None] * nc
    for c in reversed(range(nc)):                   # launch 2
        g_end[c], q[c] = G, (s_in[c] * G).sum(-1)
        G = torch.exp(decay[c])[:, :, None] * G + dg[c]
    tri = torch.tril(torch.ones(C, C, dtype=r.dtype), -1)
    near = torch.diag(torch.ones(C - 1, dtype=r.dtype), -1)
    grads = [torch.zeros_like(r) for _ in range(4)]
    for c in range(nc):                             # launch 3
        rc, kc, vc, dy, lw = (part(t, c) for t in (r, k, v, dout, logw))
        cum = torch.cumsum(lw, 1)
        cum_ex, cend = cum - lw, cum[:, -1:]
        M = torch.einsum("ntj,nij->nti", dy, vc)
        Mtt = torch.diagonal(M, dim1=1, dim2=2)[..., None]
        E = torch.exp((cum_ex[:, :, None] - cum[:, None, :]).clamp(max=0))
        tr = M[..., None] * kc[:, None] * E                 # (n, t, i, kk)
        drin = torch.exp(cum_ex) * torch.einsum("nkj,ntj->ntk", s_in[c], dy)
        dr_far = (tr * (tri - near)[..., None]).sum(2)
        dr = drin + dr_far + (tr * near[..., None]).sum(2) + u[:, None] * kc * Mtt
        tk = M[..., None] * rc[:, :, None] * E              # (n, s, t, kk)
        dk_far = (tk * (tri - near)[..., None]).sum(1)
        dkend = torch.exp(cend - cum) * torch.einsum("nkj,ntj->ntk", g_end[c], vc)
        dk = dkend + dk_far + (tk * near[..., None]).sum(1) + rc * u[:, None] * Mtt
        A = torch.einsum("nsk,ntk,nstk->nst", rc, kc, E) * tri
        bonus = (rc * u[:, None] * kc).sum(-1, keepdim=True)
        dv = torch.einsum("ntk,nkj->ntj", kc * torch.exp(cend - cum), g_end[c]) \
            + torch.einsum("nst,nsj->ntj", A, dy) + bonus * dy
        a = rc * drin
        rf = rc * dr_far
        b = kc * (dkend + dk_far) - torch.cat([rf[:, 1:], 0 * rf[:, :1]], 1)
        zero = torch.zeros_like(a[:, :1])      # exclusive sums, as running
        suffix = torch.cat([torch.flip(torch.cumsum(torch.flip(
            a[:, 1:], [1]), 1), [1]), zero], 1)          # sum_{s>t} a_s
        prefix = torch.cat([zero, torch.cumsum(b[:, :-1], 1)], 1)
        dlogw = torch.exp(cend) * q[c][:, None] + suffix + prefix
        for g, x in zip(grads, (dr, dk, dv, dlogw)):
            g[:, c * C:(c + 1) * C] = x
    return [g[:, :S_] for g in grads] + [du, G]


@pytest.mark.parametrize("N,S_,hd,logw_value", [
    (3, 45, 8, None), (2, 64, 16, -8.0), (2, 33, 4, -1e-6), (1, 1, 8, None)])
def test_the_kernels_chunked_backward_is_exact_in_f64(N, S_, hd, logw_value):
    """The backward kernel's algorithm (chunks of 32, ragged last chunk,
    the dlogw expansion) equals the reverse recurrence in f64."""
    xs = _torch(_wkv_inputs(N, S_, hd, seed=6, logw_value=logw_value))
    want = kref.rwkv6_scan_bwd_ref(*xs)
    for g, w in zip(_wkv_bwd_chunked(*xs), want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-10, rtol=0)


@pytest.mark.parametrize("logw_value,rel", [(-8.0, 1e-6), (-1e-6, 1e-5)])
def test_the_kernels_dlogw_keeps_its_digits_in_f32(logw_value, rel):
    """In f32, at N 4, S 512, hd 64, the kernel's dlogw is 1.4e-8 off f64
    at logw = -8 (|dlogw| up to 0.043: 3.3e-7 of it, where the closed form
    is 2.8e-3 of it off) and 2.1e-2 at -1e-6 (|dlogw| up to 8.0e3: 2.6e-6
    of it); ``rel`` bounds the error as a share of dlogw's largest value."""
    xs = _wkv_inputs(4, 512, 64, seed=5, logw_value=logw_value)
    exact = kref.rwkv6_scan_bwd_ref(*_torch(xs))[3]
    got = _wkv_bwd_chunked(*(t.float() for t in _torch(xs)))[3]
    err = (got.double() - exact).abs().max().item()
    assert err <= rel * exact.abs().max().item()
