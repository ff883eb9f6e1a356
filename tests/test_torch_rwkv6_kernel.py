"""Port parity for the RWKV-6 WKV scan's plain version, and its wrapper's
routing.

The plain version (the path a CPU tensor takes) is held against three JAX
references on the same inputs: the sequential ``rwkv6_scan_ref`` (atol
1e-5 and rtol 2e-6: outputs reach |y| ~ 20 at S = 100, hd = 64, where two
f32 sums of 64 terms in another order differ by a few units in the last
place), the Pallas kernel run with ``interpret=True`` and the model's chunked
twin ``wkv_chunked`` in the model's (B, H, S, hd) layout (atol 1e-3, the
reference's own in ``tests/test_kernels.py``).  r, k, v are f32 or bf16 (the
same bf16 values in both frameworks); logw, u and state0 are f32.  The
Hopper kernel itself runs only on the card: ``chip_smoke.py`` holds it
against this plain version there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv6_scan.kernel import rwkv6_scan as pallas_scan
from repro.kernels.rwkv6_scan.ref import rwkv6_scan_ref as jax_ref
from repro.models.rwkv6 import wkv_chunked
from repro_torch.kernels.rwkv6_scan import ops

SHAPES = [(4, 64, 16), (2, 100, 64), (1, 33, 32)]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
CASES = [(shape, dtype) for shape in SHAPES for dtype in DTYPES]
IDS = [f"{'x'.join(map(str, s))}-{d}" for s, d in CASES]

_jax_ref = jax.jit(jax_ref)
_wkv_chunked = jax.jit(wkv_chunked)


def _inputs(N, S, hd, dtype, seed=1):
    """(jax, torch) pairs of r, k, v (in ``dtype``), logw, u, state0 (f32),
    drawn as in tests/test_kernels.py."""
    rng = np.random.default_rng(seed)
    jdt, tdt = DTYPES[dtype]
    z = [rng.standard_normal((N, S, hd)).astype(np.float32) for _ in range(4)]
    logw = np.clip(-np.exp(z[3] * 0.5 - 1), -8.0, -1e-6).astype(np.float32)
    u = (rng.standard_normal((N, hd)) * 0.1).astype(np.float32)
    s0 = (rng.standard_normal((N, hd, hd)) * 0.1).astype(np.float32)
    pairs = [(jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)) for x in z[:3]]
    pairs += [(jnp.asarray(x), torch.from_numpy(x)) for x in (logw, u, s0)]
    return pairs


def _close(jax_out, torch_out, atol, rtol=0.0):
    np.testing.assert_allclose(torch_out.numpy(), np.asarray(jax_out),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("shape,dtype", CASES, ids=IDS)
def test_plain_matches_jax_ref(shape, dtype):
    pairs = _inputs(*shape, dtype)
    out, state = ops.rwkv6_scan(*(t for _, t in pairs))
    assert out.dtype == state.dtype == torch.float32
    assert out.shape == shape and state.shape == (shape[0], shape[2], shape[2])
    want_out, want_state = _jax_ref(*(j for j, _ in pairs))
    _close(want_out, out, 1e-5, 2e-6)
    _close(want_state, state, 1e-5, 2e-6)


@pytest.mark.parametrize("shape,dtype", CASES, ids=IDS)
def test_plain_matches_pallas_interpret(shape, dtype):
    pairs = _inputs(*shape, dtype, seed=2)
    out, state = ops.rwkv6_scan(*(t for _, t in pairs))
    want_out, want_state = pallas_scan(*(j for j, _ in pairs), interpret=True)
    _close(want_out, out, 1e-3)
    _close(want_state, state, 1e-3)


@pytest.mark.parametrize("shape,dtype", CASES, ids=IDS)
def test_model_scan_matches_wkv_chunked(shape, dtype):
    """The model's path (B, H, S, hd) -> op rows -> back, u tiled from
    (H, hd), against the chunked twin the JAX model runs."""
    N, S, hd = shape
    B, H = (2, N // 2) if N % 2 == 0 else (1, N)
    pairs = _inputs(N, S, hd, dtype, seed=3)

    def heads(x):
        return x.reshape(B, H, *x.shape[1:])

    (jr, tr), (jk, tk), (jv, tv), (jw, tw), (ju, tu), (js, ts) = pairs
    want_out, want_state = _wkv_chunked(heads(jr), heads(jk), heads(jv),
                                        heads(jw), ju[:H], heads(js))
    out, state = ops.rwkv6_scan_by_heads(heads(tr), heads(tk), heads(tv),
                                         heads(tw), tu[:H], heads(ts))
    _close(want_out, out, 1e-3)
    _close(want_state, state, 1e-3)


def test_cpu_wrapper_takes_plain_version_and_counts_it():
    pairs = [t for _, t in _inputs(2, 5, 8, "float32")]
    launches, calls = ops.launches, ops.ref.calls
    out, state = ops.rwkv6_scan(*pairs)
    assert (ops.launches, ops.ref.calls) == (launches, calls + 1)
    want = ops.rwkv6_scan_ref(*pairs)
    torch.testing.assert_close(out, want[0], rtol=0, atol=0)
    torch.testing.assert_close(state, want[1], rtol=0, atol=0)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    r, k, v, logw, u, s0 = [t for _, t in _inputs(2, 5, 8, "float32")]
    with pytest.raises(ValueError):                 # meta checks as the card
        ops.rwkv6_scan(*(t.to("meta") for t in (r, k[:, :4], v, logw, u, s0)))
    with pytest.raises(ValueError):                       # k of another shape
        ops.rwkv6_scan(r, k[:, :4], v, logw, u, s0)
    with pytest.raises(ValueError):                       # u not (N, hd)
        ops.rwkv6_scan(r, k, v, logw, u[:1], s0)
    with pytest.raises(ValueError):                       # state0 not (N, hd, hd)
        ops.rwkv6_scan(r, k, v, logw, u, s0[:, :4])
    with pytest.raises(ValueError):                       # S = 0
        ops.rwkv6_scan(*(t[:, :0] for t in (r, k, v, logw)), u, s0)
    with pytest.raises(ValueError):                       # hd > 128
        ops.rwkv6_scan(*(torch.zeros(1, 2, 136) for _ in range(4)),
                       torch.zeros(1, 136), torch.zeros(1, 136, 136))
    with pytest.raises(TypeError):                        # r, k, v dtypes differ
        ops.rwkv6_scan(r.bfloat16(), k, v, logw, u, s0)
    with pytest.raises(TypeError):                        # f16 is not built
        ops.rwkv6_scan(r.half(), k.half(), v.half(), logw, u, s0)
    with pytest.raises(TypeError):                        # logw must be f32
        ops.rwkv6_scan(r, k, v, logw.bfloat16(), u, s0)
    with pytest.raises(TypeError):                        # state0 must be f32
        ops.rwkv6_scan(r, k, v, logw, u, s0.double())
    with pytest.raises(ValueError):                       # not contiguous
        ops.rwkv6_scan(r.transpose(1, 2).contiguous().transpose(1, 2), k, v,
                       logw, u, s0)


# the decay extremes: logw = -8 (the largest in-chunk decay, where a
# factored exponent overflows f32) and -1e-6 (no decay, a growing state),
# at an S that is not a multiple of the chunk
EXTREMES = [(lw, dtype) for lw in (-8.0, -1e-6) for dtype in DTYPES]
EXTREME_IDS = [f"logw{lw:g}-{d}" for lw, d in EXTREMES]


def _extreme_inputs(logw_value, dtype, N=2, S=70, hd=32, seed=4):
    pairs = _inputs(N, S, hd, dtype, seed=seed)
    logw = np.full((N, S, hd), logw_value, np.float32)
    pairs[3] = (jnp.asarray(logw), torch.from_numpy(logw))
    return pairs


@pytest.mark.parametrize("logw_value,dtype", EXTREMES, ids=EXTREME_IDS)
def test_plain_matches_jax_at_decay_extremes(logw_value, dtype):
    """The plain version against the JAX sequential reference and the
    Pallas kernel's chunked form in interpret mode (atol 1e-3), finite
    everywhere.  Against the sequential reference the two f32 sums of each
    read-out differ by a few units in the last place of their largest
    partial sums, not of the (possibly small) result: with no decay those
    reach |y|max ~ 60 here, so the bound is 1e-5 + 2e-6 * |y|max."""
    pairs = _extreme_inputs(logw_value, dtype)
    out, state = ops.rwkv6_scan(*(t for _, t in pairs))
    assert torch.isfinite(out).all() and torch.isfinite(state).all()
    want_out, want_state = _jax_ref(*(j for j, _ in pairs))
    for want, got in ((want_out, out), (want_state, state)):
        _close(want, got, 1e-5 + 2e-6 * float(np.abs(np.asarray(want)).max()))
    p_out, p_state = pallas_scan(*(j for j, _ in pairs), interpret=True)
    _close(p_out, out, 1e-3)
    _close(p_state, state, 1e-3)


@pytest.mark.parametrize("S,nc", [(1, 1), (32, 1), (33, 2), (131, 5),
                                  (256, 8), (4096, 128)])
def test_num_chunks_covers_S(S, nc):
    assert ops.num_chunks(S) == nc
    assert (nc - 1) * ops.CHUNK < S <= nc * ops.CHUNK


@pytest.mark.parametrize("hd,hdp", [(1, 64), (16, 64), (64, 64), (65, 128),
                                    (100, 128), (128, 128)])
def test_padded_head_dim(hd, hdp):
    assert ops.padded_head_dim(hd) == hdp


@pytest.mark.parametrize("N,S,hd,want", [
    (32, 256, 64, ((32, 8, 64, 64), (32, 8, 64))),
    (6, 33, 16, ((6, 2, 64, 64), (6, 2, 64))),
    (4, 100, 128, ((4, 4, 128, 128), (4, 4, 128))),
    (3, 45, 30, ((3, 2, 64, 64), (3, 2, 64))),
])
def test_scratch_shapes(N, S, hd, want):
    assert ops.scratch_shapes(N, S, hd) == want

