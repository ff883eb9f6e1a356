"""Port parity for the Mamba selective scan's plain version, and its
wrapper's routing.

The plain version (the path a CPU tensor takes) is held against the JAX
sequential ``ssm_scan_ref``, the Pallas kernel run with ``interpret=True``
and the model's chunked twin ``selective_scan_chunked``, at atol 1e-3 (the
reference's own, ``tests/test_kernels.py``), at ``test_kernels.py``'s three
shapes plus one step from a carried state (S = 1, the decode shape).  u, B,
C are f32 or bf16 (the same bf16 values in both frameworks); dt, A_log, D and
h0 are f32.  The Hopper kernel itself runs only on the card:
``chip_smoke.py`` holds it against this plain version there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssm_scan.kernel import ssm_scan as pallas_scan
from repro.kernels.ssm_scan.ref import ssm_scan_ref as jax_ref
from repro.models.ssm import selective_scan_chunked
from repro_torch.kernels.ssm_scan import ops

ATOL = 1e-3
# (Bz, S, di, ds): test_kernels.py's shapes, then one decode step
SHAPES = [(2, 64, 128, 16), (1, 100, 64, 8), (2, 37, 256, 16), (3, 1, 64, 16)]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
CASES = [(shape, dtype) for shape in SHAPES for dtype in DTYPES]
IDS = [f"{'x'.join(map(str, s))}-{d}" for s, d in CASES]

_jax_ref = jax.jit(jax_ref)
_chunked = jax.jit(selective_scan_chunked, static_argnames="chunk")


def _inputs(Bz, S, di, ds, dtype, seed=1):
    """(jax, torch) pairs of u, dt, A_log, B, C, D, h0, drawn as in
    tests/test_kernels.py; u, B, C in ``dtype``, the rest f32."""
    rng = np.random.default_rng(seed)
    jdt, tdt = DTYPES[dtype]
    u = rng.standard_normal((Bz, S, di)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((Bz, S, di)) - 1)).astype(np.float32)
    A = np.log(np.tile(np.arange(1, ds + 1, dtype=np.float32)[None], (di, 1)))
    B = rng.standard_normal((Bz, S, ds)).astype(np.float32)
    C = rng.standard_normal((Bz, S, ds)).astype(np.float32)
    D = rng.standard_normal((di,)).astype(np.float32)
    h0 = (rng.standard_normal((Bz, di, ds)) * 0.1).astype(np.float32)
    low = {0, 3, 4}                      # u, B, C
    return [(jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)) if i in low
            else (jnp.asarray(x), torch.from_numpy(x))
            for i, x in enumerate((u, dt, A, B, C, D, h0))]


def _close(jax_out, torch_out, atol=ATOL):
    np.testing.assert_allclose(torch_out.numpy(), np.asarray(jax_out),
                               atol=atol, rtol=0)


def _run(pairs):
    y, h = ops.ssm_scan(*(t for _, t in pairs))
    assert y.dtype == h.dtype == torch.float32
    return y, h


@pytest.mark.parametrize("shape,dtype", CASES, ids=IDS)
def test_plain_matches_jax_ref(shape, dtype):
    pairs = _inputs(*shape, dtype)
    y, h = _run(pairs)
    Bz, S, di, ds = shape
    assert y.shape == (Bz, S, di) and h.shape == (Bz, di, ds)
    want_y, want_h = _jax_ref(*(j for j, _ in pairs))
    _close(want_y, y)
    _close(want_h, h)


@pytest.mark.parametrize("shape,dtype", CASES, ids=IDS)
def test_plain_matches_pallas_interpret(shape, dtype):
    pairs = _inputs(*shape, dtype, seed=2)
    y, h = _run(pairs)
    want_y, want_h = pallas_scan(*(j for j, _ in pairs), block_di=64,
                                 interpret=True)
    _close(want_y, y)
    _close(want_h, h)


@pytest.mark.parametrize("shape,dtype", CASES, ids=IDS)
def test_plain_matches_selective_scan_chunked(shape, dtype):
    """The sequential form against the chunked associative scan the JAX
    model runs (test_kernels.py holds the two JAX forms to the same 1e-3)."""
    pairs = _inputs(*shape, dtype, seed=3)
    y, h = _run(pairs)
    u, dt, A, B, C, D, h0 = (j for j, _ in pairs)
    want_y, want_h = _chunked(u, dt, A, B, C, D, h0=h0, chunk=16)
    _close(want_y, y)
    _close(want_h, h)


def test_cpu_wrapper_takes_plain_version_and_counts_it():
    args = [t for _, t in _inputs(2, 5, 8, 8, "float32")]
    launches, calls = ops.launches, ops.ref.calls
    y, h = ops.ssm_scan(*args)
    assert (ops.launches, ops.ref.calls) == (launches, calls + 1)
    want = ops.ssm_scan_ref(*args)
    torch.testing.assert_close(y, want[0], rtol=0, atol=0)
    torch.testing.assert_close(h, want[1], rtol=0, atol=0)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    u, dt, A, B, C, D, h0 = [t for _, t in _inputs(2, 5, 8, 8, "float32")]
    with pytest.raises(ValueError):                 # meta checks as the card
        ops.ssm_scan(*(t.to("meta") for t in (u, dt[:, :4], A, B, C, D, h0)))
    with pytest.raises(ValueError):                       # dt of another shape
        ops.ssm_scan(u, dt[:, :4], A, B, C, D, h0)
    with pytest.raises(ValueError):                       # S = 0
        ops.ssm_scan(u[:, :0], dt[:, :0], A, B[:, :0], C[:, :0], D, h0)
    with pytest.raises(ValueError):                       # A_log rows != di
        ops.ssm_scan(u, dt, A[:4], B, C, D, h0)
    with pytest.raises(ValueError):                       # d_state 4 not built
        ops.ssm_scan(u, dt, A[:, :4], B[..., :4], C[..., :4], D,
                     h0[..., :4].contiguous())
    with pytest.raises(ValueError):                       # C of another shape
        ops.ssm_scan(u, dt, A, B, C[:, :4], D, h0)
    with pytest.raises(ValueError):                       # D not (di,)
        ops.ssm_scan(u, dt, A, B, C, D[:4], h0)
    with pytest.raises(ValueError):                       # h0 not (Bz, di, ds)
        ops.ssm_scan(u, dt, A, B, C, D, h0[:1])
    with pytest.raises(TypeError):                        # u, B dtypes differ
        ops.ssm_scan(u.bfloat16(), dt, A, B, C, D, h0)
    with pytest.raises(TypeError):                        # f16 is not built
        ops.ssm_scan(u.half(), dt, A, B.half(), C.half(), D, h0)
    with pytest.raises(TypeError):                        # dt must be f32
        ops.ssm_scan(u, dt.bfloat16(), A, B, C, D, h0)
    with pytest.raises(TypeError):                        # h0 must be f32
        ops.ssm_scan(u, dt, A, B, C, D, h0.double())
    with pytest.raises(ValueError):                       # not contiguous
        ops.ssm_scan(u.transpose(1, 2).contiguous().transpose(1, 2), dt, A,
                     B, C, D, h0)


INPLACE = [(shape, dtype) for shape in ((3, 1, 64, 16), (2, 37, 256, 16),
                                        (1, 100, 64, 8)) for dtype in DTYPES]
INPLACE_IDS = [f"{'x'.join(map(str, s))}-{d}" for s, d in INPLACE]


@pytest.mark.parametrize("shape,dtype", INPLACE, ids=INPLACE_IDS)
def test_h_out_in_place_equals_out_of_place_and_jax(shape, dtype):
    """h_out = h0: the state is updated in place, the same values as the
    out-of-place call, within the reference's tolerance of the JAX ref."""
    pairs = _inputs(*shape, dtype, seed=5)
    args = [t for _, t in pairs]
    y, h = ops.ssm_scan(*args)
    h0 = args[6].clone()
    y2, h2 = ops.ssm_scan(*args[:6], h0, h_out=h0)
    assert h2 is h0
    torch.testing.assert_close(y2, y, rtol=0, atol=0)
    torch.testing.assert_close(h0, h, rtol=0, atol=0)
    want_y, want_h = _jax_ref(*(j for j, _ in pairs))
    _close(want_y, y2)
    _close(want_h, h0)


def test_h_out_of_its_own_is_written_and_h0_kept():
    args = [t for _, t in _inputs(2, 9, 16, 8, "float32", seed=6)]
    h0 = args[6].clone()
    out = torch.full_like(h0, float("nan"))
    y, h = ops.ssm_scan(*args[:6], h0, h_out=out)
    assert h is out
    torch.testing.assert_close(h0, args[6], rtol=0, atol=0)
    want_y, want_h = ops.ssm_scan(*args)
    torch.testing.assert_close(y, want_y, rtol=0, atol=0)
    torch.testing.assert_close(out, want_h, rtol=0, atol=0)


def test_wrapper_rejects_a_wrong_h_out():
    args = [t for _, t in _inputs(2, 5, 8, 8, "float32")]
    h0 = args[6]
    bad = {"shape": torch.zeros(2, 8, 16),
           "dtype": torch.zeros_like(h0, dtype=torch.bfloat16),
           "device": torch.zeros_like(h0, device="meta"),
           "strides": torch.zeros(2, 8, 8).transpose(1, 2),
           "overlap": torch.zeros(2 * 8 * 8 + 8)[8:].view(2, 8, 8)}
    base = bad["overlap"]._base
    base[:2 * 8 * 8].copy_(h0.reshape(-1))
    overlap_args = args[:6] + [base[:2 * 8 * 8].view(2, 8, 8)]
    for what, h_out in bad.items():
        call = overlap_args if what == "overlap" else args
        with pytest.raises(ValueError, match="h_out"):
            ops.ssm_scan(*call, h_out=h_out)
