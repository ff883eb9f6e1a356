"""Port parity for flash-decode's plain version, and the wrappers' routing.

Each plain version (the path a CPU tensor takes) is held against the Pallas
kernel run with ``interpret=True`` and against the JAX ``ref.py``, in f32 and
bf16, with the tolerances of ``tests/test_kernels.py``.  The Hopper kernels
themselves run only on the card: ``chip_smoke.py`` holds them against these
plain versions there.  The flash-attention cases are in
``test_torch_kernels_flash.py``.
"""
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.kernel import \
    decode_attention as pallas_decode
from repro.kernels.decode_attention.ref import decode_attention_ref as jax_dref
from repro.models import layers as JL
from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import ops as dops
from repro_torch.kernels.flash_attention import ops as fops

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": dict(atol=3e-5, rtol=0),
       "bfloat16": dict(atol=3e-2, rtol=1e-2)}


def _inputs(shapes, dtype, seed=0):
    """The same values in both frameworks, rounded once to ``dtype``."""
    rng = np.random.default_rng(seed)
    jdt, tdt = DTYPES[dtype]
    out = []
    for shp in shapes:
        x = rng.standard_normal(shp).astype(np.float32)
        out.append((jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)))
    return out


def _close(jax_out, torch_out, dtype):
    np.testing.assert_allclose(torch_out.float().numpy(),
                               np.asarray(jax_out, np.float32), **TOL[dtype])


DECODE_CASES = [
    # B, Hq, Hkv, S, hd, kv_len
    (2, 4, 2, 64, 16, 33),
    (1, 4, 4, 96, 32, 96),
    (3, 8, 1, 40, 16, 1),
    (2, 6, 2, 40, 16, 17),       # group 3
    (1, 10, 2, 48, 16, 30),      # group 5 (qwen2.5-14b's 40/8)
    (1, 12, 1, 32, 16, 32),      # group 12 (mistral-large-123b's 96/8)
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hkv,S,hd,kvlen", DECODE_CASES)
def test_decode_plain_matches_pallas_and_ref(B, Hq, Hkv, S, hd, kvlen, dtype):
    (jq, tq), (jk, tk), (jv, tv) = _inputs(
        [(B, Hq, hd), (B, Hkv, S, hd), (B, Hkv, S, hd)], dtype)
    got = dops.decode_attention(tq, tk, tv,
                                torch.full((B,), kvlen, dtype=torch.int32))
    assert got.dtype == tq.dtype and got.shape == (B, Hq, hd)
    _close(pallas_decode(jq, jk, jv, jnp.int32(kvlen), block_k=32,
                         interpret=True), got, dtype)
    _close(jax.jit(jax_dref)(jq, jk, jv, kvlen), got, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kv_len", [[1, 17, 40], [40, 0, 9]])
def test_decode_plain_ragged_matches_layers_attention(kv_len, dtype):
    """Per-row kv_len (B,), the server's case, against the attention the
    JAX model runs in decode (full_attention with a (B,) length)."""
    B, Hq, Hkv, S, hd = 3, 4, 2, 40, 16
    (jq, tq), (jk, tk), (jv, tv) = _inputs(
        [(B, Hq, hd), (B, Hkv, S, hd), (B, Hkv, S, hd)], dtype, seed=1)
    got = dops.decode_attention(tq, tk, tv,
                                torch.tensor(kv_len, dtype=torch.int32))
    want = jax.jit(JL.attention, static_argnames="causal")(jq[:, :, None].astype(jnp.float32),
                        jk.astype(jnp.float32), jv.astype(jnp.float32),
                        causal=False, kv_len=jnp.asarray(kv_len, jnp.int32))
    _close(want[:, :, 0], got, dtype)
    if 0 in kv_len:   # no valid position: 0, as the kernel gives
        assert torch.count_nonzero(got[kv_len.index(0)]) == 0


def test_cpu_wrappers_take_plain_versions_and_count_them():
    (_, q), (_, k), (_, v) = _inputs([(2, 4, 16), (2, 2, 8, 16),
                                      (2, 2, 8, 16)], "float32")
    d_launch, d_calls = dops.launches, dops.ref.calls
    out = dops.decode_attention(q, k, v, torch.tensor([3, 8], dtype=torch.int32))
    assert (dops.launches, dops.ref.calls) == (d_launch, d_calls + 1)
    torch.testing.assert_close(
        out, dops.decode_attention_ref(q, k, v,
                                       torch.tensor([3, 8], dtype=torch.int32)),
        rtol=0, atol=0)

    (_, q), (_, k), (_, v) = _inputs([(1, 2, 6, 16), (1, 2, 6, 16),
                                      (1, 2, 6, 16)], "float32")
    f_launch, f_calls = fops.launches, fops.ref.calls
    fops.flash_attention(q, k, v)
    assert (fops.launches, fops.ref.calls) == (f_launch, f_calls + 1)


def test_wrappers_reject_what_the_kernels_do_not_take():
    (_, q), (_, k), (_, v) = _inputs([(2, 4, 16), (2, 2, 8, 16),
                                      (2, 2, 8, 16)], "float32")
    good = torch.tensor([3, 8], dtype=torch.int32)
    with pytest.raises(TypeError):
        dops.decode_attention(q, k, v, good.long())         # kv_len dtype
    with pytest.raises(TypeError):
        dops.decode_attention(q, k, v, torch.tensor([3], dtype=torch.int32))
    with pytest.raises(TypeError):
        dops.decode_attention(q.double(), k.double(), v.double(), good)
    with pytest.raises(ValueError):
        dops.decode_attention(q, k.transpose(2, 3).contiguous().transpose(2, 3),
                              v, good)                       # not contiguous
    # any group is taken, group 3 included (the kernel pads it to 4)
    q3 = torch.randn(2, 6, 16, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(
        dops.decode_attention(q3, k, v, good),
        dops.decode_attention_ref(q3, k, v, good), rtol=0, atol=0)
    with pytest.raises(ValueError):   # no kernel for this device
        dops.decode_attention(q.to("meta"), k.to("meta"), v.to("meta"),
                              good.to("meta"))
    with pytest.raises(ValueError):
        fops.flash_attention(torch.zeros(1, 2, 4, 256), torch.zeros(1, 2, 4, 256),
                             torch.zeros(1, 2, 4, 256))     # head_dim > 128
    with pytest.raises(ValueError):
        fops.flash_attention(torch.zeros(1, 2, 4, 16, device="meta"),
                             torch.zeros(1, 2, 4, 16, device="meta"),
                             torch.zeros(1, 2, 4, 16, device="meta"))


SM_COUNT = 132   # an H100 SXM's SMs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Hkv,group,S,hd,main", [
    (4, 16, 1, 512, 64, True),      # qwen1.5-0.5b decode step
    (4, 8, 8, 512, 128, True),      # jamba decode step
    (4, 8, 4, 1024, 128, True),     # minitron's heads
    (4, 8, 5, 512, 128, True),      # qwen2.5-14b's heads
    (4, 8, 12, 512, 128, True),     # mistral-large-123b's heads
    (8, 16, 1, 1024, 64, False),
    (1, 1, 1, 1, 16, False),
    (3, 2, 3, 40, 16, False),
    (1, 4, 1, 300, 128, False),
    (64, 32, 1, 4096, 64, False),   # already more blocks than two waves
])
def test_num_splits_cover_the_cache_and_fill_the_card(B, Hkv, group, S, hd,
                                                      main, dtype):
    """Each (row, KV head) takes at least one chunk, the chunks are whole key
    tiles of the kernel and cover S with none wholly past it; the main
    shapes' grids fill the 132 SMs about twice, as far as their tiles allow,
    except group 1, whose blocks take up to MHA_TILES tiles unsplit."""
    tile = dops._key_tile(group, hd, dtype)
    n = dops._num_splits(B, Hkv, group, S, SM_COUNT, tile)
    chunk = dops._chunk(S, tile, n)
    assert n >= 1 and chunk % tile == 0 and tile % 32 == 0
    assert n * chunk >= S and (n - 1) * chunk < S
    groups = B * Hkv * -(-group // 16)
    blocks = groups * n
    if group == 1:
        assert n == -(-S // (tile * dops.MHA_TILES))
    elif main:
        assert min(1.5 * SM_COUNT, groups * -(-S // tile)) <= blocks
        assert blocks <= 3 * SM_COUNT
    elif groups >= dops.WAVES * SM_COUNT:
        assert n == 1


def test_import_builds_nothing_and_missing_nvcc_raises(monkeypatch, tmp_path):
    """Importing the package compiles nothing; without nvcc a build raises
    with a clear message instead of continuing."""
    assert _build.sources() == ["decode_attention", "flash_attention",
                                "flash_attention_bwd", "rwkv6_scan",
                                "rwkv6_scan_bwd", "ssm_scan", "ssm_scan_bwd"]
    assert not _build._FNS
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "CUDA_HOME", tmp_path / "no-cuda")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(["decode_attention"])
    assert not (tmp_path / "build").exists()


def test_an_edited_header_renames_every_target(monkeypatch, tmp_path):
    """The build's target name hashes the source, every ``csrc/*.cuh`` and
    the flags: a changed header's bytes give every source a new target, so
    a library built against the old header is never reused."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    names = _build.sources()
    before = {n: _build.target(n) for n in names}
    assert before == {n: _build.target(n) for n in names}      # stable
    assert len(set(before.values())) == len(names)
    header = csrc / "hopper.cuh"
    original = header.read_bytes()
    header.write_bytes(original + b"// edited\n")
    after = {n: _build.target(n) for n in names}
    assert all(after[n] != before[n] for n in names)
    assert all(after[n].name.startswith(f"{n}-") for n in names)
    header.write_bytes(original)
    assert {n: _build.target(n) for n in names} == before
