"""Port parity: repro_torch.models.layers against repro.models.layers.

Every input is made with NumPy from a seed and fed to both functions; f32
results agree to 1e-5.
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.models import layers as TL

ATOL = 1e-5


def _jit(fn, **static):
    """One XLA compile for the whole reference function (eager JAX compiles
    op by op, which dominates these small tests)."""
    return jax.jit(functools.partial(fn, **static))


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _close(jax_out, torch_out, atol=ATOL):
    np.testing.assert_allclose(torch_out.float().numpy(),
                               np.asarray(jax_out, np.float32), atol=atol,
                               rtol=0)


def _both(tree):
    """(jax tree, torch tree) of one NumPy tree."""
    if isinstance(tree, dict):
        pairs = {k: _both(v) for k, v in tree.items()}
        return ({k: a for k, (a, _) in pairs.items()},
                {k: b for k, (_, b) in pairs.items()})
    return jnp.asarray(tree), torch.from_numpy(tree.copy())


def test_dtype_of():
    assert TL.dtype_of("float32") is torch.float32
    assert TL.dtype_of("bfloat16") is torch.bfloat16
    assert TL.dtype_of("float16") is torch.float16


@pytest.mark.parametrize("bias", [False, True])
def test_linear(bias):
    p = {"w": _rand(16, 24, seed=1)}
    if bias:
        p["b"] = _rand(24, seed=2)
    x = _rand(3, 5, 16, seed=3)
    jp, tp = _both(p)
    _close(JL.linear(jp, jnp.asarray(x), jnp.float32),
           TL.linear(tp, torch.from_numpy(x), torch.float32))


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_apply_norm(kind):
    p = {"scale": _rand(32, seed=1)}
    if kind == "layernorm":
        p["bias"] = _rand(32, seed=2)
    x = _rand(2, 7, 32, seed=3, scale=3.0) + 0.5
    jp, tp = _both(p)
    _close(_jit(JL.apply_norm, eps=1e-5)(jp, jnp.asarray(x)),
           TL.apply_norm(tp, torch.from_numpy(x), 1e-5))


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope_freqs(theta):
    _close(JL.rope_freqs(64, theta), TL.rope_freqs(64, theta), atol=1e-7)


def test_apply_rope_per_row_positions():
    x = _rand(3, 1, 4, 16, seed=1)                  # (B, S, H, hd)
    pos = np.array([0, 7, 123], np.int32).reshape(3, 1)
    _close(_jit(JL.apply_rope, theta=10_000.0)(jnp.asarray(x), jnp.asarray(pos)),
           TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10_000.0))


def test_apply_rope_sequence_positions():
    x = _rand(2, 9, 2, 32, seed=2)
    pos = np.arange(9)[None, :]
    _close(_jit(JL.apply_rope, theta=10_000.0)(jnp.asarray(x), jnp.asarray(pos)),
           TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10_000.0))


def _qkv(B, Hq, Hkv, Sq, Sk, hd, seed=0):
    return (_rand(B, Hq, Sq, hd, seed=seed), _rand(B, Hkv, Sk, hd, seed=seed + 1),
            _rand(B, Hkv, Sk, hd, seed=seed + 2))


ATTN_CASES = [
    # B, Hq, Hkv, Sq, Sk, causal, q_offset, kv_len
    (2, 4, 2, 12, 12, True, 0, None),
    (2, 4, 4, 5, 13, True, 8, None),
    (1, 2, 1, 6, 10, False, 0, None),
    (3, 4, 2, 1, 16, False, 0, [1, 9, 16]),
    (2, 4, 2, 3, 11, False, 0, [0, 7]),
]


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,causal,off,kv_len", ATTN_CASES)
def test_full_attention(B, Hq, Hkv, Sq, Sk, causal, off, kv_len):
    q, k, v = _qkv(B, Hq, Hkv, Sq, Sk, 16)
    jkl = None if kv_len is None else jnp.asarray(kv_len, jnp.int32)
    tkl = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32)
    want = _jit(JL.full_attention, causal=causal, q_offset=off)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kv_len=jkl)
    got = TL.full_attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), causal=causal, q_offset=off,
                            kv_len=tkl)
    _close(want, got)


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,causal,off,kv_len", ATTN_CASES)
def test_chunked_attention(B, Hq, Hkv, Sq, Sk, causal, off, kv_len):
    """Small chunks so every case runs several ragged key chunks."""
    q, k, v = _qkv(B, Hq, Hkv, Sq, Sk, 16, seed=4)
    jkl = None if kv_len is None else jnp.asarray(kv_len, jnp.int32)
    tkl = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32)
    kw = dict(causal=causal, q_offset=off, chunk_q=4, chunk_k=5)
    want = _jit(JL.chunked_attention, **kw)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kv_len=jkl)
    got = TL.chunked_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), kv_len=tkl, **kw)
    _close(want, got)


@pytest.mark.parametrize("Sq,Sk", [(4, 8), (40, 40)])
def test_attention_dispatch(Sq, Sk):
    """Threshold 4 sends both shapes to the chunked path, threshold 64 to the
    full one; each agrees with the reference dispatch."""
    q, k, v = _qkv(1, 2, 2, Sq, Sk, 8, seed=7)
    for thr in (4, 64):
        want = _jit(JL.attention, causal=False, chunked_threshold=thr)(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        got = TL.attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), causal=False,
                           chunked_threshold=thr)
        _close(want, got)


@pytest.mark.parametrize("act", ["swiglu", "gelu", "relu2"])
def test_apply_ffn(act):
    p = {"w_up": {"w": _rand(16, 40, seed=1, scale=0.3)},
         "w_down": {"w": _rand(40, 16, seed=2, scale=0.3)}}
    if act == "swiglu":
        p["w_gate"] = {"w": _rand(16, 40, seed=3, scale=0.3)}
    x = _rand(2, 3, 16, seed=4)
    jp, tp = _both(p)
    _close(_jit(JL.apply_ffn, act=act, compute_dtype=jnp.float32)(
               jp, jnp.asarray(x)),
           TL.apply_ffn(tp, torch.from_numpy(x), act, torch.float32))


def test_embed():
    table = _rand(50, 8, seed=1)
    toks = np.array([[0, 3, 49], [7, 7, 1]], np.int32)
    _close(JL.embed({"table": jnp.asarray(table)}, jnp.asarray(toks),
                    jnp.float32),
           TL.embed({"table": torch.from_numpy(table)},
                    torch.from_numpy(toks), torch.float32), atol=0)


@pytest.mark.parametrize("softcap", [0.0, 5.0])
def test_tied_head(softcap):
    table = _rand(50, 16, seed=1)
    x = _rand(2, 3, 16, seed=2, scale=2.0)
    _close(JL.logits_from_embedding({"table": jnp.asarray(table)},
                                    jnp.asarray(x), softcap, jnp.float32),
           TL.logits_from_embedding({"table": torch.from_numpy(table)},
                                    torch.from_numpy(x), softcap,
                                    torch.float32))


def test_init_scales():
    """Same distributions and scales as the reference initialisers."""
    gen = torch.Generator().manual_seed(0)
    lin = TL.init_linear(gen, 256, 512, torch.float32, bias=True)
    assert lin["w"].shape == (256, 512) and lin["w"].dtype == torch.float32
    assert abs(lin["w"].std().item() - 1 / math.sqrt(256)) < 2e-3
    assert torch.count_nonzero(lin["b"]) == 0
    emb = TL.init_embedding(gen, 1000, 64, torch.bfloat16)["table"]
    assert emb.dtype == torch.bfloat16
    assert abs(emb.float().std().item() - 0.02) < 1e-3
    norm = TL.init_norm(8, "layernorm", torch.float32)
    assert torch.equal(norm["scale"], torch.ones(8))
    assert torch.equal(norm["bias"], torch.zeros(8))
    assert "bias" not in TL.init_norm(8, "rmsnorm", torch.float32)
    ffn = TL.init_ffn(gen, 8, 16, "swiglu", torch.float32)
    assert set(ffn) == {"w_up", "w_down", "w_gate"}
    assert set(TL.init_ffn(gen, 8, 16, "relu2", torch.float32)) == \
        {"w_up", "w_down"}
