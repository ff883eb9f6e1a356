"""Port parity for the flash-attention forward's plain version.

The plain version (the path a CPU tensor takes) is held against the Pallas
kernel run with ``interpret=True`` and against the JAX ``ref.py``, in f32 and
bf16, with the tolerances of ``tests/test_kernels.py``.
"""
import jax
import pytest

from repro.kernels.flash_attention.kernel import flash_attention as pallas_flash
from repro.kernels.flash_attention.ref import attention_ref as jax_fref
from repro_torch.kernels.flash_attention import ops as fops
from test_torch_kernels import _close, _inputs


FLASH_CASES = [
    # B, Hq, Hkv, Sq, Sk, hd, causal, q_offset
    (2, 4, 2, 40, 40, 16, True, 0),      # causal, GQA
    (1, 4, 4, 33, 33, 32, True, 0),      # causal, ragged tile
    (2, 4, 1, 24, 56, 16, False, 0),     # non-causal, Sq != Sk, GQA
    (1, 2, 2, 20, 52, 16, True, 32),     # causal with q_offset
    (1, 4, 2, 70, 70, 128, True, 0),     # hd 128, GQA, Sq past a 64-row tile
    (2, 4, 4, 6, 12, 16, False, 0),      # enc-dec cross-attention, Sq < Sk
    (2, 4, 4, 12, 12, 16, False, 0),     # enc-dec encoder, Sq = Sk
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,hd,causal,off", FLASH_CASES)
def test_flash_plain_matches_pallas_and_ref(B, Hq, Hkv, Sq, Sk, hd, causal,
                                            off, dtype):
    (jq, tq), (jk, tk), (jv, tv) = _inputs(
        [(B, Hq, Sq, hd), (B, Hkv, Sk, hd), (B, Hkv, Sk, hd)], dtype, seed=2)
    got = fops.flash_attention(tq, tk, tv, causal=causal, q_offset=off)
    assert got.dtype == tq.dtype and got.shape == (B, Hq, Sq, hd)
    _close(pallas_flash(jq, jk, jv, causal=causal, q_offset=off, block_q=32,
                        block_k=32, interpret=True), got, dtype)
    _close(jax.jit(jax_fref, static_argnames=("causal", "q_offset"))(
        jq, jk, jv, causal=causal, q_offset=off), got, dtype)
