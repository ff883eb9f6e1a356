"""Port parity for the model path: repro_torch.models against repro.models.

The JAX params of the qwen1.5 (MHA, tied head, QKV bias), minitron (GQA
group 2, layernorm, relu², untied head), qwen2.5 (GQA, QKV bias, untied
head, rope_theta 1e6 at full size) and mistral-large (GQA, untied head)
smoke configs are converted key for key; forward, prefill and per-slot
decode agree with JAX well inside the reference's own 2e-3
(``tests/test_models.py``).  Each arch's JAX functions
compile once per module.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.config import get_arch as jax_get_arch
from repro.core.config import list_archs as jax_list_archs
from repro.models import api as japi
from repro_torch.convert import params_from_jax
from repro_torch.core import config as tconfig
from repro_torch.models import api as tapi
from repro_torch.models import attention as tatt

ARCHS = ["qwen1.5-0.5b", "minitron-8b", "qwen2.5-14b",
         "mistral-large-123b"]
# every arch the port registers (rwkv6's parity tests: test_torch_rwkv6.py;
# jamba's: test_torch_jamba.py; granite-moe's: test_torch_moe.py;
# dilated-vgg's: test_torch_dilated_vgg.py; deepseek-v2's: test_torch_mla.py;
# internvl2's: test_torch_vlm.py; seamless-m4t's: test_torch_encdec.py)
PORTED_ARCHS = ARCHS + ["rwkv6-1.6b", "jamba-1.5-large-398b",
                        "granite-moe-1b-a400m", "dilated-vgg",
                        "deepseek-v2-236b", "internvl2-2b",
                        "seamless-m4t-large-v2"]
ATOL = 1e-4          # the reference's own bound is 2e-3 (test_models.py)
B, T, MAX_LEN = 2, 12, 16


def _f32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32",
                               compute_dtype="float32")


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


class Pair:
    """One arch's JAX reference (jitted once) and its port twin."""

    def __init__(self, arch):
        self.jcfg = _f32(jax_get_arch(arch).smoke)
        self.tcfg = _f32(tconfig.get_arch(arch).smoke)
        self.jp = japi.init_params(jax.random.key(1), self.jcfg)
        self.tp = params_from_jax(_np_tree(self.jp), "cpu")
        cfg = self.jcfg
        self.j_forward = jax.jit(lambda p, t: japi.forward(
            p, cfg, {"tokens": t}, mode="train", remat="none")[0])
        self.j_prefill = jax.jit(lambda p, t: japi.prefill(
            p, cfg, {"tokens": t}))
        self.j_decode = jax.jit(lambda p, s, t, pos: japi.decode_step(
            p, cfg, s, t, pos))
        self.tokens = np.random.default_rng(0).integers(
            0, cfg.vocab_size, (B, T)).astype(np.int32)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return Pair(request.param)


def _close(jax_out, torch_out, atol=ATOL):
    np.testing.assert_allclose(torch_out.numpy(), np.asarray(jax_out),
                               atol=atol, rtol=0)


def test_configs_are_copies():
    for arch in PORTED_ARCHS:
        j, t = jax_get_arch(arch), tconfig.get_arch(arch)
        for jc, tc in ((j.model, t.model), (j.smoke, t.smoke)):
            assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
        assert (j.shapes, j.skip_shapes, j.source) == \
            (t.shapes, t.skip_shapes, t.source)
    assert tconfig.list_archs() == sorted(PORTED_ARCHS)
    # every arch of the reference is ported
    assert tconfig.list_archs() == jax_list_archs()


def test_params_convert_key_for_key(pair):
    jleaves = jax.tree_util.tree_leaves_with_path(pair.jp)
    tleaves = jax.tree_util.tree_leaves_with_path(pair.tp)
    assert [p for p, _ in jleaves] == [p for p, _ in tleaves]
    for (_, a), (_, b) in zip(jleaves, tleaves):
        assert tuple(a.shape) == tuple(b.shape) and b.dtype == torch.float32
    # the port's own init builds the same tree
    own = tapi.init_params(torch.Generator().manual_seed(0), pair.tcfg)
    assert [p for p, _ in jax.tree_util.tree_leaves_with_path(own)] == \
        [p for p, _ in tleaves]


def test_params_convert_bfloat16_leaves():
    x = jnp.asarray(np.linspace(-3, 3, 12).reshape(3, 4), jnp.bfloat16)
    t = params_from_jax({"a": {"w": x}}, "cpu")["a"]["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), np.asarray(x, np.float32))
    assert params_from_jax({"w": x}, "cpu", torch.float32)["w"].dtype == \
        torch.float32


def test_forward_matches_jax(pair):
    want = pair.j_forward(pair.jp, jnp.asarray(pair.tokens))
    got, aux = tapi.forward(pair.tp, pair.tcfg,
                            {"tokens": torch.from_numpy(pair.tokens)})
    assert got.shape == (B, T, pair.tcfg.vocab_size) and float(aux) == 0.0
    _close(want, got)


def test_prefill_matches_jax(pair):
    want, jcache = pair.j_prefill(pair.jp, jnp.asarray(pair.tokens))
    got, tcache = tapi.prefill(pair.tp, pair.tcfg,
                               {"tokens": torch.from_numpy(pair.tokens)})
    _close(want, got)
    for kv in ("k", "v"):
        _close(jcache["periods"]["sub0"]["attn"][kv],
               tcache["periods"]["sub0"]["attn"][kv])


def test_ragged_decode_matches_jax(pair):
    """Slots at different depths decode with a per-slot pos vector; logits
    and the whole cache agree with JAX at every step."""
    jstate = japi.allocate_decode_state(pair.jcfg, B, MAX_LEN)
    tstate = tapi.allocate_decode_state(pair.tcfg, B, MAX_LEN, "cpu")
    pos = np.array([0, 5], np.int32)
    for i in range(6):
        toks = pair.tokens[:, i]
        jl, jstate = pair.j_decode(pair.jp, jstate, jnp.asarray(toks),
                                   jnp.asarray(pos))
        tl, tstate2 = tapi.decode_step(pair.tp, pair.tcfg, tstate,
                                       torch.from_numpy(toks),
                                       torch.from_numpy(pos))
        assert tstate2 is tstate                       # written in place
        _close(jl, tl)
        pos += 1
    jax.tree.map(lambda a, b: _close(a, b), _np_tree(jstate), tstate)


def test_decode_state_spec_matches_jax(pair):
    jspec = japi.init_decode_state(pair.jcfg, 3, 20)
    tspec = tapi.init_decode_state(pair.tcfg, 3, 20)
    for kv in ("k", "v"):
        j = jspec["periods"]["sub0"]["attn"][kv]
        t = tspec["periods"]["sub0"]["attn"][kv]
        assert tuple(j.shape) == t.shape and t.dtype == torch.float32
        assert isinstance(t, tatt.TensorSpec)


@pytest.mark.parametrize("last", [MAX_LEN - 1, MAX_LEN + 3])
def test_cache_write_at_the_end_is_clamped_like_jax(pair, last):
    """Row 1 writes at max_len - 1 (the server's last step) or past the end,
    where the reference's dynamic_update_slice clamps the index."""
    rng = np.random.default_rng(3)
    jstate = jax.tree.map(
        lambda s: jnp.asarray(rng.standard_normal(s.shape), s.dtype),
        japi.init_decode_state(pair.jcfg, B, MAX_LEN))
    tstate = params_from_jax(_np_tree(jstate), "cpu")
    pos = np.array([3, last], np.int32)
    toks = pair.tokens[:, 0]
    jl, jstate = pair.j_decode(pair.jp, jstate, jnp.asarray(toks),
                               jnp.asarray(pos))
    tl, tstate = tapi.decode_step(pair.tp, pair.tcfg, tstate,
                                  torch.from_numpy(toks), torch.from_numpy(pos))
    _close(jl, tl)
    jax.tree.map(lambda a, b: _close(a, b), _np_tree(jstate), tstate)
