"""Port parity for the Mamba mixer: repro_torch.models.ssm against
repro.models.ssm.

The JAX params of the jamba smoke config's Mamba mixer (f32: d_model 64,
d_inner 128, d_state 8, d_conv 4) are converted key for key; the causal conv
and ``apply_ssm`` in train, prefill and decode mode, caches included, agree
with JAX to 2e-3 (``tests/test_models.py``).  The port's scan is the
``ssm_scan`` op (its plain version here); the JAX model's is
``selective_scan_chunked``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.config import get_arch as jax_get_arch
from repro.models import ssm as JS
from repro_torch.convert import params_from_jax
from repro_torch.core import config as tconfig
from repro_torch.kernels.ssm_scan import ops as sops
from repro_torch.models import ssm as TS

ARCH = "jamba-1.5-large-398b"
ATOL = 2e-3
B, T = 2, 12


def _f32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32",
                               compute_dtype="float32")


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _close(jax_out, torch_out, atol=ATOL):
    np.testing.assert_allclose(torch_out.numpy(), np.asarray(jax_out),
                               atol=atol, rtol=0)


class Mixer:
    def __init__(self):
        self.jcfg = _f32(jax_get_arch(ARCH).smoke)
        self.tcfg = _f32(tconfig.get_arch(ARCH).smoke)
        self.jp = jax.jit(JS.init_ssm, static_argnums=1)(jax.random.key(3),
                                                          self.jcfg)
        self.tp = params_from_jax(_np_tree(self.jp), "cpu")
        rng = np.random.default_rng(7)
        cfg = self.jcfg
        di, s = JS.d_inner_of(cfg), cfg.ssm
        self.x = rng.standard_normal((B, T, cfg.d_model)).astype(np.float32)
        self.cache = {
            "conv": rng.standard_normal((B, s.d_conv - 1, di)).astype(np.float32),
            "state": (rng.standard_normal((B, di, s.d_state)) * 0.3
                      ).astype(np.float32)}


@pytest.fixture(scope="module")
def mixer():
    return Mixer()


@pytest.mark.parametrize("with_prev", [False, True])
@pytest.mark.parametrize("S", [1, T])
def test_causal_conv_matches_jax(mixer, with_prev, S):
    x = mixer.x[:, :S]
    w = np.array(mixer.jp["conv_w"])
    b = np.random.default_rng(1).standard_normal(w.shape[1]).astype(np.float32)
    x = np.concatenate([x, x], axis=-1)               # d_inner wide
    prev = mixer.cache["conv"] if with_prev else None
    want = JS._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                           None if prev is None else jnp.asarray(prev))
    got = TS._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                          torch.from_numpy(b),
                          None if prev is None else torch.from_numpy(prev))
    _close(want, got, 1e-6)


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_apply_ssm_matches_jax(mixer, mode):
    x = mixer.x[:, :1] if mode == "decode" else mixer.x
    jcache = {k: jnp.asarray(v) for k, v in mixer.cache.items()} \
        if mode == "decode" else None
    tcache = {k: torch.from_numpy(v.copy()) for k, v in mixer.cache.items()} \
        if mode == "decode" else None
    cfg = mixer.jcfg
    jy, jc = jax.jit(lambda p, x, c: JS.apply_ssm(
        p, x, cfg, mode=mode, cache=c))(mixer.jp, jnp.asarray(x), jcache)
    calls = sops.ref.calls
    ty, tc = TS.apply_ssm(mixer.tp, torch.from_numpy(x), mixer.tcfg,
                          mode=mode, cache=tcache)
    # every mode's scan goes through the op (here its plain version)
    assert sops.ref.calls == calls + 1
    _close(jy, ty)
    if mode == "train":
        assert jc is None and tc is None
        return
    assert set(tc) == set(jc) == {"conv", "state"}
    for k in jc:
        assert tc[k].dtype == torch.float32
        _close(jc[k], tc[k])
    if mode == "decode":      # written into the cache in place
        assert all(tc[k] is tcache[k] for k in tc)


def test_prefill_shorter_than_the_conv_window_pads_its_cache(mixer):
    """A 2-token prompt leaves a conv window of one zero row and its two
    inputs, as the reference pads it."""
    cfg = mixer.jcfg
    x = mixer.x[:, :2]
    _, jc = jax.jit(lambda p, x: JS.apply_ssm(p, x, cfg, mode="prefill"))(
        mixer.jp, jnp.asarray(x))
    _, tc = TS.apply_ssm(mixer.tp, torch.from_numpy(x), mixer.tcfg,
                         mode="prefill")
    assert not tc["conv"][:, 0].any()
    _close(jc["conv"], tc["conv"])
    _close(jc["state"], tc["state"])


def test_decode_takes_one_token_and_a_cache(mixer):
    x = torch.from_numpy(mixer.x)
    with pytest.raises(ValueError, match="one token"):
        TS.apply_ssm(mixer.tp, x[:, :1], mixer.tcfg, mode="decode")
    cache = {k: torch.from_numpy(v.copy()) for k, v in mixer.cache.items()}
    with pytest.raises(ValueError, match="one token"):
        TS.apply_ssm(mixer.tp, x, mixer.tcfg, mode="decode", cache=cache)


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_init_and_cache_spec_match_jax(param_dtype):
    """The port's own init builds the reference's tree, shapes and dtypes
    (A_log and D f32 in a bf16 tree), with the same A_log, D and conv_b;
    the cache spec is the reference's."""
    jcfg = dataclasses.replace(jax_get_arch(ARCH).smoke, param_dtype=param_dtype)
    tcfg = dataclasses.replace(tconfig.get_arch(ARCH).smoke,
                               param_dtype=param_dtype)
    jp = JS.init_ssm(jax.random.key(0), jcfg)
    tp = TS.init_ssm(torch.Generator().manual_seed(0), tcfg)
    jleaves = jax.tree_util.tree_leaves_with_path(jp)
    tleaves = jax.tree_util.tree_leaves_with_path(tp)
    assert [p for p, _ in jleaves] == [p for p, _ in tleaves]
    for (_, a), (_, b) in zip(jleaves, tleaves):
        assert tuple(a.shape) == tuple(b.shape)
        assert str(b.dtype).removeprefix("torch.") == a.dtype.name
    assert tp["A_log"].dtype == tp["D"].dtype == torch.float32
    for k in ("A_log", "D", "conv_b"):   # log of 1..ds: to an ulp
        _close(np.asarray(jp[k], np.float32), tp[k].float(), 1e-6)
    dt_bias = tp["dt_proj"]["b"].float()
    # softplus of the bias lies in the reference's [1e-3, 1e-1]
    dt = torch.nn.functional.softplus(dt_bias)
    assert float(dt.min()) >= 1e-3 * 0.99 and float(dt.max()) <= 0.1 * 1.01
    jspec, tspec = JS.ssm_cache_spec(jcfg, 3), TS.ssm_cache_spec(tcfg, 3)
    for k in ("conv", "state"):
        assert tuple(jspec[k].shape) == tspec[k].shape
        assert tspec[k].dtype == torch.float32


def test_decode_steps_update_the_state_in_place_as_jax(mixer):
    """Three decode steps: the op writes the cached state in place (the same
    tensor, no copy), and every step's output and cache equal the JAX
    twin's."""
    cfg = mixer.jcfg
    step = jax.jit(lambda p, x, c: JS.apply_ssm(p, x, cfg, mode="decode",
                                                cache=c))
    jcache = {k: jnp.asarray(v) for k, v in mixer.cache.items()}
    tcache = {k: torch.from_numpy(v.copy()) for k, v in mixer.cache.items()}
    state = tcache["state"]
    for t in range(3):
        x = mixer.x[:, t:t + 1]
        jy, jcache = step(mixer.jp, jnp.asarray(x), jcache)
        ty, tc = TS.apply_ssm(mixer.tp, torch.from_numpy(x), mixer.tcfg,
                              mode="decode", cache=tcache)
        assert tc["state"] is state
        _close(jy, ty)
        for k in jcache:
            _close(jcache[k], tc[k])
