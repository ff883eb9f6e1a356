"""RWKV-6 ("Finch", arXiv:2404.05892) time-mix and channel-mix blocks
(PyTorch twin of ``repro.models.rwkv6``).

Attention-free: the WKV recurrence keeps a per-head (d_k x d_v) state with
*data-dependent per-channel decay*.  A sequence (train, prefill) goes
through the ``rwkv6_scan`` op: the Hopper kernel on the card, its plain
sequential version on the CPU.  One decode token uses the closed form in
plain PyTorch, as the reference computes it outside any kernel.

Cache layout (decode), per layer:
  {"shift_t": (B, D) f32, "shift_c": (B, D) f32, "wkv": (B, H, dk, dv) f32}
Decode writes the new state into the cache **in place** and returns the same
tensors; prefill returns a new state.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.config import ModelConfig
from repro_torch.kernels.rwkv6_scan.ops import rwkv6_scan
from repro_torch.models import layers as L
from repro_torch.models.attention import TensorSpec
from repro_torch.models.layers import Params

STREAMS = ("w", "k", "v", "r", "g")


def num_heads_of(cfg: ModelConfig) -> int:
    return cfg.d_model // cfg.rwkv.head_dim


def _uniform(gen: torch.Generator, shape, scale: float, dtype) -> torch.Tensor:
    x = torch.rand(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return (x * scale).to(dtype)


def init_time_mix(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Random time-mix params on ``gen.device``; ``w0``, ``u`` and ``ln_x``
    are f32 whatever ``param_dtype`` is, as in the reference."""
    r = cfg.rwkv
    dt = L.dtype_of(cfg.param_dtype)
    d = cfg.d_model
    H, hd = num_heads_of(cfg), r.head_dim
    f32 = torch.float32
    p: Params = {
        "mu_base": _uniform(gen, (d,), 0.1, dt),
        "lora_base_a": L._normal(gen, (d, r.mix_lora * 5), 0.01, dt),
        "lora_base_b": L._normal(gen, (5, r.mix_lora, d), 0.01, dt),
        "w0": -6.0 + _uniform(gen, (d,), 2.0, f32),
        "w_lora_a": L._normal(gen, (d, r.decay_lora), 0.01, dt),
        "w_lora_b": L._normal(gen, (r.decay_lora, d), 0.01, dt),
        "u": L._normal(gen, (H, hd), 0.1, f32),
        "wr": L.init_linear(gen, d, d, dt),
        "wk": L.init_linear(gen, d, d, dt),
        "wv": L.init_linear(gen, d, d, dt),
        "wg": L.init_linear(gen, d, d, dt),
        "wo": L.init_linear(gen, d, d, dt),
        "ln_x": L.init_norm(d, "layernorm", f32, gen.device),
    }
    for s in STREAMS:
        p[f"mu_{s}"] = _uniform(gen, (d,), 0.1, dt)
    return p


def rwkv_cache_spec(cfg: ModelConfig, batch: int) -> Dict[str, TensorSpec]:
    d = cfg.d_model
    H, hd = num_heads_of(cfg), cfg.rwkv.head_dim
    return {
        "shift_t": TensorSpec((batch, d), torch.float32),
        "shift_c": TensorSpec((batch, d), torch.float32),
        "wkv": TensorSpec((batch, H, hd, hd), torch.float32),
    }


def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor]) -> torch.Tensor:
    """Return the x_{t-1} stream. x: (B, S, D); prev: (B, D) last token of
    the context, or None (zeros)."""
    if x.shape[1] == 1 and prev is not None:
        return prev[:, None, :].to(x.dtype)
    first = torch.zeros_like(x[:, :1]) if prev is None else \
        prev[:, None, :].to(x.dtype)
    return torch.cat([first, x[:, :-1]], dim=1)


def _ddlerp(p: Params, x: torch.Tensor, xx: torch.Tensor, cd
            ) -> Dict[str, torch.Tensor]:
    """Data-dependent lerp producing the five mixed streams."""
    base = x + xx * p["mu_base"].to(cd)
    lora = torch.tanh(torch.einsum("bsd,dr->bsr", base,
                                   p["lora_base_a"].to(cd)))
    R = p["lora_base_b"].shape[1]
    out = {}
    for i, s in enumerate(STREAMS):
        li = lora[..., i * R:(i + 1) * R] if lora.shape[-1] == 5 * R else lora
        delta = torch.einsum("bsr,rd->bsd", li, p["lora_base_b"][i].to(cd))
        out[s] = x + xx * (p[f"mu_{s}"].to(cd) + delta)
    return out


def _wkv_scan(r, k, v, logw, u, state0):
    """The sequence WKV through the ``rwkv6_scan`` op.  r, k, v, logw:
    (B, H, S, hd); u: (H, hd); state0: (B, H, hd, hd) or None.  Returns
    (out (B, H, S, hd), state (B, H, hd, hd)), f32."""
    B, H, S, hd = r.shape
    N = B * H

    def rows(t):
        return t.contiguous().reshape(N, S, hd)

    s0 = torch.zeros((N, hd, hd), dtype=torch.float32, device=r.device) \
        if state0 is None else state0.float().reshape(N, hd, hd).contiguous()
    out, state = rwkv6_scan(rows(r), rows(k), rows(v), rows(logw.float()),
                            u.float().repeat(B, 1), s0)
    return out.reshape(B, H, S, hd), state.reshape(B, H, hd, hd)


def _new_state(cache: Optional[Params], mode: str, **state) -> Optional[Params]:
    """The layer's new state: prefill returns it; decode writes it into the
    cache in place and returns the cache's tensors."""
    if mode == "decode":
        for name, t in state.items():
            cache[name].copy_(t)
        return {name: cache[name] for name in state}
    return state if mode == "prefill" else None


def apply_time_mix(p: Params, x: torch.Tensor, cfg: ModelConfig, *, mode: str,
                   cache: Optional[Params] = None,
                   ) -> Tuple[torch.Tensor, Optional[Params]]:
    cd = L.dtype_of(cfg.compute_dtype)
    B, S, D = x.shape
    H, hd = num_heads_of(cfg), cfg.rwkv.head_dim
    if mode == "decode" and cache is None:
        raise ValueError("decode takes a cache")

    prev = cache["shift_t"] if cache is not None else None
    xx = _token_shift(x, prev) - x
    st = _ddlerp(p, x, xx, cd)

    def heads(t):
        return t.reshape(B, S, H, hd).transpose(1, 2)     # (B, H, S, hd)

    r = heads(L.linear(p["wr"], st["r"], cd))
    k = heads(L.linear(p["wk"], st["k"], cd))
    v = heads(L.linear(p["wv"], st["v"], cd))
    g = F.silu(L.linear(p["wg"], st["g"], cd).float())

    # data-dependent decay, log-space, clamped: every exponent the scan
    # takes relies on logw < 0
    wl = torch.tanh(torch.einsum("bsd,dr->bsr", st["w"], p["w_lora_a"].to(cd)))
    wl = torch.einsum("bsr,rd->bsd", wl, p["w_lora_b"].to(cd))
    logw = -torch.exp(torch.clamp(p["w0"].float()[None, None, :] + wl.float(),
                                  -10.0, 1.5))
    logw = heads(torch.clamp(logw, -8.0, -1e-6))

    state0 = cache["wkv"] if cache is not None else None
    if mode == "decode" and S == 1:
        # single-step closed form
        s_prev = state0.float()
        r1, k1, v1 = r[:, :, 0].float(), k[:, :, 0].float(), v[:, :, 0].float()
        kv = k1[..., :, None] * v1[..., None, :]            # (B, H, dk, dv)
        out = torch.einsum("bhk,bhkv->bhv", r1,
                           s_prev + p["u"].float()[None, :, :, None] * kv)
        s_fin = torch.exp(logw[:, :, 0])[..., None] * s_prev + kv
        wkv_out = out[:, :, None, :]                        # (B, H, 1, dv)
    else:
        wkv_out, s_fin = _wkv_scan(r, k, v, logw, p["u"], state0)

    y = wkv_out.transpose(1, 2).reshape(B, S, D)
    # a LayerNorm over all of D with the default eps, as the reference has it
    y = L.apply_norm(p["ln_x"], y.float())
    y = (y * g).to(cd)
    y = L.linear(p["wo"], y, cd)
    return y, _new_state(cache, mode, shift_t=x[:, -1].float(), wkv=s_fin)


def init_channel_mix(gen: torch.Generator, cfg: ModelConfig) -> Params:
    dt = L.dtype_of(cfg.param_dtype)
    d, f = cfg.d_model, cfg.d_ff
    return {
        "mu_k": _uniform(gen, (d,), 0.1, dt),
        "mu_r": _uniform(gen, (d,), 0.1, dt),
        "wk": L.init_linear(gen, d, f, dt),
        "w_down": L.init_linear(gen, f, d, dt),
        "wr": L.init_linear(gen, d, d, dt),
    }


def apply_channel_mix(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                      mode: str, cache: Optional[Params] = None,
                      ) -> Tuple[torch.Tensor, Optional[Params]]:
    cd = L.dtype_of(cfg.compute_dtype)
    if mode == "decode" and cache is None:
        raise ValueError("decode takes a cache")
    prev = cache["shift_c"] if cache is not None else None
    xx = _token_shift(x, prev) - x
    xk = x + xx * p["mu_k"].to(cd)
    xr = x + xx * p["mu_r"].to(cd)
    h = L.linear(p["wk"], xk, cd)
    h = F.relu(h.float()).square().to(cd)
    v = L.linear(p["w_down"], h, cd)
    r = torch.sigmoid(L.linear(p["wr"], xr, cd).float())
    y = (r * v.float()).to(cd)
    return y, _new_state(cache, mode, shift_c=x[:, -1].float())
