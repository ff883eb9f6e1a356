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

Under a mesh (x a DTensor, its d_model on "model" as the reference's
("batch", "seq", "embed") lays it out) the params lie as
``repro_torch.sharding`` gives them, the reference's specs:

* time mix: ``wr``, ``wk``, ``wv``, ``wg`` ``/w`` (d, d) on ("data",
  "model"), column-parallel; ``wo/w`` on ("model", "data"), row-parallel;
* channel mix: ``wk/w`` (d, d_ff) and ``wr/w`` (d, d) on ("data",
  "model"); ``w_down/w`` on ("model", "data");
* replicated: ``mu_*``, ``lora_base_a/b``, ``w_lora_a/b``, ``w0``, ``u``
  (H, hd), ``ln_x``;
* state: ``wkv`` (B, H, hd, hd) on ("batch", "heads", None, None), its
  heads on "model"; ``shift_t`` and ``shift_c`` (B, D) on ("batch",
  "embed"), their channels on "model".

A column-parallel product's d_model / m output channels on "model" are
whole heads there when hd divides d_model / m (rwkv6-1.6b: 2 heads of 64 a
rank on 16; the smoke's 4 heads of 16: 1 a rank on 4), so K4 runs per
rank on its rows and heads (``rwkv6_scan_by_heads``), and so does the
decode step's closed form, on DTensors laid out alike (the replicated u
read in the rank's rows of it, no collective).  The lerps and the decay stay on each rank's
d_model channels: the replicated lora weights are read in the rank's slice
(``_lora_down``: the down products over its rows of d_model, one
all-reduce of their (B, S, rank) sums; ``_lora_up``: the up products, the
decay's among them, onto its columns, no collective), so that no rank
computes all of d_model.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Shard

from repro_torch import sharding as sh
from repro_torch.core.config import ModelConfig
from repro_torch.kernels.rwkv6_scan.ops import rwkv6_scan_by_heads
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


def _lora_down(x: torch.Tensor, w: torch.Tensor, cd, split: bool
               ) -> torch.Tensor:
    """``tanh(x @ w)`` for a replicated lora weight w (d_model, rank) (the
    reference's einsum).  Under a mesh with x's d_model on "model"
    (``split``) each rank reads its rows of w and the (B, S, rank) sums are
    all-reduced; the up products' gradients for the result, partial over
    "model", are summed where they enter it (left pending, DTensor
    scatters them over the batch rows at tanh's backward and gathers them
    again).  w's gradient is its row slices', gathered over "model"."""
    if not split:
        return torch.tanh(L.linear({"w": w}, x, cd))
    y = torch.tanh(L.linear(
        {"w": sh.with_placement(w, "model", Shard(0))}, x, cd))
    return sh.grad_as(y, y.placements)


def _lora_up(x: torch.Tensor, w: torch.Tensor, cd, split: bool
             ) -> torch.Tensor:
    """``x @ w`` for a replicated lora weight w (rank, d_model).  Under a
    mesh with the activations' d_model on "model" (``split``) each rank
    computes its columns, on "model" as the activations it meets, from
    the whole x: no collective.  w's gradient is its column slices',
    gathered over "model"."""
    if split:
        w = sh.with_placement(w, "model", Shard(1))
    return L.linear({"w": w}, x, cd)


def _ddlerp(p: Params, x: torch.Tensor, xx: torch.Tensor, cd,
            split: bool = False) -> Dict[str, torch.Tensor]:
    """Data-dependent lerp producing the five mixed streams (under a mesh
    each on the rank's d_model channels, as x lies)."""
    base = x + xx * p["mu_base"].to(cd)
    lora = _lora_down(base, p["lora_base_a"], cd, split)
    R = p["lora_base_b"].shape[1]
    out = {}
    for i, s in enumerate(STREAMS):
        li = lora[..., i * R:(i + 1) * R] if lora.shape[-1] == 5 * R else lora
        delta = _lora_up(li, p["lora_base_b"][i], cd, split)
        out[s] = x + xx * (p[f"mu_{s}"].to(cd) + delta)
    return out


def _new_state(cache: Optional[Params], mode: str, **state) -> Optional[Params]:
    """The layer's new state: prefill returns it; decode writes it into the
    cache in place (under a mesh a copy between DTensors laid out alike,
    into the cache's own local shards) and returns the cache's tensors."""
    if mode == "decode":
        for name, t in state.items():
            cache[name].copy_(t)
        return {name: cache[name] for name in state}
    return state if mode == "prefill" else None


def _seq_parallel_refused(x: torch.Tensor, mode: str) -> None:
    if isinstance(x, DTensor) and mode != "decode" and sh.seq_parallel():
        raise NotImplementedError(
            "sequence-parallel train/prefill of RWKV-6 (a WKV scan carried "
            "over the sequence's shards) is not ported (ROADMAP.md item 14b)")


def apply_time_mix(p: Params, x: torch.Tensor, cfg: ModelConfig, *, mode: str,
                   cache: Optional[Params] = None,
                   ) -> Tuple[torch.Tensor, Optional[Params]]:
    """x: (B, S, D).  One body for one chip and a mesh (x a DTensor; the
    reference's constraint site: the output on ("batch", "seq", "embed")).
    Under a mesh the streams and the decay stay on each rank's d_model
    channels (:func:`_lora_down`, :func:`_lora_up`), r, k, v and g come out
    of their column-parallel products on the rank's heads, K4 runs on its
    rows and heads (``rwkv6_scan_by_heads``; a decode step's closed form on
    them too, its state copied into the cache's local shards), ``ln_x``
    all-reduces its sums and ``wo`` is row-parallel, one all-reduce of
    (B, S, D)."""
    cd = L.dtype_of(cfg.compute_dtype)
    B, S, D = x.shape
    H, hd = num_heads_of(cfg), cfg.rwkv.head_dim
    if mode == "decode" and cache is None:
        raise ValueError("decode takes a cache")
    _seq_parallel_refused(x, mode)
    # x's d_model channels on "model"
    split = isinstance(x, DTensor) and isinstance(sh.on_model(x), Shard)
    if split and (D // sh.model_size(x.device_mesh)) % hd:
        raise ValueError(f"{cfg.name}: heads of {hd} do not split over "
                         f"{sh.model_size(x.device_mesh)} ranks")

    prev = cache["shift_t"] if cache is not None else None
    xx = _token_shift(x, prev) - x
    st = _ddlerp(p, x, xx, cd, split)

    def heads(t):
        return t.reshape(B, S, H, hd).transpose(1, 2)     # (B, H, S, hd)

    r = heads(L.linear(p["wr"], st["r"], cd))
    k = heads(L.linear(p["wk"], st["k"], cd))
    v = heads(L.linear(p["wv"], st["v"], cd))
    g = F.silu(L.linear(p["wg"], st["g"], cd).float())

    # data-dependent decay, log-space, clamped: every exponent the scan
    # takes relies on logw < 0
    wl = _lora_up(_lora_down(st["w"], p["w_lora_a"], cd, split),
                  p["w_lora_b"], cd, split)
    logw = -torch.exp(torch.clamp(p["w0"].float()[None, None, :] + wl.float(),
                                  -10.0, 1.5))
    logw = heads(torch.clamp(logw, -8.0, -1e-6))

    state0 = cache["wkv"] if cache is not None else None
    if mode == "decode" and S == 1:
        # single-step closed form (under a mesh on each rank's rows and
        # heads: u, replicated, meets kv's heads in its rows of them)
        s_prev = state0.float()
        r1, k1, v1 = r[:, :, 0].float(), k[:, :, 0].float(), v[:, :, 0].float()
        kv = k1[..., :, None] * v1[..., None, :]            # (B, H, dk, dv)
        out = torch.einsum("bhk,bhkv->bhv", r1,
                           s_prev + p["u"].float()[None, :, :, None] * kv)
        s_fin = torch.exp(logw[:, :, 0])[..., None] * s_prev + kv
        wkv_out = out[:, :, None, :]                        # (B, H, 1, dv)
    else:
        wkv_out, s_fin = rwkv6_scan_by_heads(r, k, v, logw, p["u"], state0)

    y = wkv_out.transpose(1, 2).reshape(B, S, D)
    # a LayerNorm over all of D with the default eps, as the reference has it
    y = L.apply_norm(p["ln_x"], y.float())
    y = (y * g).to(cd)
    y = sh.constrain(L.linear(p["wo"], y, cd), ("batch", "seq", "embed"))
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
    """x: (B, S, D).  Under a mesh (the reference's constraint sites: h on
    ("batch", "seq", "mlp"), the output on ("batch", "seq", "embed")):
    ``wk`` column-parallel onto d_ff on "model", ``w_down`` row-parallel
    (one all-reduce, its sum then sliced to each rank's d_model channels),
    ``wr`` column-parallel onto the same channels, so that r · v moves
    nothing."""
    cd = L.dtype_of(cfg.compute_dtype)
    if mode == "decode" and cache is None:
        raise ValueError("decode takes a cache")
    _seq_parallel_refused(x, mode)
    prev = cache["shift_c"] if cache is not None else None
    xx = _token_shift(x, prev) - x
    xk = x + xx * p["mu_k"].to(cd)
    xr = x + xx * p["mu_r"].to(cd)
    h = L.linear(p["wk"], xk, cd)
    h = sh.constrain(F.relu(h.float()).square().to(cd),
                     ("batch", "seq", "mlp"))
    v = sh.constrain(L.linear(p["w_down"], h, cd), ("batch", "seq", "embed"))
    r = torch.sigmoid(L.linear(p["wr"], xr, cd).float())
    y = sh.constrain((r * v.float()).to(cd), ("batch", "seq", "embed"))
    return y, _new_state(cache, mode, shift_c=x[:, -1].float())
