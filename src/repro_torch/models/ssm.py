"""Mamba selective-SSM mixer (PyTorch twin of ``repro.models.ssm``), used
inside the Jamba hybrid.

Every mode's scan goes through the ``ssm_scan`` op: the Hopper kernel on the
card, its plain sequential version on the CPU.  Decode is the same op with
S == 1 and the cached state as ``h0``, as the reference runs one scan
function in every mode; the reference's chunked twin
(``selective_scan_chunked``) is how XLA computes that recurrence and is not
ported.

Cache layout (decode), per layer:
  {"conv": (B, d_conv-1, d_inner) f32, "state": (B, d_inner, d_state) f32}
Decode writes the new conv window and state into the cache **in place** and
returns the same tensors; prefill returns a new cache.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.config import ModelConfig
from repro_torch.kernels.ssm_scan.ops import ssm_scan
from repro_torch.models import layers as L
from repro_torch.models.attention import TensorSpec
from repro_torch.models.layers import Params


def d_inner_of(cfg: ModelConfig) -> int:
    return cfg.ssm.expand * cfg.d_model


def init_ssm(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Random Mamba params on ``gen.device``; ``A_log`` and ``D`` are f32
    whatever ``param_dtype`` is, as in the reference."""
    s = cfg.ssm
    dt = L.dtype_of(cfg.param_dtype)
    d, di = cfg.d_model, d_inner_of(cfg)
    dtr = s.resolved_dt_rank(cfg.d_model)
    dev = gen.device
    # S4D-real initialisation for A
    a_init = torch.arange(1, s.d_state + 1, dtype=torch.float32,
                          device=dev)[None, :].repeat(di, 1)
    dt_init = torch.exp(
        torch.rand((di,), generator=gen, device=dev)
        * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
    inv_softplus = dt_init + torch.log(-torch.expm1(-dt_init))
    return {
        "in_proj": L.init_linear(gen, d, 2 * di, dt),
        "conv_w": L._normal(gen, (s.d_conv, di), 1.0 / math.sqrt(s.d_conv), dt),
        "conv_b": torch.zeros((di,), dtype=dt, device=dev),
        "x_proj": L.init_linear(gen, di, dtr + 2 * s.d_state, dt),
        "dt_proj": {**L.init_linear(gen, dtr, di, dt, scale=dtr ** -0.5),
                    "b": inv_softplus.to(dt)},
        "A_log": torch.log(a_init),                     # (di, ds) f32
        "D": torch.ones((di,), dtype=torch.float32, device=dev),
        "out_proj": L.init_linear(gen, di, d, dt),
    }


def ssm_cache_spec(cfg: ModelConfig, batch: int) -> Dict[str, TensorSpec]:
    s = cfg.ssm
    di = d_inner_of(cfg)
    return {
        "conv": TensorSpec((batch, s.d_conv - 1, di), torch.float32),
        "state": TensorSpec((batch, di, s.d_state), torch.float32),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 prev: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv.  x: (B,S,di), w: (K,di).  prev: (B,K-1,di)."""
    K = w.shape[0]
    if prev is None:
        xp = F.pad(x, (0, 0, K - 1, 0))
    else:
        xp = torch.cat([prev.to(x.dtype), x], dim=1)
    y = sum(xp[:, i:i + x.shape[1], :] * w[i][None, None, :]
            for i in range(K))
    return y + b[None, None, :]


def apply_ssm(p: Params, x: torch.Tensor, cfg: ModelConfig, *, mode: str,
              cache: Optional[Params] = None, pos=None,
              ) -> Tuple[torch.Tensor, Optional[Params]]:
    """x: (B,S,D).  ``pos`` is not read: the layer carries its position in
    its state."""
    s = cfg.ssm
    cd = L.dtype_of(cfg.compute_dtype)
    B, S, D = x.shape
    di = d_inner_of(cfg)
    dtr = s.resolved_dt_rank(cfg.d_model)

    xz = L.linear(p["in_proj"], x, cd)
    u, z = xz[..., :di], xz[..., di:]
    conv_w, conv_b = p["conv_w"].to(cd), p["conv_b"].to(cd)

    if mode == "decode":
        if cache is None or S != 1:
            raise ValueError("decode takes a cache and one token per row")
        conv_prev = cache["conv"]
        u_conv = _causal_conv(u, conv_w, conv_b, prev=conv_prev)
        new_conv = torch.cat([conv_prev[:, 1:], u.float()], dim=1)
    else:
        u_conv = _causal_conv(u, conv_w, conv_b)
        new_conv = None
        if mode == "prefill":
            K = s.d_conv
            tail = F.pad(u, (0, 0, max(0, K - 1 - S), 0))
            new_conv = tail[:, -(K - 1):].float()

    u_act = F.silu(u_conv.float()).to(cd)

    xdb = L.linear(p["x_proj"], u_act, cd)
    dt_in = xdb[..., :dtr]
    Bmat = xdb[..., dtr:dtr + s.d_state].contiguous()
    Cmat = xdb[..., dtr + s.d_state:].contiguous()
    dt_full = F.softplus(L.linear(p["dt_proj"], dt_in, cd).float())

    if mode == "decode":
        h0 = cache["state"]
    else:
        h0 = torch.zeros((B, di, s.d_state), dtype=torch.float32,
                         device=x.device)
    # decode updates the cached state in place (h_out = h0)
    y, h_fin = ssm_scan(u_act.contiguous(), dt_full.contiguous(),
                        p["A_log"].float().contiguous(), Bmat, Cmat,
                        p["D"].float().contiguous(), h0,
                        h_out=h0 if mode == "decode" else None)
    y = (y * F.silu(z.float())).to(cd)
    out = L.linear(p["out_proj"], y, cd)

    if mode == "decode":
        cache["conv"].copy_(new_conv)
        return out, {"conv": cache["conv"], "state": cache["state"]}
    if mode == "prefill":
        return out, {"conv": new_conv, "state": h_fin}
    return out, None
