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
import torch.distributed._functional_collectives as funcol
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Shard

from repro_torch import sharding as sh
from repro_torch.core.config import ModelConfig
from repro_torch.kernels.ssm_scan.ops import ssm_scan, ssm_scan_by_channels
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


# ---------------------------------------------------------------------------
# Under a mesh: the mixer's channels on "model"
# ---------------------------------------------------------------------------


def _split_uz(xz: torch.Tensor, di: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(u, z), xz's first and last di channels.  Under a mesh in_proj's
    output lies on "model" over all 2 di columns, so ranks 0 .. m/2 - 1
    hold all of u and the others all of z; one all-to-all over "model"
    gives each rank its own di/m channels of both (rank r sends its two
    chunks to ranks 2r and 2r + 1 mod m and takes u's from r // 2 and z's
    from m/2 + r // 2): u and z each on "model" along its own channels,
    as the reference lays u out ("mlp")."""
    if not isinstance(xz, DTensor) or not isinstance(sh.on_model(xz), Shard):
        return xz[..., :di], xz[..., di:]
    mesh = xz.device_mesh
    m, r = sh.model_size(mesh), sh.model_rank(mesh)
    if di % m:
        raise ValueError(f"d_inner {di} does not split over {m} ranks")
    w = di // m
    sends, recvs = [0] * m, [0] * m
    sends[2 * r % m] = sends[(2 * r + 1) % m] = w
    recvs[r // 2] = recvs[m // 2 + r // 2] = w
    group = mesh.get_group("model")

    def local(xl):
        t = xl.movedim(-1, 0).contiguous()
        t = funcol.all_to_all_single_autograd(t, recvs, sends, group)
        t = t.movedim(0, -1)
        return t[..., :w].contiguous(), t[..., w:].contiguous()

    return sh.run_local(local, [xz.placements, xz.placements], xz)


def _channels(t: torch.Tensor) -> slice:
    """The channels (last dim) of ``t`` that this rank holds: all of them
    without a mesh or with them replicated over "model"."""
    if not isinstance(t, DTensor) or not isinstance(sh.on_model(t), Shard):
        return slice(None)
    n = t.to_local().shape[-1]
    first = sh.model_rank(t.device_mesh) * n
    return slice(first, first + n)


def _conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
          window: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The depthwise causal conv, under a mesh on each rank's rows and
    channels with its channels' slice of the replicated taps ``w`` and
    bias ``b`` (their gradient partial over "model" and the batch's axes).
    A decode step passes the cached ``window`` (B, K-1, di), laid out as u,
    and its shard is moved on by u's token in place."""
    cols = _channels(u)

    def local(ul, wl, bl, pl=None):
        y = _causal_conv(ul, wl[:, cols], bl[cols], prev=pl)
        if pl is not None:
            pl.copy_(torch.cat([pl[:, 1:], ul.float()], dim=1))
        return y

    args = (u, w, b) + (() if window is None else (window,))
    if not isinstance(u, DTensor):
        return local(*args)
    split = cols != slice(None)
    grads = (u.placements, sh.batch_grad(u, w, model=split),
             sh.batch_grad(u, b, model=split)) + \
        (() if window is None else (window.placements,))
    return sh.run_local(local, u.placements, *args, in_grad_placements=grads)


def _on_channels(p: Params, x: torch.Tensor, cd, dim: int, split: bool
                 ) -> torch.Tensor:
    """``L.linear(p, x)`` for a product over the mixer's channels: under a
    mesh with the d_inner channels on "model" (``split``; x_proj's
    rows, ``dim`` 0; dt_proj's columns, ``dim`` 1) the weight's FSDP
    shard is gathered and its "model" shard laid on that dim, a rank its
    own channels' rows or columns.  x_proj then sums its (B, S, dt_rank +
    2 d_state) output over "model" (one all-reduce, where the reference's
    layout all-gathers u_act (B, S, d_inner)); dt_proj reads dt_in, which
    that sum left whole on every rank, and writes its channels with no
    collective (where a row-parallel product over dt_rank would reduce
    (B, S, d_inner))."""
    if split:
        p = dict(p, w=sh.with_placement(sh.gather_fsdp(p["w"].to(cd)),
                                        "model", Shard(dim)))
    return L.linear(p, x, cd)


def _tail(u: torch.Tensor, K: int) -> torch.Tensor:
    """The conv window a prefill leaves: u's last K - 1 positions (zeros in
    front of a shorter prompt), f32, on each rank's shard."""
    def local(ul):
        S = ul.shape[1]
        return F.pad(ul, (0, 0, max(0, K - 1 - S), 0))[:, -(K - 1):].float()
    if not isinstance(u, DTensor):
        return local(u)
    return sh.run_local(local, u.placements, u)


def apply_ssm(p: Params, x: torch.Tensor, cfg: ModelConfig, *, mode: str,
              cache: Optional[Params] = None, pos=None,
              ) -> Tuple[torch.Tensor, Optional[Params]]:
    """x: (B,S,D).  ``pos`` is not read: the layer carries its position in
    its state.

    One body for one chip and a mesh (x a DTensor; the reference's
    constraint sites: u on ("batch", "seq", "mlp"), the output on ("batch",
    "seq", "embed")).  Under a mesh the mixer's di channels lie on
    "model": u and z by :func:`_split_uz`, the conv on each rank's channels
    (:func:`_conv`), x_proj on its channels' rows so that dt_in, B and C
    come out whole on every rank, dt_proj on its channels' columns
    (:func:`_on_channels`), K3 on each rank's rows and channels
    (``ssm_scan_by_channels``), and out_proj row-parallel with one
    all-reduce.  Decode's cache lies as u does
    (state spec ("batch", None, "mlp") and ("batch", "mlp", None)) and is
    written in place on each rank's shard."""
    s = cfg.ssm
    cd = L.dtype_of(cfg.compute_dtype)
    B, S, D = x.shape
    di = d_inner_of(cfg)
    dtr = s.resolved_dt_rank(cfg.d_model)
    if isinstance(x, DTensor) and mode != "decode" and sh.seq_parallel():
        raise NotImplementedError(
            "sequence-parallel train/prefill of the Mamba mixer (a scan "
            "carried over the sequence's shards) is not ported")

    xz = L.linear(p["in_proj"], x, cd)
    u, z = _split_uz(xz, di)
    u = sh.constrain(u, ("batch", "seq", "mlp"))
    conv_w, conv_b = p["conv_w"].to(cd), p["conv_b"].to(cd)

    if mode == "decode":
        if cache is None or S != 1:
            raise ValueError("decode takes a cache and one token per row")
        if isinstance(u, DTensor) and u.placements != \
                cache["conv"].placements:
            place = cache["conv"].placements
            u, z = u.redistribute(u.device_mesh, place), \
                z.redistribute(z.device_mesh, place)
        # the new window goes into the cache in place
        u_conv = _conv(u, conv_w, conv_b, window=cache["conv"])
    else:
        u_conv = _conv(u, conv_w, conv_b)

    u_act = F.silu(u_conv.float()).to(cd)

    split = isinstance(u_act, DTensor) and \
        isinstance(sh.on_model(u_act), Shard)
    xdb = _on_channels(p["x_proj"], u_act, cd, 0, split)
    dt_in = xdb[..., :dtr]
    if split:   # dt_proj's rows' gradient, partial over "model", reduced
        dt_in = sh.grad_as(dt_in, dt_in.placements)
    Bmat = xdb[..., dtr:dtr + s.d_state].contiguous()
    Cmat = xdb[..., dtr + s.d_state:].contiguous()
    dt_full = F.softplus(_on_channels(p["dt_proj"], dt_in, cd, 1,
                                      split).float())

    # decode updates the cached state in place (h_out = h0)
    y, h_fin = ssm_scan_by_channels(
        u_act, dt_full, p["A_log"].float(), Bmat, Cmat, p["D"].float(),
        cache["state"] if mode == "decode" else None,
        in_place=mode == "decode", scan=ssm_scan)
    y = (y * F.silu(z.float())).to(cd)
    out = sh.constrain(L.linear(p["out_proj"], y, cd),
                       ("batch", "seq", "embed"))

    if mode == "decode":
        return out, {"conv": cache["conv"], "state": cache["state"]}
    if mode == "prefill":
        return out, {"conv": _tail(u, s.d_conv), "state": h_fin}
    return out, None
