"""Helpers of the dry-run parity tests (``tests/test_torch_dryrun*.py``):
the reference walker's FLOPs of a jitted JAX step, the port's count of the
same step on fake CPU tensors (the plain versions run) and on ``meta``
tensors (the kernels' formulas), and the differences the two packages have
by design, each named.
"""
import dataclasses

import jax
import jax.numpy as jnp
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.core.config import OptimizerConfig as JOptimizerConfig
from repro.core.config import ShapeConfig as JShapeConfig
from repro.core.config import get_arch as jax_get_arch
from repro.core.hlo.analysis import analyze_compiled
from repro.launch import steps as jsteps
from repro.models import api as japi
from repro.models import rwkv6 as jrwkv6
from repro.models import ssm as jssm
from repro.optim import adamw as jadamw
from repro_torch.core.config import ShapeConfig
from repro_torch.core.config import get_arch as torch_get_arch
from repro_torch.kernels.rwkv6_scan import ops as trwkv6_ops
from repro_torch.launch import dryrun
from repro_torch.models import ssm as tssm

B = 2
SEQ = {"train": 32, "prefill": 64, "decode": 16}
# the scan kernels, whose formulas count their own form's products
SCAN_KERNELS = ("rwkv6_scan", "rwkv6_scan_bwd", "ssm_scan", "ssm_scan_bwd")


def f32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32",
                               compute_dtype="float32")


def configs(arch):
    return f32(jax_get_arch(arch).smoke), f32(torch_get_arch(arch).smoke)


def walker_flops(cfg, mode, remat="none") -> int:
    """``analyze_compiled``'s FLOPs of the reference's step on one CPU
    device."""
    shape = JShapeConfig("parity", SEQ[mode], B, mode)
    ps = japi.param_shapes(cfg)
    ins = japi.input_specs(cfg, shape)
    if mode == "train":
        opt = JOptimizerConfig()
        opt_shapes = jax.eval_shape(lambda: jadamw.init_opt_state(
            jax.tree.map(lambda s: jax.ShapeDtypeStruct(s.shape, s.dtype),
                         ps), opt))
        fn, _ = jsteps.step_for_shape(cfg, shape, opt, remat=remat)
        lowered = jax.jit(fn).lower(ps, opt_shapes, ins)
    elif mode == "prefill":
        fn, _ = jsteps.step_for_shape(cfg, shape)
        lowered = jax.jit(fn).lower(ps, ins)
    else:
        fn, _ = jsteps.step_for_shape(cfg, shape)
        lowered = jax.jit(fn).lower(ps, ins["state"], ins["tokens"],
                                    ins["pos"])
    return int(analyze_compiled(lowered.compile())["flops"])


def port_count(cfg, mode, remat="none", device="cpu") -> dict:
    """The port's report of the same step: fake CPU tensors (``cpu``) or
    ``meta``."""
    shape = ShapeConfig("parity", SEQ[mode], B, mode)
    if device == "meta":
        return dryrun.count_cell(cfg, shape, remat=remat, device="meta")
    with FakeTensorMode():
        return dryrun.count_cell(cfg, shape, remat=remat, device="cpu")


def head_recompute(cfg, mode) -> int:
    """FLOPs of the LM head's product that the port's ``chunked_xent``
    computes again in the backward (it checkpoints each chunk; the
    reference's XLA program keeps the one-chunk logits): 2 B T d V over the
    T text positions that predict a next token.  The enc-dec's loss takes
    no chunks."""
    if mode != "train" or cfg.family in ("encdec", "audio", "convnet"):
        return 0
    text = SEQ[mode]
    if cfg.frontend is not None and cfg.frontend.kind != "none":
        text -= min(cfg.frontend.num_prefix, SEQ[mode] // 2)
    return 2 * B * (text - 1) * cfg.d_model * cfg.vocab_size


def attention_widths(cfg) -> tuple:
    """(hd, hd_v) of the step's attention: MLA's expanded query/key (nope +
    rope) and value widths, else the head dim for both."""
    a = cfg.attention
    if a.kind == "mla":
        return a.qk_nope_head_dim + a.qk_rope_head_dim, a.v_head_dim
    return a.head_dim, a.head_dim


def kernel_extra(rep, cfg) -> int:
    """What a ``meta`` count adds over the plain versions' products: every
    scan kernel's formula (the plain scans are stood in for, see
    :func:`stand_in_scans`), and the three products of K2's backward that
    autograd over the plain attention does not compute (S in both of its
    passes, dP in the dQ pass): of its 2 B Hq pairs (4 hd + 3 hd_v), the
    share (2 hd + hd_v) / (4 hd + 3 hd_v), 3 / 7 where hd_v = hd."""
    by_op = rep["by_op"]
    extra = sum(by_op.get(k, {}).get("flops", 0) for k in SCAN_KERNELS)
    bwd = by_op.get("flash_attention_bwd", {}).get("flops", 0)
    if bwd:
        hd, hd_v = attention_widths(cfg)
        assert bwd * (2 * hd + hd_v) % (4 * hd + 3 * hd_v) == 0
        extra += bwd * (2 * hd + hd_v) // (4 * hd + 3 * hd_v)
    return extra


# ---- the scans, stood in for in both packages ----------------------------
# The reference computes the WKV and selective scans as chunked XLA dots,
# the port's plain versions in their own forms and its kernels by their own
# formulas, so the three counts of a scan differ by design.  The stand-ins
# are elementwise (no product) functions of the same inputs and shapes,
# each input used (the port's trainer differentiates every param), so that
# every other product of the step is held exactly.


def _jax_wkv(r, k, v, logw, u, state0, chunk=16):
    B_, H, S, hd = r.shape
    out = r.astype(jnp.float32) * k * v * jnp.exp(logw) + u[None, :, None]
    s = jnp.zeros((B_, H, hd, hd), jnp.float32) if state0 is None \
        else state0.astype(jnp.float32)
    return out, s


def _torch_wkv(r, k, v, logw, u, state0):
    return r.float() * k.float() * v.float() * torch.exp(logw) \
        + u[:, None], state0


def _jax_selective(u, dt, A, Bmat, Cmat, D, h0=None, chunk=256):
    Bz, S, di = u.shape
    y = u.astype(jnp.float32) * (dt + D) \
        + jnp.sum(Bmat * Cmat, -1)[..., None] + jnp.sum(A, -1)
    h = jnp.zeros((Bz, di, A.shape[-1]), jnp.float32) if h0 is None \
        else h0.astype(jnp.float32)
    return y, h


def _torch_selective(u, dt, A_log, B_, C, D, h0, *, h_out=None):
    y = u.float() * (dt + D) + (B_.float() * C.float()).sum(-1)[..., None] \
        + A_log.sum(-1)
    return y, h0 if h_out is None else h_out.copy_(h0)


def stand_in_scans(monkeypatch, family, mode) -> None:
    """Put the stand-ins in place of the scans the step runs (an RWKV
    decode step runs none: both compute it inline)."""
    if family == "ssm" and mode != "decode":
        monkeypatch.setattr(jrwkv6, "wkv_chunked", _jax_wkv)
        monkeypatch.setattr(trwkv6_ops, "rwkv6_scan", _torch_wkv)
    elif family == "hybrid":
        monkeypatch.setattr(jssm, "selective_scan_chunked", _jax_selective)
        monkeypatch.setattr(tssm, "ssm_scan", _torch_selective)


def check_cell(monkeypatch, arch, mode, remat="none", meta=True):
    """The three counts of one (arch, mode): the port on fake CPU tensors =
    the walker + the head's recomputation; the port on ``meta`` (kernels,
    the scans unpatched) = the fake count + :func:`kernel_extra`."""
    jcfg, tcfg = configs(arch)
    meta_rep = port_count(tcfg, mode, remat, "meta") if meta else None
    stand_in_scans(monkeypatch, tcfg.family, mode)
    walker = walker_flops(jcfg, mode, remat)
    fake = port_count(tcfg, mode, remat, "cpu")
    assert fake["flops"] == walker + head_recompute(tcfg, mode), \
        (fake["flops"], walker, head_recompute(tcfg, mode))
    if meta_rep is not None:
        extra = kernel_extra(meta_rep, tcfg)
        assert meta_rep["flops"] - extra == fake["flops"], \
            (meta_rep["flops"], extra, fake["flops"])
    return walker, fake, meta_rep
