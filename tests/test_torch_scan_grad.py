"""The scans' gradients through the port's op wrappers, on the CPU: under
grad mode the ops are differentiable there (their plain versions), the
backward wrappers take the plain backward for CPU tensors, a grad-mode call
that would write ``h_out`` in place is refused before any kernel, and the
recurrent models train through ``launch/train.py``.  The backward kernels
run only on the card, where ``chip_smoke.py`` holds them against these
plain versions.
"""
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core.config import get_arch as jax_get_arch
from repro.models import api as japi
from repro_torch.configs.jamba_1_5_large_398b import TRAIN_CARD
from repro_torch.core.config import get_arch
from repro_torch.kernels.rwkv6_scan import bwd as kbwd
from repro_torch.kernels.rwkv6_scan import ops as kops
from repro_torch.kernels.ssm_scan import bwd as sbwd
from repro_torch.kernels.ssm_scan import ops as sops
from repro_torch.launch.train import main
from repro_torch.models import api as tapi


def _ssm_args(Bz=2, S=21, di=12, ds=8, dtype=torch.float32, seed=0):
    rng = np.random.default_rng(seed)
    u = torch.from_numpy(rng.standard_normal((Bz, S, di), np.float32))
    dt = torch.from_numpy(np.log1p(np.exp(
        rng.standard_normal((Bz, S, di)) - 1)).astype(np.float32))
    A = torch.log(torch.arange(1, ds + 1, dtype=torch.float32)).repeat(di, 1)
    B, C = (torch.from_numpy(rng.standard_normal((Bz, S, ds), np.float32))
            for _ in range(2))
    D = torch.from_numpy(rng.standard_normal(di, np.float32))
    h0 = torch.from_numpy(rng.standard_normal((Bz, di, ds), np.float32) * 0.1)
    return [u.to(dtype), dt, A, B.to(dtype), C.to(dtype), D, h0]


def _wkv_args(N=3, S=37, hd=8, dtype=torch.float32, seed=0):
    rng = np.random.default_rng(seed)
    r, k, v, z = (rng.standard_normal((N, S, hd), np.float32)
                  for _ in range(4))
    logw = np.clip(-np.exp(z * 0.5 - 1), -8.0, -1e-6).astype(np.float32)
    u = rng.standard_normal((N, hd), np.float32) * 0.1
    s0 = rng.standard_normal((N, hd, hd), np.float32) * 0.1
    return [torch.from_numpy(x).to(dtype) for x in (r, k, v)] + \
        [torch.from_numpy(x) for x in (logw, u, s0)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssm_scan_is_differentiable_on_the_cpu(dtype):
    args = _ssm_args(dtype=dtype)
    leaves = [t.clone().requires_grad_() for t in args]
    y, h = sops.ssm_scan(*leaves)
    assert y.grad_fn is not None and h.grad_fn is not None
    gen = torch.Generator().manual_seed(1)
    dy, dh = torch.randn(y.shape, generator=gen), torch.randn(h.shape,
                                                             generator=gen)
    auto = torch.autograd.grad((y, h), leaves, (dy, dh))
    launches, calls = sbwd.launches, sbwd.ref.calls
    got = sbwd.ssm_scan_bwd(*args, dy, dh)
    assert (sbwd.launches, sbwd.ref.calls) == (launches, calls + 1)
    for g, a, x in zip(got, auto, args):
        assert g.dtype == x.dtype and g.shape == x.shape
        torch.testing.assert_close(g.float(), a.float(), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rwkv6_scan_is_differentiable_on_the_cpu(dtype):
    args = _wkv_args(dtype=dtype)
    leaves = [t.clone().requires_grad_() for t in args]
    out, state = kops.rwkv6_scan(*leaves)
    assert out.grad_fn is not None and state.grad_fn is not None
    gen = torch.Generator().manual_seed(1)
    dout = torch.randn(out.shape, generator=gen)
    dstate = torch.randn(state.shape, generator=gen)
    auto = torch.autograd.grad((out, state), leaves, (dout, dstate))
    launches, calls = kbwd.launches, kbwd.ref.calls
    got = kbwd.rwkv6_scan_bwd(*args, dout, dstate)
    assert (kbwd.launches, kbwd.ref.calls) == (launches, calls + 1)
    for g, a, x in zip(got, auto, args):
        assert g.dtype == x.dtype and g.shape == x.shape
        torch.testing.assert_close(g.float(), a.float(), atol=1e-4, rtol=1e-4)


def test_ssm_scan_refuses_h_out_under_grad_before_any_kernel():
    """On the card a grad-mode call with h_out would write in place into a
    tensor the backward keeps; the op raises before it looks for a kernel
    (shown on meta tensors, which have none), and only under grad mode."""
    args = [t.to("meta") for t in _ssm_args()]
    args[0].requires_grad_()
    h0 = args[-1]
    with pytest.raises(ValueError, match="h_out is not taken under grad"):
        sops.ssm_scan(*args, h_out=h0)
    with torch.no_grad(), pytest.raises(ValueError, match="no kernel for meta"):
        sops.ssm_scan(*args, h_out=h0)
    with pytest.raises(ValueError, match="no kernel for meta"):
        sops.ssm_scan(*args)                       # grad mode, no h_out
    cpu = _ssm_args()                              # the CPU takes h_out
    cpu[0].requires_grad_()
    out = torch.empty_like(cpu[-1])
    y, h = sops.ssm_scan(*cpu, h_out=out)
    assert h is out and y.grad_fn is not None


def test_the_forwards_for_the_backward_and_the_backwards_need_a_card():
    ssm, wkv = _ssm_args(), _wkv_args()
    with pytest.raises(ValueError, match="no kernel for cpu"):
        sops.ssm_scan_fwd(*ssm)
    with pytest.raises(ValueError, match="no kernel for cpu"):
        kops.rwkv6_scan_fwd(*wkv)
    meta = [t.to("meta") for t in ssm]
    with pytest.raises(ValueError, match="no kernel for meta"):
        sbwd.ssm_scan_bwd(*meta, torch.empty(meta[1].shape, device="meta"))
    meta = [t.to("meta") for t in wkv]
    with pytest.raises(ValueError, match="no kernel for meta"):
        kbwd.rwkv6_scan_bwd(*meta, torch.empty(meta[3].shape, device="meta"))


def test_backward_wrappers_reject_gradients_of_another_shape():
    ssm, wkv = _ssm_args(), _wkv_args()
    with pytest.raises(ValueError, match="want dy"):
        sbwd.ssm_scan_bwd(*ssm, torch.zeros(2, 20, 12))
    with pytest.raises(ValueError, match="want dy"):
        sbwd.ssm_scan_bwd(*ssm, torch.zeros(2, 21, 12, dtype=torch.float64))
    with pytest.raises(ValueError, match="want dout"):
        kbwd.rwkv6_scan_bwd(*wkv, torch.zeros(3, 37, 8),
                            torch.zeros(3, 8, 7))


@pytest.mark.parametrize("S,chunks", [(1, 1), (16, 1), (17, 2), (512, 32),
                                      (131, 9)])
def test_checkpoints_every_16_steps(S, chunks):
    assert sbwd.checkpoint_shape(2, S, 16384, 16) == (2, chunks, 16384, 16)


def test_the_checkpoint_interval_is_the_one_the_kernels_are_built_for():
    """The interval that sizes the checkpoints is the one both selective-scan
    sources take from their shared header (each C entry refuses another)."""
    header = (Path(sbwd.__file__).parents[2] / "csrc"
              / "ssm_checkpoint.cuh").read_text()
    assert f"constexpr int kSsmCheckpoint = {sbwd.CHECKPOINT};" in header
    for src in ("ssm_scan.cu", "ssm_scan_bwd.cu"):
        text = (Path(sbwd.__file__).parents[2] / "csrc" / src).read_text()
        assert '#include "ssm_checkpoint.cuh"' in text
        assert "= kSsmCheckpoint;" in text


def test_blocks_per_row_of_the_ssm_backward():
    assert sbwd.blocks_per_row(16384, 16) == 512      # 32 channels a block
    assert sbwd.blocks_per_row(16384, 8) == 256       # 64 channels a block
    assert sbwd.blocks_per_row(100, 8) == 2


def test_train_card_param_count_matches_jax():
    """jamba's TRAIN_CARD (layer 0 at every published width) counts what the
    JAX package counts for the same cut: about 2.1 B, of which the embedding
    and the untied head 1.07 B, the Mamba mixer 420 M, the dense FFN 604 M."""
    jcfg = dataclasses.replace(jax_get_arch("jamba-1.5-large-398b").model,
                               num_layers=1)
    n = tapi.param_count(TRAIN_CARD)
    assert n == japi.param_count(jcfg)
    d, f, v = TRAIN_CARD.d_model, TRAIN_CARD.d_ff, TRAIN_CARD.vocab_size
    assert 2 * v * d == 1_073_741_824
    assert 3 * d * f == 603_979_776
    mixer = n - 2 * v * d - 3 * d * f
    assert 419e6 < mixer < 421e6 + 3 * d        # and two norms of d
    assert TRAIN_CARD.layer_kinds() == ["ssm"] and TRAIN_CARD.moe is not None


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "jamba-1.5-large-398b"])
def test_trainer_takes_two_steps_of_a_recurrent_model(arch, tmp_path):
    losses = main(["--arch", arch, "--smoke", "--device", "cpu", "--steps",
                   "2", "--batch", "2", "--seq", "40", "--ckpt-dir",
                   str(tmp_path), "--log-every", "1"])
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert (tmp_path / "step_000000002").is_dir()


def test_trainer_takes_a_config_of_its_own(tmp_path):
    """``main(argv, cfg=...)`` trains the config given (a cut of a registered
    one, named by ``--arch``), with ``--dtype`` still setting its dtypes."""
    cfg = dataclasses.replace(get_arch("rwkv6-1.6b").smoke, num_layers=1)
    losses = main(["--arch", cfg.name, "--device", "cpu", "--steps", "1",
                   "--batch", "1", "--seq", "16", "--ckpt-dir",
                   str(tmp_path)], cfg=cfg)
    assert len(losses) == 1 and np.isfinite(losses).all()


@pytest.mark.parametrize("argv", [["--arch", "rwkv6-1.6b"],
                                  ["--arch", "jamba-1.5-large-398b",
                                   "--smoke"]])
def test_trainer_refuses_flags_that_contradict_its_config(argv, tmp_path):
    """With a config given, ``--arch`` must name it and ``--smoke`` (which
    picks another config) is refused, before anything is built."""
    with pytest.raises(ValueError, match="--arch must name it"):
        main(argv + ["--device", "cpu", "--steps", "1", "--ckpt-dir",
                     str(tmp_path)], cfg=TRAIN_CARD)
