"""DilatedVGG (PyTorch twin of ``repro.models.dilated_vgg``).

VGG-16-style front end with the pool4/pool5 stages removed and dilation
introduced instead, a 'dense1' 1x1 stage, and bilinear upscaling, under the
layer names of the paper's Figures 5-7.  The param tree is the reference's:
``{layer: {"w": (k, k, in, out), "b": (out,)}}`` (HWIO).

Images come in NHWC, as in the reference.  Inside the stack activations are
NCHW views in ``channels_last`` memory (``permute`` of a contiguous NHWC
tensor, no copy): the layout in which cuDNN runs bf16 convolutions on the
tensor cores.  Convolutions, pooling and resizing pad as XLA's ``"SAME"``
does, which is asymmetric where the total padding is odd.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.config import ConvLayerConfig, ModelConfig
from repro_torch.models import layers as L

Params = Dict[str, Any]


def init_params(gen: torch.Generator, cfg: ModelConfig) -> Params:
    dt = L.dtype_of(cfg.param_dtype)
    p: Params = {}
    for lay in cfg.convnet.layers:
        if lay.kind in ("conv", "dense"):
            fan_in = lay.kernel * lay.kernel * lay.in_ch
            p[lay.name] = {
                "w": L._normal(gen, (lay.kernel, lay.kernel, lay.in_ch,
                                     lay.out_ch), (2.0 / fan_in) ** 0.5, dt),
                "b": torch.zeros((lay.out_ch,), dtype=dt, device=gen.device),
            }
    return p


def same_pads(n: int, kernel: int, stride: int, dilation: int = 1
              ) -> Tuple[int, int]:
    """(before, after) padding of one spatial dim of length ``n`` under
    XLA's ``"SAME"``: ``ceil(n / stride)`` outputs, the odd element of the
    total after."""
    out = -(-n // stride)
    total = max((out - 1) * stride + (kernel - 1) * dilation + 1 - n, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, kernel: int, stride: int, dilation: int,
              value: float = 0.0):
    """(x padded where the pads are asymmetric, the symmetric (H, W)
    padding left for the op itself)."""
    (ht, hb), (wl, wr) = (same_pads(n, kernel, stride, dilation)
                          for n in x.shape[-2:])
    if ht == hb and wl == wr:
        return x, (ht, wl)
    return F.pad(x, (wl, wr, ht, hb), value=value), (0, 0)


def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int,
          dilation: int) -> torch.Tensor:
    """SAME convolution of NCHW ``x`` by HWIO ``w``, bias inside the op.
    In bf16 the product accumulates in f32 and rounds once with the bias
    added."""
    x, pad = _pad_same(x, w.shape[0], stride, dilation)
    return F.conv2d(x, w.to(x.dtype).permute(3, 2, 0, 1), b.to(x.dtype),
                    stride=stride, padding=pad, dilation=dilation)


def apply_layer(p: Params, lay: ConvLayerConfig, x: torch.Tensor
                ) -> torch.Tensor:
    """One layer of the net on NCHW ``x``."""
    if lay.kind in ("conv", "dense"):
        y = _conv(x, p[lay.name]["w"], p[lay.name]["b"], lay.stride,
                  lay.dilation)
        # the convolution's backward needs its input, not its output
        return torch.relu_(y)
    if lay.kind == "pool":
        x, pad = _pad_same(x, lay.kernel, lay.stride, 1, value=-float("inf"))
        return F.max_pool2d(x, lay.kernel, lay.stride, padding=pad)
    if lay.kind == "upsample":
        h, w = x.shape[-2:]
        return F.interpolate(x, size=(h * lay.stride, w * lay.stride),
                             mode="bilinear", align_corners=False)
    raise ValueError(lay.kind)


def forward(p: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            **_) -> Tuple[torch.Tensor, torch.Tensor]:
    """Logits ``(B, H, W, num_classes)`` of ``batch["image"] (B, H, W, C)``
    in the compute dtype, and a zero aux loss."""
    x = batch["image"].to(L.dtype_of(cfg.compute_dtype)).permute(0, 3, 1, 2)
    for lay in cfg.convnet.layers:
        x = apply_layer(p, lay, x)
    return x.permute(0, 2, 3, 1), torch.zeros((), dtype=torch.float32,
                                              device=x.device)


def loss_fn(p: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            **_) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean per-pixel cross-entropy of ``batch["labels"] (B, H, W)``, the
    log-softmax in f32.  Returns (loss, {"loss", "aux", "total"})."""
    logits, aux = forward(p, cfg, batch)
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, batch["labels"].long()[..., None])[..., 0]
    loss = nll.mean()
    return loss, {"loss": loss, "aux": aux, "total": loss}
