"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU.  Without a
card they raise: they never continue on the CPU by themselves.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def set_matmul_precision() -> None:
    """Full-precision products on the card, as the JAX reference computes.

    f32 products and convolutions stay in f32 (no TF32, which keeps about
    three decimal digits), and bf16 products reduce in f32 before the one
    rounding to bf16 (the reference's cast-before-reduce semantics).
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def resolve_device(device: Optional[Union[str, torch.device]] = "cuda"
                   ) -> torch.device:
    """``cuda`` by default; raises if a CUDA device is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        set_matmul_precision()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
