"""The check that keeps a forward-only kernel out of autograd.

A kernel wrapper writes its result into a fresh tensor through ctypes, so
the result has no ``grad_fn``: under grad mode a loss computed from it would
get no gradient for the kernel's inputs, and nothing would say so.  Every
CUDA op whose backward is not ported calls :func:`refuse_grad` before it
launches; the CPU plain versions are ordinary differentiable tensor code and
do not call it.
"""
from __future__ import annotations

import torch


def refuse_grad(name: str, *tensors) -> None:
    """Raise if grad mode is on and any of ``tensors`` requires grad."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the backward of this CUDA kernel is not ported yet, so "
            "its output would carry no gradient; call it under "
            "torch.no_grad() or with inputs that do not require grad (the "
            "plain version on CPU tensors is differentiable)")
