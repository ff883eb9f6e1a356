"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (``ref.py``) and its wrapper (``ops.py``; a backward's in
``bwd.py``).

Every wrapper counts its kernel's launches in ``ops.launches`` (a
backward's in ``bwd.launches``); every plain version counts its calls in
``ref.calls``.
"""

from __future__ import annotations

import functools

import torch

# per (kernel, device): int32 zeros that a kernel whose blocks split a walk
# counts its finished blocks in and leaves zero again
_COUNTERS = {}


def counters(kernel: str, device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` int32 zeros on ``device``, kept for ``kernel``."""
    buf = _COUNTERS.get((kernel, device))
    if buf is None or buf.numel() < n:
        buf = _COUNTERS[kernel, device] = torch.zeros(
            max(n, 1024), dtype=torch.int32, device=device)
    return buf


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device."""
    return _sm_count(torch.cuda.current_device() if device.index is None
                     else device.index)
