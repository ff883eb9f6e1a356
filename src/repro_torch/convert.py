"""Convert a JAX param (or cache) tree, read as NumPy, into the port's tree.

The port keeps the JAX package's layout, stacked ``stack/periods/sub0/...``
leading axis included, so the map is key for key.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch


def params_from_jax(tree: Any, device, dtype: Optional[torch.dtype] = None
                    ) -> Any:
    """Map a nested dict of arrays onto the same nesting of tensors on
    ``device``; floating leaves are cast to ``dtype`` when it is given."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device, dtype) for k, v in tree.items()}
    # np.asarray of a jax array is read-only: copy it.  NumPy has no
    # bfloat16 of its own; such leaves (ml_dtypes) pass through float32,
    # which holds every bfloat16 value exactly.
    arr = np.array(tree, copy=True)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)
