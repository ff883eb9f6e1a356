"""Checkpointing (PyTorch twin of ``repro.checkpoint.manager``): npz +
JSON manifest, atomic commit, asynchronous writer, auto-resume.

Layout (the reference's):
  <dir>/step_000123/
      manifest.json        (step, shapes, dtypes, extra)
      shard_0.npz          (every leaf, flattened "/"-joined keys as "|")
  <dir>/LATEST             (atomic pointer file -> "step_000123")

Fault-tolerance contract:
  * a checkpoint directory is visible in LATEST only after it is fully
    written and fsync'd (write to a temporary directory + atomic rename);
  * ``save`` copies the tensors to host memory before it returns, so the
    trainer may update them in place while the write runs.

Tensors go to NumPy through a host copy (``.detach().to("cpu",
copy=True).numpy()``) and come back to the
device ``restore`` is given.  NumPy has no bfloat16 of its own: a bfloat16
leaf is stored as its 16-bit pattern (uint16) and the manifest says
"bfloat16", the dtype name the reference's manifest gives such a leaf.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


def _flatten(tree, prefix="") -> Dict[str, Any]:
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}/{k}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}/{i}"))
    else:
        out[prefix] = tree
    return out


def _unflatten(flat: Dict[str, Any]):
    root: Dict[str, Any] = {}
    for path, v in flat.items():
        parts = [p for p in path.split("/") if p]
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return root


def _to_host(leaf) -> Tuple[np.ndarray, str]:
    """(array to store, dtype name for the manifest)."""
    if isinstance(leaf, torch.Tensor):
        # a copy even for a CPU tensor: the trainer updates it in place
        # while the write runs
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _from_host(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    if dtype == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 async_write: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_write = async_write
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------------ save

    def save(self, step: int, state: Dict[str, Any],
             extra: Optional[Dict] = None) -> None:
        """Snapshot to host memory synchronously, write asynchronously."""
        self.wait()                       # one outstanding write at a time
        host_state = {k: _to_host(v) for k, v in _flatten(state).items()}
        if self.async_write:
            self._thread = threading.Thread(
                target=self._write, args=(step, host_state, extra or {}),
                daemon=True)
            self._thread.start()
        else:
            self._write(step, host_state, extra or {})

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _write(self, step: int, host_state, extra: Dict) -> None:
        try:
            name = f"step_{step:09d}"
            final_dir = os.path.join(self.directory, name)
            tmp_dir = tempfile.mkdtemp(prefix=f".{name}.",
                                       dir=self.directory)
            manifest = {
                "step": step,
                "time": time.time(),
                "leaves": {k: {"shape": list(arr.shape), "dtype": dtype}
                           for k, (arr, dtype) in host_state.items()},
                "extra": extra,
            }
            np.savez(os.path.join(tmp_dir, "shard_0.npz"),
                     **{k.replace("/", "|"): arr
                        for k, (arr, _) in host_state.items()})
            with open(os.path.join(tmp_dir, "manifest.json"), "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            if os.path.exists(final_dir):
                shutil.rmtree(final_dir)
            os.rename(tmp_dir, final_dir)                  # atomic commit
            self._write_latest(name)
            self._gc()
        except BaseException as e:        # surfaced on next wait()
            self._error = e

    def _write_latest(self, name: str) -> None:
        tmp = os.path.join(self.directory, ".LATEST.tmp")
        with open(tmp, "w") as f:
            f.write(name)
            f.flush()
            os.fsync(f.fileno())
        os.rename(tmp, os.path.join(self.directory, "LATEST"))

    def _gc(self) -> None:
        steps = sorted(d for d in os.listdir(self.directory)
                       if d.startswith("step_"))
        for d in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, d),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore

    def latest_step(self) -> Optional[int]:
        path = os.path.join(self.directory, "LATEST")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            name = f.read().strip()
        if not os.path.isdir(os.path.join(self.directory, name)):
            return None
        return int(name.split("_")[1])

    def restore(self, step: Optional[int] = None, device="cpu"
                ) -> Tuple[int, Dict[str, Any]]:
        """Load a checkpoint (the latest by default) as tensors on
        ``device``."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoint in {self.directory}")
        name = f"step_{step:09d}"
        d = os.path.join(self.directory, name)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        dtypes = {k: v["dtype"] for k, v in manifest["leaves"].items()}
        with np.load(os.path.join(d, "shard_0.npz")) as z:
            flat = {k.replace("|", "/"): _from_host(
                z[k], dtypes[k.replace("|", "/")], device) for k in z.files}
        return manifest["step"], _unflatten(flat)
