"""Cost of an eager PyTorch step: FLOPs, device-memory bytes and peak
memory, read from the aten ops it dispatches and the port's kernels it
launches.  The twin of ``repro.core.hlo.analysis``, which reads a compiled
XLA program's HLO; this module reads no HLO, it counts the ops of a step as
it runs, on any device: real CUDA tensors, fake or CPU tensors, or ``meta``
tensors, which hold no data (``launch/dryrun.py`` counts a full-size step
that way without allocating it).

The conventions are the reference walker's:

* **FLOPs**: matrix products only (mm, addmm, bmm, baddbmm, convolution and
  their backwards), by ``torch.utils.flop_counter``'s formulas, as the
  walker counts ``dot`` and ``convolution``.  Python loops and
  recomputation under activation checkpointing count every trip, because
  every trip dispatches its ops.
* **Bytes**: each op that is not a view reads each of its operands once and
  writes each output once.  Eager PyTorch fuses nothing, so every op is a
  "top-level instruction" in the walker's sense.  Views, aliases and
  ``empty*`` count 0; an expanded (stride-0) operand counts the elements
  it holds, once; an in-place op reads its target once and writes it once,
  and an indexed one (``index_put_``, ``index_add_``, ``scatter_``...)
  only the rows it indexes; an indexed read (``index``, ``gather``,
  ``embedding``...) reads as many elements of its source as it writes.
* **Kernels**: the port's hand-written kernels are ``ctypes`` launches that
  no dispatch mode sees.  Each wrapper calls :func:`note` with its own
  formula (its docstring states it), on the card where it launches and on
  ``meta`` where it stands in for the launch; the formula is evaluated
  only under a counter.
* **Peak**: the largest sum of live storages during the step, the step's
  arguments (params, optimizer state, inputs) included:
  ``argument_bytes + temp_bytes``, as the walker takes them from XLA's
  ``memory_analysis``.
"""
from __future__ import annotations

import time
import weakref
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

aten = torch.ops.aten

# the matrix products the walker counts (dot, convolution), and their
# backwards
_PRODUCTS = {aten.mm, aten.addmm, aten.bmm, aten.baddbmm, aten.convolution,
             aten._convolution, aten.cudnn_convolution,
             aten.convolution_backward}
# allocations without a write
_ALLOCS = {aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
           aten.new_empty_strided}
# in-place writes into the rows an index names: they touch those rows of
# their target, not the whole of it
_INDEXED = {aten.index_put_, aten._index_put_impl_, aten.index_copy_,
            aten.index_add_, aten.index_fill_, aten.scatter_,
            aten.scatter_add_, aten.scatter_reduce_, aten.masked_scatter_}
# reads of the rows an index names (an embedding lookup, a gather): they
# read as many elements of their source as they write
_GATHERS = {aten.index, aten.index_select, aten.gather, aten.embedding}

# the counter that kernel wrappers report to, if one is active
_ACTIVE = None


def note(kernel: str, cost: Callable, *args, **kwargs) -> None:
    """Add one launch of a hand-written kernel to the active counter: its
    matrix FLOPs and the bytes it reads and writes, ``cost(*args,
    **kwargs)`` by the wrapper's formula.  When no counter is active this is
    one check of a global: ``cost`` is not called."""
    if _ACTIVE is not None:
        _ACTIVE._add(kernel, *cost(*args, **kwargs))


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes of the elements ``t`` addresses: a stride-0 dimension holds one
    element, so an expanded tensor counts what it holds, once."""
    n = t.element_size()
    for size, stride in zip(t.shape, t.stride()):
        if size == 0:
            return 0
        if stride != 0:
            n *= size
    return n


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _tensors(tree) -> List[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _indexed_bytes(ins: List[torch.Tensor]) -> int:
    """Bytes of an indexed in-place write: the index and the values read
    once, and the rows it touches of its target (``ins[0]``), as many
    elements as the values (or, for a scalar fill, the index) hold, read
    once and written once."""
    target, rest = ins[0], ins[1:]
    values = [t for t in rest if t.is_floating_point() or t.is_complex()]
    region = (values[-1] if values else rest[-1]).numel()
    return sum(tensor_bytes(t) for t in rest) \
        + 2 * region * target.element_size()


def _writes(func) -> bool:
    """Whether ``func`` writes one of its arguments (in-place or out=)."""
    return any(a.alias_info is not None and a.alias_info.is_write
               for a in func._schema.arguments)


class CostCounter(TorchDispatchMode):
    """Counts the aten ops dispatched and the kernels noted while active.

    ``CostCounter(args)`` takes the step's arguments, whose storages count
    as live from the start; ``report()`` gives the walker's keys and
    ``by_op``, each op's or kernel's {"flops", "bytes", "count"}.
    """

    def __init__(self, args=()):
        super().__init__()
        self.flops = 0
        self.hbm_bytes = 0
        self.by_op: Dict[str, Dict[str, int]] = defaultdict(
            lambda: {"flops": 0, "bytes": 0, "count": 0})
        # the arguments' storages, which the caller holds for the whole step
        self._held = {_storage_key(t): t.untyped_storage().nbytes()
                      for t in _tensors(args)}
        self.argument_bytes = sum(self._held.values())
        # every other storage an op made: [bytes, live tensors that hold it]
        self._live: Dict[int, List[int]] = {}
        self.storages = 0
        self.live_bytes = self.argument_bytes
        self.peak_bytes = self.argument_bytes

    # -- the active counter -------------------------------------------------

    def __enter__(self):
        global _ACTIVE
        self._outer, _ACTIVE = _ACTIVE, self
        return super().__enter__()

    def __exit__(self, *exc):
        global _ACTIVE
        _ACTIVE = self._outer
        return super().__exit__(*exc)

    def _add(self, name: str, flops: int, nbytes: int) -> None:
        row = self.by_op[name]
        row["flops"] += int(flops)
        row["bytes"] += int(nbytes)
        row["count"] += 1
        self.flops += int(flops)
        self.hbm_bytes += int(nbytes)

    # -- live storages ------------------------------------------------------

    def _hold(self, t: torch.Tensor) -> None:
        key = _storage_key(t)
        if key in self._held:
            return
        entry = self._live.get(key)
        if entry is None:
            entry = self._live[key] = [t.untyped_storage().nbytes(), 0]
            self.storages += 1
            self.live_bytes += entry[0]
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        entry[1] += 1
        weakref.finalize(t, self._drop, key).atexit = False

    def _drop(self, key: int) -> None:
        entry = self._live[key]
        entry[1] -= 1
        if entry[1] == 0:
            self.live_bytes -= entry[0]
            del self._live[key]

    # -- dispatch -----------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        outs = _tensors(out)
        flops = 0
        if packet in _PRODUCTS:
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
        ins = _tensors((args, kwargs))
        if packet in _ALLOCS:
            nbytes = 0
        elif packet in _INDEXED:
            nbytes = _indexed_bytes(ins)
        elif packet in _GATHERS:
            nbytes = sum(tensor_bytes(t) for t in ins[1:]) \
                + 2 * sum(tensor_bytes(t) for t in outs)
        elif not _writes(func) and outs and all(
                any(_storage_key(o) == _storage_key(i) for i in ins)
                for o in outs):
            nbytes = 0                        # a view or an alias
        else:
            # each distinct operand read once, each output written once
            seen = set()
            nbytes = 0
            for written, group in ((False, ins), (True, outs)):
                for t in group:
                    key = (written, _storage_key(t), t.storage_offset(),
                           tuple(t.shape), t.stride())
                    if key not in seen:
                        seen.add(key)
                        nbytes += tensor_bytes(t)
        self._add(str(packet), flops, nbytes)
        for t in outs:
            self._hold(t)
        return out

    # -- the report ---------------------------------------------------------

    def report(self, outputs=()) -> Dict:
        """The walker's keys (``analyze_compiled``'s, one chip, no
        collectives), ``by_op`` and ``storages``, the number of storages
        the step's ops made."""
        out_keys = {}
        for t in _tensors(outputs):
            out_keys.setdefault(_storage_key(t), t.untyped_storage().nbytes())
        return {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "collective_bytes": 0,
            "collective_breakdown": {},
            "collective_count": 0,
            "argument_bytes": self.argument_bytes,
            "output_bytes": sum(out_keys.values()),
            "temp_bytes": self.peak_bytes - self.argument_bytes,
            "peak_bytes": self.peak_bytes,
            "storages": self.storages,
            "by_op": {k: dict(v) for k, v in sorted(self.by_op.items())},
        }


def analyze_step(fn: Callable, *args, **kwargs) -> Dict:
    """Run ``fn(*args, **kwargs)`` once under a :class:`CostCounter` and
    return its report, with ``trace_seconds``, the wall time of the run."""
    t0 = time.perf_counter()
    counter = CostCounter((args, kwargs))
    with counter:
        out = fn(*args, **kwargs)
    rep = counter.report(out)
    rep["trace_seconds"] = time.perf_counter() - t0
    return rep


def top_contributors(report: Dict, k: int = 20, metric: str = "bytes"
                     ) -> List[Tuple[int, int, str]]:
    """The ``k`` ops or kernels of ``report["by_op"]`` with the most
    ``metric`` ("bytes" or "flops"): (value, count, name), largest first."""
    rows = [(row[metric], row["count"], name)
            for name, row in report["by_op"].items() if row[metric]]
    rows.sort(reverse=True)
    return rows[:k]
