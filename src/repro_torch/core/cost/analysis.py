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
* **Collectives** (a step under a mesh, its tensors DTensors): each op of
  the functional collectives (``_c10d_functional``) counts its operand's
  bytes under its kind, "all-reduce", "all-gather", "reduce-scatter" or
  "all-to-all", and one in ``collective_count``; its operand and output
  count in ``hbm_bytes`` too, as the walker counts a collective's.
  Everything is counted per device: an op on DTensors is handed on to
  DTensor (the mode returns ``NotImplemented``), which runs it as ops on
  this rank's local shards and its redistributions as collectives, and
  those are what the mode counts, once each.  The arguments' bytes are
  their local shards'.
"""
from __future__ import annotations

import sys
import time
import weakref
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import torch
from torch.distributed.tensor import DTensor, _sharding_prop
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

# the functional collectives by name, and the walker's kind of each
_COLLECTIVES = {"all_reduce": "all-reduce", "all_reduce_": "all-reduce",
                "all_reduce_coalesced": "all-reduce",
                "all_gather_into_tensor": "all-gather",
                "all_gather_into_tensor_coalesced": "all-gather",
                "reduce_scatter_tensor": "reduce-scatter",
                "reduce_scatter_tensor_coalesced": "reduce-scatter",
                "all_to_all_single": "all-to-all"}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd")

# DTensor's sharding propagator (see _inferring_shapes), imported so that a
# PyTorch that moves it fails here, rather than count its shape inference
# as ops of the step
_PROPAGATOR_FILE = _sharding_prop.__file__

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
    """The tensors of a tree, a DTensor as its local shard."""
    return [x._local_tensor if isinstance(x, DTensor) else x
            for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _inferring_shapes() -> bool:
    """Whether DTensor's sharding propagator is running the op: the first
    time it meets an op's input layout it runs the op on ``meta`` tensors
    of the global shapes to learn the output's shape, which is no op of
    the step."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_filename == _PROPAGATOR_FILE:
            return True
        f = f.f_back
    return False


def collective_kind(func) -> str:
    """The walker's kind of a functional collective, "bookkeeping" for the
    namespace's other ops (waits and autograd wrappers, which move
    nothing), else ""."""
    if func.namespace not in _COLLECTIVE_NAMESPACES:
        return ""
    return _COLLECTIVES.get(func._overloadpacket.__name__, "bookkeeping")


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
        self.collective_bytes: Dict[str, int] = defaultdict(int)
        self.collective_count = 0
        self._dtensors = False
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
        if any(issubclass(t, DTensor) for t in types):
            self._dtensors = True
            return NotImplemented     # counted as DTensor's local ops
        kwargs = kwargs or {}
        if self._dtensors and _inferring_shapes():
            return func(*args, **kwargs)
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        outs = _tensors(out)
        kind = collective_kind(func)
        if kind == "bookkeeping":             # waits, autograd wrappers
            self._add(str(packet), 0, 0)
            return out
        if kind:
            operand = _tensors((args, kwargs))[0]
            nbytes = tensor_bytes(operand)
            self.collective_bytes[kind] += nbytes
            self.collective_count += 1
            self._add(str(packet), 0,
                      nbytes + sum(tensor_bytes(t) for t in outs))
            for t in outs:
                self._hold(t)
            return out
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
        """The walker's keys (``analyze_compiled``'s, per device), ``by_op``
        and ``storages``, the number of storages the step's ops made."""
        out_keys = {}
        for t in _tensors(outputs):
            out_keys.setdefault(_storage_key(t), t.untyped_storage().nbytes())
        return {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "collective_bytes": sum(self.collective_bytes.values()),
            "collective_breakdown": dict(sorted(
                self.collective_bytes.items())),
            "collective_count": self.collective_count,
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
