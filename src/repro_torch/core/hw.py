"""Virtual hardware description (PyTorch port's copy of the dataclasses of
``repro.core.hw``), with the one system the port runs on: an NVIDIA H100
SXM.

A :class:`SystemDescription` is the paper's "system description file": a
chip's compute engines, memories and links, and the topology they sit in.
The roofline (``repro_torch.core.estimator.roofline``) reads its rates; its
JSON is the reference's, so ``repro.core.hw.SystemDescription.from_json``
loads what :meth:`SystemDescription.to_json` writes.
"""
from __future__ import annotations

import dataclasses
import json
import typing
from dataclasses import dataclass, field
from typing import Dict, Tuple

# ---------------------------------------------------------------------------
# Component models (all non-functional: timing + transactions only)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ComputeEngineModel:
    """A matrix/vector compute engine (tensor cores and CUDA cores on a
    GPU)."""

    name: str = "nce"
    # peak matrix FLOP/s (1 multiply-add = 2 FLOPs) at dtype_scale 1.0
    matrix_flops: float = 197e12
    vector_flops: float = 4e12          # elementwise FLOP/s
    # dims must be multiples of `align` for full efficiency
    align: int = 128
    # fixed per-task launch overhead, seconds
    launch_overhead: float = 1.2e-6
    dtype_scale: Dict[str, float] = field(
        default_factory=lambda: {"bfloat16": 1.0, "float32": 0.5, "int8": 2.0}
    )

    def flops_for(self, dtype: str, matrix: bool = True) -> float:
        base = self.matrix_flops if matrix else self.vector_flops
        return base * self.dtype_scale.get(dtype, 1.0)


@dataclass(frozen=True)
class MemoryModel:
    """Device memory and its DMA (HBM on a GPU)."""

    name: str = "hbm"
    bandwidth: float = 819e9            # bytes/s
    latency: float = 1.0e-6             # per-transaction latency, seconds
    capacity: int = 16 * 1024**3        # bytes
    num_dma_engines: int = 2            # concurrent outstanding DMA streams


@dataclass(frozen=True)
class OnChipMemoryModel:
    """Scratchpad a kernel tiles against (shared memory and L1 on a GPU)."""

    name: str = "vmem"
    capacity: int = 128 * 1024**2       # bytes
    bandwidth: float = 8e12             # effectively not the bottleneck


@dataclass(frozen=True)
class LinkModel:
    """One interconnect link (NVLink on a GPU)."""

    name: str = "ici"
    bandwidth: float = 50e9             # bytes/s per direction per link
    latency: float = 1.0e-6


@dataclass(frozen=True)
class ChipModel:
    """One chip: compute + memory hierarchy + links to neighbours."""

    name: str = "tpu_v5e"
    compute: ComputeEngineModel = field(default_factory=ComputeEngineModel)
    memory: MemoryModel = field(default_factory=MemoryModel)
    onchip: OnChipMemoryModel = field(default_factory=OnChipMemoryModel)
    link: LinkModel = field(default_factory=LinkModel)
    num_links: int = 4


@dataclass(frozen=True)
class SystemDescription:
    """Topology + physical annotations (the paper's system description
    file)."""

    name: str = "tpu_v5e_pod"
    chip: ChipModel = field(default_factory=ChipModel)
    # torus dims; () => single chip
    torus: Tuple[int, ...] = (16, 16)
    num_pods: int = 1
    # data-center network between pods
    dcn_bandwidth: float = 25e9         # bytes/s per host
    dcn_latency: float = 10e-6

    @property
    def num_chips(self) -> int:
        n = 1
        for t in self.torus:
            n *= t
        return n * self.num_pods

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(text: str) -> "SystemDescription":
        return load_dataclass(SystemDescription, json.loads(text))


def _coerce(tp, val):
    """Coerce a JSON value to the annotated field type (nested dataclasses,
    tuples, numeric widening); unknown shapes pass through unchanged."""
    if dataclasses.is_dataclass(tp):
        return load_dataclass(tp, val)     # raises on non-dict values
    origin = typing.get_origin(tp)
    if origin is tuple and isinstance(val, (list, tuple)):
        args = typing.get_args(tp)
        elem = args[0] if args and args[-1] is Ellipsis else None
        return tuple(_coerce(elem, v) if elem is not None else v for v in val)
    if origin is dict and isinstance(val, dict):
        return dict(val)
    if tp is float and isinstance(val, int):
        return float(val)
    return val


def load_dataclass(cls, data: Dict):
    """Nested-dataclass loader: ignores unknown keys and missing fields
    (defaults apply), recursing into dataclass-typed fields."""
    if not isinstance(data, dict):
        raise TypeError(f"expected a dict for {cls.__name__}, got "
                        f"{type(data).__name__}")
    hints = typing.get_type_hints(cls)
    kwargs = {f.name: _coerce(hints[f.name], data[f.name])
              for f in dataclasses.fields(cls) if f.name in data}
    return cls(**kwargs)


# ---------------------------------------------------------------------------
# The card the port runs on
# ---------------------------------------------------------------------------

# NVIDIA H100 SXM5 80 GB, data sheet (dense, no sparsity)
H100_BF16_FLOPS = 989e12            # tensor cores, bf16 in, f32 accumulate
H100_F32_FLOPS = 67e12              # CUDA cores, f32 FMA (TF32 off)
H100_TF32_FLOPS = 495e12            # tensor cores, TF32 in
H100_HBM_BW = 3.35e12               # bytes/s, HBM3
H100_HBM_BYTES = 80 * 10**9
H100_NVLINK_BW = 25e9               # bytes/s per link per direction
H100_NVLINKS = 18
H100_SMEM_BYTES = 132 * 228 * 1024  # shared memory of 132 SMs
# the shortest device time of one launch of the port's kernels, from
# chip_smoke.py phase 2's `launch_us` split (rowdot_kernel<float>, 2.03 us;
# NVIDIA H100 80GB HBM3, 700.00 W; PERF.md §6): no data sheet gives it
H100_LAUNCH_S = 2.03e-6


def h100_sxm() -> SystemDescription:
    """One NVIDIA H100 SXM, as the port runs it: f32 products on the CUDA
    cores (``core/device.py`` turns TF32 off), bf16 on the tensor cores."""
    return SystemDescription(
        name="h100_sxm",
        chip=ChipModel(
            name="h100_sxm",
            compute=ComputeEngineModel(
                name="sm90",
                matrix_flops=H100_BF16_FLOPS,
                vector_flops=H100_F32_FLOPS,
                align=64,
                launch_overhead=H100_LAUNCH_S,
                dtype_scale={"bfloat16": 1.0,
                             "float32": H100_F32_FLOPS / H100_BF16_FLOPS,
                             "tensorfloat32": H100_TF32_FLOPS
                             / H100_BF16_FLOPS},
            ),
            memory=MemoryModel(name="hbm3", bandwidth=H100_HBM_BW,
                               capacity=H100_HBM_BYTES),
            onchip=OnChipMemoryModel(name="smem", capacity=H100_SMEM_BYTES),
            link=LinkModel(name="nvlink", bandwidth=H100_NVLINK_BW),
            num_links=H100_NVLINKS,
        ),
        torus=(),
    )

