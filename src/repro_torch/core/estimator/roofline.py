"""Closed-form roofline over a step's counted cost.

Copies of the reference's ``CompilePlan`` (the fields read here) and
``rate_table`` (``repro.core.taskgraph.compiler``) and ``roofline_terms``
(``repro.core.estimator.roofline``): three lower-bound terms of one chip,

  compute    = flops       / the matrix rate at the plan's dtype
  memory     = hbm bytes   / memory bandwidth
  collective = link bytes  / link bandwidth

and a step takes at least their largest.  No queueing, launch overhead or
padding loss enters, so it is a lower bound on the measured time.

The link term is the reference's: a step's per-device collective operand
bytes (``core.cost.analysis``) over one link's rate in one direction
(``h100_sxm``'s ``LinkModel``, 25 GB/s), as the reference's perf harness
takes it (``bidirectional_ici=False``).  An H100 has 18 such links, so
within one NVLink node the term is an upper bound on the collectives'
time, not the least it could be.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

from repro_torch.core.hw import SystemDescription


@dataclass(frozen=True)
class CompilePlan:
    """The reference plan's knob that the roofline reads, the products'
    dtype.  Its others tile the task-graph compiler's ops, which the port
    does not build, or set the link direction: the links' rate here is one
    direction's, as the reference's perf harness takes it
    (``bidirectional_ici=False``)."""

    dtype: str = "bfloat16"


def rate_table(system: SystemDescription,
               plan: CompilePlan) -> Dict[str, float]:
    """Full-rate service rates for this system: FLOP/s for the matrix and
    vector engines at the plan's dtype, bytes/s for memory and links."""
    chip = system.chip
    return {
        "matrix": chip.compute.flops_for(plan.dtype, matrix=True),
        "vector": chip.compute.flops_for(plan.dtype, matrix=False),
        "mem": chip.memory.bandwidth,
        "ici": chip.link.bandwidth,
        "dcn": system.dcn_bandwidth,
    }


def roofline_terms(flops: float, hbm_bytes: float, coll_bytes: float,
                   system: SystemDescription,
                   plan: CompilePlan = CompilePlan(),
                   ) -> Tuple[float, float, float]:
    """(t_compute, t_memory, t_collective) seconds for aggregate footprints
    on one chip of ``system``."""
    rates = rate_table(system, plan)
    return (flops / rates["matrix"],
            hbm_bytes / rates["mem"],
            coll_bytes / rates["ici"])
