"""Fault-tolerance runtime: heartbeats, failure detection, straggler
mitigation policy, restart-from-checkpoint and elastic re-mesh planning.

The port's copy of ``repro.runtime.supervisor`` (plain Python; the port
imports nothing of the JAX package).

On a real fleet each host runs a heartbeat agent; the supervisor aggregates
them and drives the restart/elastic policy.  In this single-process
container the WorkerPool is *simulated* (deterministic failure/straggler
injection hooks used by tests and the fault-tolerance example), but the
policy layer — what to do when a worker dies or lags — is the production
logic, and `plan_elastic_mesh` is what `launch/train.py --elastic` calls.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple


@dataclass
class WorkerState:
    worker_id: int
    last_heartbeat: float
    step: int = 0
    step_time_ema: float = 0.0
    alive: bool = True


@dataclass
class SupervisorConfig:
    heartbeat_interval: float = 1.0
    failure_timeout: float = 5.0          # missed-heartbeat window
    straggler_factor: float = 1.8         # x median step time => straggler
    straggler_patience: int = 3           # consecutive slow steps
    min_workers: int = 1


class Supervisor:
    """Aggregates heartbeats; decides restart / evict / rebalance."""

    def __init__(self, num_workers: int, cfg: SupervisorConfig = None,
                 clock: Callable[[], float] = time.monotonic):
        self.cfg = cfg or SupervisorConfig()
        self.clock = clock
        now = clock()
        self.workers: Dict[int, WorkerState] = {
            i: WorkerState(i, now) for i in range(num_workers)}
        self._slow_counts: Dict[int, int] = {i: 0 for i in range(num_workers)}
        self.events: List[Tuple[float, str, int]] = []

    # -------------------------------------------------------------- inputs

    def heartbeat(self, worker_id: int, step: int,
                  step_time: Optional[float] = None) -> None:
        w = self.workers[worker_id]
        w.last_heartbeat = self.clock()
        w.step = step
        if step_time is not None:
            w.step_time_ema = (0.7 * w.step_time_ema + 0.3 * step_time
                               if w.step_time_ema else step_time)

    # ------------------------------------------------------------- policy

    def check(self) -> Dict[str, List[int]]:
        """Returns {'failed': [...], 'stragglers': [...]}."""
        now = self.clock()
        failed, stragglers = [], []
        alive = [w for w in self.workers.values() if w.alive]
        times = sorted(w.step_time_ema for w in alive if w.step_time_ema > 0)
        median = times[len(times) // 2] if times else 0.0
        for w in alive:
            if now - w.last_heartbeat > self.cfg.failure_timeout:
                w.alive = False
                failed.append(w.worker_id)
                self.events.append((now, "failure", w.worker_id))
                continue
            if median > 0 and w.step_time_ema > \
                    self.cfg.straggler_factor * median:
                self._slow_counts[w.worker_id] += 1
                if self._slow_counts[w.worker_id] >= \
                        self.cfg.straggler_patience:
                    stragglers.append(w.worker_id)
                    self.events.append((now, "straggler", w.worker_id))
            else:
                self._slow_counts[w.worker_id] = 0
        return {"failed": failed, "stragglers": stragglers}

    def alive_count(self) -> int:
        return sum(1 for w in self.workers.values() if w.alive)

    def evict(self, worker_id: int) -> None:
        self.workers[worker_id].alive = False
        self.events.append((self.clock(), "evicted", worker_id))


# ---------------------------------------------------------------------------
# Elastic re-mesh planning
# ---------------------------------------------------------------------------


def plan_elastic_mesh(alive_devices: int, model_parallel: int,
                      global_batch: int) -> Dict[str, int]:
    """Largest (data, model) mesh fitting the surviving devices, keeping
    model_parallel if possible (params keep their TP layout => cheap
    reshard), shrinking data-parallel ways; global batch is preserved by
    raising per-device batch / grad-accumulation.
    """
    mp = model_parallel
    while mp > 1 and alive_devices < mp:
        mp //= 2
    data = max(1, alive_devices // mp)
    # data ways must divide the global batch: take the largest divisor
    while global_batch % data != 0:
        data -= 1
    used = data * mp
    # per-device micro-batching: accumulate so per-step per-device batch
    # stays close to the healthy-fleet value
    healthy_per_dev = max(1, global_batch // max(alive_devices // mp, 1))
    per_dev = global_batch // data
    grad_accum = 1
    while per_dev // grad_accum > healthy_per_dev * 2 \
            and (global_batch % (data * (grad_accum + 1)) == 0):
        grad_accum += 1
    return {"data": data, "model": mp, "devices_used": used,
            "grad_accum": grad_accum}


# ---------------------------------------------------------------------------
# Straggler mitigation policies
# ---------------------------------------------------------------------------


@dataclass
class MitigationAction:
    kind: str             # "none" | "rebalance" | "evict_and_remesh"
    detail: str = ""


def mitigate_stragglers(stragglers: List[int], persistent: bool
                        ) -> MitigationAction:
    """Policy: transient stragglers get data-rebalance (smaller shard via
    backup-task semantics); persistent ones are evicted and the job
    re-meshed from the last checkpoint."""
    if not stragglers:
        return MitigationAction("none")
    if not persistent:
        return MitigationAction(
            "rebalance",
            f"shrink data shard of workers {stragglers} by 50% "
            f"(backup-task dispatch)")
    return MitigationAction(
        "evict_and_remesh",
        f"evict {stragglers}, restore latest checkpoint on elastic mesh")
