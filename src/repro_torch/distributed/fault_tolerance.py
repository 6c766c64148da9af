"""Fault-tolerance runtime: step timing, straggler detection, preemption
handling, elastic re-mesh planning.

At 1000+ nodes the failure model is: (a) hard node loss (process dies) —
covered by checkpoint/restart + elastic re-mesh; (b) slow nodes (thermal
throttling, failing HBM, network congestion) — detected here from per-step
timing statistics; (c) planned preemption (SIGTERM from the scheduler) —
handled by an immediate synchronous checkpoint.

All detection is host-side and cheap; the training loop calls
``monitor.record(step_time)`` once per step.

Copy of ``repro/distributed/fault_tolerance.py`` (pure Python; the port
keeps its own copy so it imports nothing of the JAX package).
"""
from __future__ import annotations

import dataclasses
import signal
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Tuple


@dataclasses.dataclass
class StragglerReport:
    slow_hosts: List[int]
    median_s: float
    threshold_s: float
    recommendation: str


class StepMonitor:
    """Ring-buffer of per-host step times; flags hosts persistently slower
    than `threshold` x the fleet median."""

    def __init__(self, n_hosts: int, window: int = 32,
                 threshold: float = 1.5, min_samples: int = 8):
        self.n_hosts = n_hosts
        self.window = window
        self.threshold = threshold
        self.min_samples = min_samples
        self._times: List[Deque[float]] = [deque(maxlen=window)
                                           for _ in range(n_hosts)]

    def record(self, host: int, step_time_s: float):
        self._times[host].append(step_time_s)

    def _medians(self) -> List[Optional[float]]:
        out = []
        for dq in self._times:
            if len(dq) < self.min_samples:
                out.append(None)
            else:
                s = sorted(dq)
                out.append(s[len(s) // 2])
        return out

    def check(self) -> Optional[StragglerReport]:
        meds = self._medians()
        valid = [m for m in meds if m is not None]
        if len(valid) < max(2, self.n_hosts // 2):
            return None
        fleet = sorted(valid)[len(valid) // 2]
        thr = fleet * self.threshold
        slow = [i for i, m in enumerate(meds) if m is not None and m > thr]
        if not slow:
            return None
        rec = (f're-mesh excluding hosts {slow} '
               f'(data axis {self.n_hosts} -> {self.n_hosts - len(slow)}); '
               'data pipeline is stateless-indexable so no reshuffle needed')
        return StragglerReport(slow, fleet, thr, rec)


class PreemptionHandler:
    """SIGTERM/SIGINT -> set a flag the train loop checks each step; the
    loop then writes a synchronous checkpoint and exits cleanly."""

    def __init__(self, install: bool = True):
        self.preempted = False
        self._prev: Dict[int, object] = {}
        if install:
            for sig in (signal.SIGTERM,):
                try:
                    self._prev[sig] = signal.signal(sig, self._handler)
                except ValueError:   # not main thread (tests)
                    pass

    def _handler(self, signum, frame):
        self.preempted = True

    def uninstall(self):
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)


def elastic_serving_plan(n_healthy_devices: int, slots_per_device: int = 1
                         ) -> Tuple[Tuple[int, ...], Tuple[str, ...], int]:
    """Serving-side elastic plan: the slot-sharded engine's mesh is 1-D
    (every device is a slot shard on the ``data`` axis), so the largest
    mesh over the healthy devices is simply all of them.  Returns
    ``(mesh_shape, axis_names, slots)`` where ``slots`` keeps the
    per-device slot budget constant — dropping devices shrinks the slot
    buffer instead of overloading the survivors, rejoining devices grow
    it back.  The engine re-places in-flight latents into the resized
    buffer and parks any overflow, so a resize never kills a request."""
    if n_healthy_devices < 1:
        raise ValueError('not enough devices for one slot shard')
    if slots_per_device < 1:
        raise ValueError('slots_per_device must be >= 1')
    return ((n_healthy_devices,), ('data',),
            n_healthy_devices * slots_per_device)


def elastic_plan(n_healthy_hosts: int, model_parallel: int = 16
                 ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """Largest (pod, data, model) mesh that fits the healthy hosts
    (8 chips/host).  Keeps the model axis intact (TP degree is a property of
    the model sharding); sheds data-parallel replicas first, then pods."""
    chips = n_healthy_hosts * 8
    model = model_parallel
    rows = chips // model
    if rows == 0:
        raise ValueError('not enough chips for one model replica')
    if rows >= 32:
        return ((rows // 16, 16, model), ('pod', 'data', 'model'))
    return ((rows, model), ('data', 'model'))
