"""A traced slice of a window, reduced to what the per-layer metrics and
the result line's ``breakdown`` read.

``Slice`` runs ``torch.profiler`` over whole ticks or steps, between two
device synchronisations.  On the GPU it records the device's activity
alone (kernels, copies, fills, and the CUDA runtime calls that launched
them), not every host operation: recording each of the thousands of
host operations a decode step dispatches would stretch the slice's wall
and read the profiler's cost as idle device time.  The slice's bounds
and the benchmark's own host ranges (``host_range``) are read from the
host's clock, on the profiler's time base (Unix nanoseconds).  ``end``
closes the slice and stops the profiler (left recording, it slows the
rest of the window); ``stop`` reduces its events in memory, which takes
seconds and so waits for the window's close (nothing is written to
disk).

* device operations: every event on the device inside the slice, each
  once (an event the profiler reports twice, with the same name, stream
  and interval, counts once), and on one stream in the order they run:
  where a kernel's reported start falls before the end of the one ahead
  of it on its stream (a launch let in early, waiting on its
  predecessor), its time starts at that end;
* ``busy_s``: the union of their intervals (kernels that overlap on two
  streams count once), and ``idle = 1 - busy_s / window_s``;
* ``kernel_s(pattern)``: the summed time of the operations whose name
  holds ``pattern``;
* ``idle_gaps``: each stretch of the slice with nothing on the device,
  named by what the host was doing at its midpoint (the innermost
  benchmark range and the innermost runtime call, or host operation on
  a CPU run), summed by name.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import time
from typing import Dict, List, Optional, Tuple

import torch

#: the slice that is recording, if any: ``host_range`` writes into it
_active: Optional['Slice'] = None


@contextlib.contextmanager
def host_range(name: str):
    """Mark what the host does, for naming the idle gaps of a recording
    slice; costs two clock reads when one records, nothing otherwise."""
    sl = _active
    if sl is None:
        yield
        return
    t0 = time.time_ns()
    try:
        yield
    finally:
        sl.ranges.append((t0, time.time_ns(), name, True))


def prime(device: torch.device) -> None:
    """Start and stop the profiler once, in set-up: its first start sets
    up the device's tracing (seconds on the GPU), which would otherwise
    hold up the window where the slice starts."""
    Slice(device).start().end()


class Slice:
    def __init__(self, device: torch.device):
        self.device = device
        self.prof = None
        self.window_s = 0.0
        self.busy_s = 0.0
        self.ops: List[Tuple[str, int, int]] = []     # name, start, end (ns)
        self.ranges: List[tuple] = []                 # start, end, name, True
        self.gaps: Dict[str, float] = {}
        self.duplicates = 0
        self.streams = 0
        self.overlap_s = 0.0         # time clipped off by stream order
        self.exit_s = 0.0            # what stopping the profiler took
        self._lo = self._hi = None

    def _sync(self):
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    def start(self) -> 'Slice':
        global _active
        from torch.profiler import ProfilerActivity, profile
        cuda = self.device.type == 'cuda'
        self._sync()
        self.prof = profile(activities=[ProfilerActivity.CUDA if cuda
                                        else ProfilerActivity.CPU])
        self.prof.__enter__()
        self._sync()
        self._lo = time.time_ns()
        _active = self
        return self

    def end(self) -> None:
        """Close the slice: a device sync, the host clock's reading, and
        the profiler stopped."""
        global _active
        self._sync()
        self._hi = time.time_ns()
        _active = None
        t = time.perf_counter()
        self.prof.__exit__(None, None, None)
        self.exit_s = time.perf_counter() - t

    def stop(self) -> 'Slice':
        """Reduce what the slice recorded."""
        self._reduce()
        return self

    def _reduce(self) -> None:
        lo, hi = self._lo, self._hi
        host, dev = [], set()
        n_dev = 0
        for e in self.prof.profiler.kineto_results.events():
            s, d = e.start_ns(), e.duration_ns()
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                if not e.is_user_annotation():
                    n_dev += 1
                    dev.add((e.name(), s, s + d, e.device_resource_id()))
            elif not e.is_user_annotation():
                host.append((s, s + d, e.name(), False))
        self.duplicates = n_dev - len(dev)
        ops, clipped = _in_stream_order(dev)
        self.streams = len({o[3] for o in dev})
        self.overlap_s = clipped * 1e-9
        self.window_s = (hi - lo) * 1e-9
        self.ops = [(n, max(s, lo), min(e, hi)) for n, s, e in ops
                    if e > lo and s < hi]
        busy, gaps = _union(self.ops, lo, hi)
        self.busy_s = busy * 1e-9
        self.gaps = _name_gaps(gaps, host + self.ranges)

    def kernel_s(self, *patterns: str) -> float:
        return sum(e - s for n, s, e in self.ops
                   if any(p in n for p in patterns)) * 1e-9

    def top_ops(self, k: int = 10) -> List[list]:
        by = collections.Counter()
        for n, s, e in self.ops:
            by[n[:120]] += (e - s) * 1e-9
        return [[n, v] for n, v in by.most_common(k)]

    def top_gaps(self, k: int = 10) -> List[list]:
        return [[n, v] for n, v in sorted(self.gaps.items(),
                                          key=lambda kv: -kv[1])[:k]]


def _in_stream_order(dev):
    """(name, start, end) of (name, start, end, stream) events, each
    starting no earlier than the end of the one ahead of it on its
    stream; and the nanoseconds so clipped."""
    out, clipped, stream, cur = [], 0, None, 0
    for n, s, e, st in sorted(dev, key=lambda o: (o[3], o[1], o[2])):
        if st != stream:
            stream, cur = st, s
        s2 = min(max(s, cur), e)
        clipped += s2 - s
        out.append((n, s2, e))
        cur = max(cur, e)
    return out, clipped


def _union(ops, lo: int, hi: int):
    """(busy ns, idle gaps [(start, end)]) of the intervals within
    [lo, hi]."""
    busy, gaps, cur = 0, [], lo
    for _, s, e in sorted(ops, key=lambda o: o[1]):
        if s > cur:
            gaps.append((cur, s))
        if e > cur:
            busy += e - max(s, cur)
            cur = e
    if hi > cur:
        gaps.append((cur, hi))
    return busy, gaps


def _name_gaps(gaps, host) -> Dict[str, float]:
    """Seconds of idle device time by what the host was doing: ``host``
    holds (start, end, name, is a benchmark range)."""
    ranges = sorted(h for h in host if h[3])
    ops = sorted(h for h in host if not h[3])
    out: Dict[str, float] = collections.defaultdict(float)
    for gs, ge in gaps:
        mid = (gs + ge) // 2
        label = _innermost(ranges, mid, len(ranges))
        op = _innermost(ops, mid, 400)
        out[f'{label or "-"}/{op or "-"}'] += (ge - gs) * 1e-9
    return dict(out)


def _innermost(events, t: int, look: int) -> Optional[str]:
    """The name of the latest-starting of the last ``look`` events started
    by ``t`` that is still running at ``t``."""
    i = bisect.bisect_right(events, (t, float('inf')))
    for s, e, name, _ in reversed(events[max(0, i - look):i]):
        if e >= t:
            return name
    return None
