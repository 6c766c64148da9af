"""Bucketing, per-tick step planning and slot sizing, port of
``repro/serving/batcher.py``.  An engine multiplexes only requests that
agree on the model and the latent shape, so a fleet keys engines by
``Bucket`` (model name, resolution, channels) and ``BucketRouter``
routes to them.  Precision is not part of the bucket: one engine serves
fp32, w8a8 and w8a8+noise requests side by side by running one masked
step per precision group each tick, and with DeepCache phasing splits
each group into its refresh and skip slots.  ``offered_load``,
``overload_factor`` and ``choose_slots`` size the offered traffic
against the slot buffer by Little's law."""
from __future__ import annotations

import dataclasses
import math
from typing import (TYPE_CHECKING, Dict, List, Mapping, Optional, Sequence,
                    Tuple)

import numpy as np

from repro_torch.serving.api import GenerationRequest, GenerationResult

if TYPE_CHECKING:                                      # pragma: no cover
    from repro_torch.serving.engine import ContinuousBatchingEngine


@dataclasses.dataclass(frozen=True)
class Bucket:
    model: str
    img_size: int
    in_ch: int


def bucket_for(unet_cfg) -> Bucket:
    return Bucket(unet_cfg.name, unet_cfg.img_size, unet_cfg.in_ch)


def group_by_precision(
        precisions: Sequence[Optional[str]]) -> Dict[str, np.ndarray]:
    """``precisions[i]`` is slot i's request precision (None = free slot).
    Returns {precision: bool mask over slots}."""
    groups: Dict[str, np.ndarray] = {}
    for i, name in enumerate(precisions):
        if name is None:
            continue
        mask = groups.setdefault(name, np.zeros(len(precisions), bool))
        mask[i] = True
    return groups


def split_cache_phase(mask: np.ndarray, needs_refresh: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Split one precision group's slot mask into (refresh, skip) masks.

    ``needs_refresh[i]`` is True when slot i must run the full UNet pass
    this tick: the shared refresh cadence is at phase 0, the slot opted
    out of caching, or it has no cache yet (its first step).  Phase-aligned
    admission makes every cache-enabled slot agree on this flag, so the
    two masks mix only when some requests opted out of caching."""
    mask = np.asarray(mask, bool)
    needs_refresh = np.asarray(needs_refresh, bool)
    return mask & needs_refresh, mask & ~needs_refresh


def plan_tick(precisions: Sequence[Optional[str]],
              needs_refresh: np.ndarray,
              caching: bool) -> List[Tuple[str, bool, np.ndarray]]:
    """The ordered step-dispatch plan of one tick: ``[(precision, refresh,
    mask)]``, one masked step per occupied precision group, each group
    split into its refresh and skip submasks when DeepCache phasing is on
    (empty submasks dropped).  Without caching every entry is a full pass
    (``refresh=True``).  Precisions go in sorted order, so a slot state
    always gives the same plan."""
    plan: List[Tuple[str, bool, np.ndarray]] = []
    groups = group_by_precision(precisions)
    for name in sorted(groups):
        mask = groups[name]
        if caching:
            r_m, s_m = split_cache_phase(mask, needs_refresh)
            pairs = ((True, r_m), (False, s_m))
        else:
            pairs = ((True, mask),)
        for refresh, m in pairs:
            if m.any():
                plan.append((name, refresh, m))
    return plan


def align_slots(slots: int, n_shards: int) -> int:
    """Round a slot count up to a multiple of the mesh's slot-axis shard
    count, so the engine's ``(slots, H, W, C)`` latent buffer divides
    evenly over the ``data`` axis (every device carries the same number
    of slot rows)."""
    if slots < 1:
        raise ValueError('need at least one slot')
    if n_shards < 1:
        raise ValueError('need at least one slot shard')
    return ((slots + n_shards - 1) // n_shards) * n_shards


def _per_precision(value, key):
    return value[key] if isinstance(value, Mapping) else value


def offered_load(arrival_rate_hz, step_time_s, mean_steps) -> float:
    """Expected in-flight requests (Little's law L = lambda x W, with
    W ~ steps x step_time) for the offered traffic.  Each term may be a
    scalar or a per-precision mapping; per-precision loads add because
    the precisions share one slot buffer."""
    if isinstance(arrival_rate_hz, Mapping):
        return sum(
            rate * _per_precision(mean_steps, k) * _per_precision(
                step_time_s, k)
            for k, rate in arrival_rate_hz.items() if rate > 0)
    if arrival_rate_hz <= 0 or step_time_s <= 0 or mean_steps <= 0:
        return 0.0
    return arrival_rate_hz * mean_steps * step_time_s


def overload_factor(arrival_rate_hz, step_time_s, mean_steps,
                    slots: int) -> float:
    """Offered load over slot capacity: > 1 means arrivals exceed what
    ``slots`` concurrent requests can drain and a bounded queue WILL
    shed — the sizing anchor for overload traces (a "5x overload" trace
    has ``overload_factor == 5``)."""
    if slots < 1:
        raise ValueError('need at least one slot')
    return offered_load(arrival_rate_hz, step_time_s, mean_steps) / slots


def choose_slots(arrival_rate_hz, step_time_s, mean_steps,
                 target_util: float = 0.8, max_slots: int = 64,
                 n_shards: int = 1) -> int:
    """Little's law slot sizing: L = lambda x W, W ~ steps x step_time.

    Each load term may be a scalar or a per-precision mapping (e.g.
    ``arrival_rate_hz={'fp32': 1.0, 'w8a8': 4.0}`` with per-precision
    step times); precisions share one slot buffer, so their expected
    in-flight counts add.  Returns the slot count that keeps expected
    occupancy at ``target_util`` of the buffer, clamped to [1, max_slots].
    ``n_shards`` (the mesh's ``data``-axis size for a slot-sharded
    engine) rounds the result up so the buffer divides evenly.
    """
    in_flight = offered_load(arrival_rate_hz, step_time_s, mean_steps)
    if in_flight <= 0:
        return align_slots(1, n_shards)
    slots = max(1, min(max_slots, math.ceil(in_flight / target_util)))
    return align_slots(slots, n_shards)


class BucketRouter:
    """Routes requests to per-bucket engines and drives them together."""

    def __init__(self):
        self._engines: Dict[Bucket, 'ContinuousBatchingEngine'] = {}

    def register(self, engine: 'ContinuousBatchingEngine') -> Bucket:
        b = bucket_for(engine.pipe.unet_cfg)
        if b in self._engines:
            raise ValueError(f'bucket {b} already registered')
        self._engines[b] = engine
        return b

    def engine(self, bucket: Bucket) -> 'ContinuousBatchingEngine':
        return self._engines[bucket]

    @property
    def buckets(self) -> List[Bucket]:
        return list(self._engines)

    @property
    def busy(self) -> bool:
        return any(e.busy for e in self._engines.values())

    def submit(self, req: GenerationRequest, bucket: Optional[Bucket] = None,
               now: Optional[float] = None) -> bool:
        """Route to ``bucket``, or to the single registered engine."""
        if bucket is None:
            if len(self._engines) != 1:
                raise ValueError('ambiguous routing: specify a bucket '
                                 f'({len(self._engines)} registered)')
            bucket = next(iter(self._engines))
        return self._engines[bucket].submit(req, now=now)

    def tick(self, now: Optional[float] = None) -> List[GenerationResult]:
        out: List[GenerationResult] = []
        for e in self._engines.values():
            out.extend(e.tick(now))
        return out
