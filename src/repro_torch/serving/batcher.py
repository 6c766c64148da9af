"""Per-tick step planning, port of the planning half of
``repro/serving/batcher.py``: one engine serves fp32, w8a8 and
w8a8+noise requests side by side by running one masked step per
precision group each tick, and with DeepCache phasing splits each group
into its refresh and skip slots."""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


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
