"""Per-tick precision grouping, port of the grouping half of
``repro/serving/batcher.py``: one engine serves fp32 and w8a8 requests
side by side by running one masked step per precision group each tick."""
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


def plan_tick(precisions: Sequence[Optional[str]]
              ) -> List[Tuple[str, np.ndarray]]:
    """The ordered step-dispatch plan of one tick: ``[(precision, mask)]``,
    one masked step per occupied precision group, in sorted order so a
    slot state always gives the same plan."""
    groups = group_by_precision(precisions)
    return [(name, groups[name]) for name in sorted(groups)]
