"""Shares of the card's peak, from a traced slice and the work it ran
(``common.Layers``).  A share is None where there is nothing to read:
no work of the family counted, or no device time under the kernel's
name (a later change that takes the kernel off the path)."""
from __future__ import annotations

from typing import Optional

from .peaks import PEAK


def roofline(layers, family: str, *kernel_names: str) -> Optional[float]:
    """The least time of the family's calls over the device time of the
    kernels so named, in %."""
    least = layers.work.least.get(family, 0.0)
    spent = layers.slice.kernel_s(*kernel_names)
    if least <= 0.0 or spent <= 0.0:
        return None
    return 100.0 * least / spent


def mfu(layers, wall: Optional[float] = None) -> Optional[float]:
    """The least time of the model's products at the peak of their
    precision over ``wall`` (by default the slice's), in %."""
    least = sum(ops / PEAK[p] for p, ops in layers.work.model_ops.items())
    wall = layers.slice.window_s if wall is None else wall
    if least <= 0.0 or wall <= 0.0:
        return None
    return 100.0 * least / wall
