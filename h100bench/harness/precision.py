"""The precisions an image request may carry, and what each is to the
driver, the work counts and the reference: ``fp32``; ``w8a8``, every
attention projection on the W8A8 rule through the port's int8 GEMM;
``w8a8+noise``, the same rule with the analog perturbation of
``reference/noise.py`` drawn per tick and slot, a float32 product of
perturbed integers and no int8 GEMM."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Precision:
    name: str
    #: the projections run on the port's int8 GEMM (the work counts)
    int8_gemm: bool
    #: the reference's projections on the W8A8 rule
    quant: bool
    #: a perturbation drawn per tick and slot
    noisy: bool


PRECISIONS = {p.name: p for p in (Precision('fp32', False, False, False),
                                  Precision('w8a8', True, True, False),
                                  Precision('w8a8+noise', False, True, True))}


def of(name: str) -> Precision:
    if name not in PRECISIONS:
        raise ValueError(f'unknown precision {name!r} (one of '
                         f'{", ".join(PRECISIONS)})')
    return PRECISIONS[name]
