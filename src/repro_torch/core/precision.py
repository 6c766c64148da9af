"""Precision-policy API: one frozen type describing how matmuls execute.

Port of ``repro/core/precision.py``.  ``PrecisionPolicy.fp32()`` is the
digital baseline, ``w8a8()`` the DiffLight W8A8 path (C1: per-output-
channel weight scales, dynamic per-row activation scales) and
``w8a8_noise()`` adds the analog perturbation model of
``core/photonic/noise.py``.  ``NoiseKeyStream`` / ``stream_for`` hand
each noisy matmul its own key (``core/prng``), so a whole network draws
the reference's noise under the same key.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

from repro_torch.core import prng
from repro_torch.core.photonic.noise import NoiseModel

#: request-level precision names accepted by the serving engine
PRECISION_NAMES = ('fp32', 'w8a8', 'w8a8+noise')

#: 'dynamic': weights quantized at each call; 'prequant': weights stored
#: as QTensors at build time (activations are dynamic either way)
CALIBRATIONS = ('dynamic', 'prequant')


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    backend: str = 'fp32'                  # 'fp32' | 'w8a8'
    bits: int = 32                         # operand bit-width
    noise: Optional[NoiseModel] = None     # analog perturbations (w8a8 only)
    noise_seed: int = 0
    n_channels: int = 36                   # WDM channels (crosstalk model)
    calibration: str = 'dynamic'

    def __post_init__(self):
        if self.backend not in ('fp32', 'w8a8'):
            raise ValueError(f'unknown precision backend {self.backend!r}')
        if self.calibration not in CALIBRATIONS:
            raise ValueError(f'unknown calibration {self.calibration!r}')
        if self.backend == 'fp32' and self.noise is not None:
            raise ValueError('noise model requires the w8a8 backend')

    @classmethod
    def fp32(cls) -> 'PrecisionPolicy':
        return cls()

    @classmethod
    def w8a8(cls, calibration: str = 'dynamic') -> 'PrecisionPolicy':
        return cls(backend='w8a8', bits=8, calibration=calibration)

    @classmethod
    def w8a8_noise(cls, model: Optional[NoiseModel] = None,
                   noise_seed: int = 0,
                   n_channels: int = 36) -> 'PrecisionPolicy':
        return cls(backend='w8a8', bits=8, noise=model or NoiseModel(),
                   noise_seed=noise_seed, n_channels=n_channels)

    @classmethod
    def from_name(cls, name: str) -> 'PrecisionPolicy':
        if name == 'fp32':
            return cls.fp32()
        if name == 'w8a8':
            return cls.w8a8()
        if name == 'w8a8+noise':
            return cls.w8a8_noise()
        raise ValueError(f'unknown precision {name!r} '
                         f'(expected one of {PRECISION_NAMES})')

    @property
    def name(self) -> str:
        if self.backend == 'fp32':
            return 'fp32'
        return 'w8a8+noise' if self.noise is not None else 'w8a8'

    @property
    def quantized(self) -> bool:
        return self.backend == 'w8a8'

    @property
    def noisy(self) -> bool:
        return self.noise is not None


def resolve(policy: Union[PrecisionPolicy, str, None] = None
            ) -> PrecisionPolicy:
    """Coerce a policy, a precision name or None (fp32) to a policy."""
    if policy is None:
        return PrecisionPolicy.fp32()
    if isinstance(policy, str):
        return PrecisionPolicy.from_name(policy)
    return policy


class NoiseKeyStream:
    """Key dispenser for analog-noise injection: each noisy matmul call
    site gets ``fold_in(base, i)`` with a counter that advances per call,
    so every layer draws independent noise while the whole network stays
    deterministic under a fixed base key.  A stream built from ``None``
    dispenses ``None`` (no noise), so callers never branch.
    ``first_sample``: the batch's first sample in the larger batch the
    noise is drawn over (a shard of the engine's slot axis), which every
    noisy matmul of the stream takes."""

    def __init__(self, base_key: Optional[prng.Key], first_sample: int = 0):
        self._base = base_key
        self._i = 0
        self.first_sample = first_sample

    def next(self) -> Optional[prng.Key]:
        if self._base is None:
            return None
        k = prng.fold_in(self._base, self._i)
        self._i += 1
        return k


def stream_for(policy: PrecisionPolicy,
               noise_key: Optional[prng.Key] = None,
               first_sample: int = 0) -> NoiseKeyStream:
    """The noise-key stream an apply function dispenses from: the
    caller's key when given, else the policy's seed anchor, else an inert
    stream for noise-free policies."""
    if not policy.noisy:
        return NoiseKeyStream(None)
    if noise_key is None:
        noise_key = prng.PRNGKey(policy.noise_seed)
    return NoiseKeyStream(noise_key, first_sample)
