"""Precision-policy API: one frozen type describing how matmuls execute.

Port of ``repro/core/precision.py``.  ``PrecisionPolicy.fp32()`` is the
digital baseline, ``w8a8()`` the DiffLight W8A8 path (C1: per-output-
channel weight scales, dynamic per-row activation scales) and
``w8a8_noise()`` adds the analog perturbation model.  The noisy policy
can be constructed and named here, but no matmul executes it yet: it
needs a generator that reproduces the reference's threefry draws.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

#: request-level precision names accepted by the serving engine
PRECISION_NAMES = ('fp32', 'w8a8', 'w8a8+noise')

#: 'dynamic': weights quantized at each call; 'prequant': weights stored
#: as QTensors at build time (activations are dynamic either way)
CALIBRATIONS = ('dynamic', 'prequant')


@dataclasses.dataclass(frozen=True)
class NoiseModel:
    """Analog perturbations in LSBs of the 8-bit datapath (copy of
    ``repro/core/photonic/noise.py::NoiseModel``)."""
    sigma_w_lsb: float = 0.3     # MR calibration + thermal drift (weights)
    sigma_x_lsb: float = 0.2     # activation modulation error
    sigma_pd_lsb: float = 0.5    # BPD / shot noise on the accumulated sum
    crosstalk_db_per_channel: float = -28.0   # adjacent-channel isolation


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
