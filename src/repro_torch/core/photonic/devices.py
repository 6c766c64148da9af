"""Optoelectronic device parameters — paper Table II, verbatim — plus the
optical loss budget of §V used to size laser power.

All latencies in seconds, powers in watts.
"""
from __future__ import annotations

import dataclasses

NS = 1e-9
PS = 1e-12
US = 1e-6
MW = 1e-3
UW = 1e-6


@dataclasses.dataclass(frozen=True)
class Device:
    name: str
    latency: float      # s
    power: float        # W


# --- Table II ---------------------------------------------------------------
EO_TUNING = Device('EO tuning', 20 * NS, 4 * UW)
TO_TUNING = Device('TO tuning', 4 * US, 27.5 * MW)        # per FSR
VCSEL = Device('VCSEL', 0.07 * NS, 1.3 * MW)
PHOTODETECTOR = Device('Photodetector', 5.8 * PS, 2.8 * MW)
SOA = Device('SOA', 0.3 * NS, 2.2 * MW)
DAC_8B = Device('DAC (8-bit)', 0.29 * NS, 3 * MW)
ADC_8B = Device('ADC (8-bit)', 0.82 * NS, 3.1 * MW)
COMPARATOR = Device('Comparator', 623.7 * PS, 0.055 * MW)
SUBTRACTOR = Device('Subtractor', 719.95 * PS, 0.0028 * MW)
LUT = Device('LUT', 222.5 * PS, 4.21 * MW)

TABLE_II = [EO_TUNING, TO_TUNING, VCSEL, PHOTODETECTOR, SOA, DAC_8B, ADC_8B,
            COMPARATOR, SUBTRACTOR, LUT]


# --- optical losses (§V) ----------------------------------------------------
PROPAGATION_LOSS_DB_PER_CM = 1.0
SPLITTER_LOSS_DB = 0.13
MR_THROUGH_LOSS_DB = 0.02
MR_MODULATION_LOSS_DB = 0.72
MAX_MRS_PER_WAVEGUIDE = 36           # Lumerical-verified WDM limit (§V)
WAVEGUIDE_LENGTH_CM = 0.8            # per MR-bank column path (layout est.)
GROUP_INDEX = 4.2                    # Si waveguide -> propagation delay


def propagation_delay(length_cm: float = WAVEGUIDE_LENGTH_CM) -> float:
    c_cm_per_s = 2.998e10
    return length_cm * GROUP_INDEX / c_cm_per_s


def path_loss_db(n_mrs_on_waveguide: int,
                 length_cm: float = WAVEGUIDE_LENGTH_CM) -> float:
    """Loss along one waveguide: propagation + splitter + through losses of
    the other MRs + 2 modulation events (activation bank + weight bank)."""
    assert n_mrs_on_waveguide <= MAX_MRS_PER_WAVEGUIDE, \
        f'{n_mrs_on_waveguide} MRs exceeds the 36-MR WDM crosstalk limit'
    return (PROPAGATION_LOSS_DB_PER_CM * length_cm
            + SPLITTER_LOSS_DB
            + MR_THROUGH_LOSS_DB * max(n_mrs_on_waveguide - 2, 0)
            + 2 * MR_MODULATION_LOSS_DB)


def laser_power_factor(n_mrs_on_waveguide: int) -> float:
    """Multiplier on per-wavelength laser power to overcome path losses
    (PD sensitivity fixed)."""
    return 10.0 ** (path_loss_db(n_mrs_on_waveguide) / 10.0)
