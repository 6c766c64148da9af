"""DiffLight performance/energy simulator (paper §V methodology).

Maps a UNet workload onto the DiffLight units and integrates device
activity using Table II latencies/powers:

  Residual unit  (Y blocks, KxN banks)  <- conv + transposed-conv MACs
  MHA unit       (H heads, 4 MxL + 3 MxN banks) <- Q/K/V proj, scores, attn.V
  Linear+Add     (MxL banks)            <- out-proj / time-emb MACs
  ECU            (comparator/subtractor/LUT)  <- softmax elements (Eq. 4)
  SOA blocks     <- swish activations

Pass model (one MR-bank result cycle):
  stages: imprint (DAC) -> emit (VCSEL) -> propagate -> detect (BPD)
          -> digitize (ADC)
  baseline  : t_pass = sum(stage latencies)          (no overlap)
  pipelined : t_pass = max(stage latencies)          (stage-level overlap)
  DAC sharing (2 columns / DAC set): imprint stage runs twice; under
  pipelining it stays hidden beneath the ADC stage, in baseline it adds
  t_DAC — matching the paper's "more tuning time, large energy saving".
  Inter-unit pipelining: with `pipelined`, Residual / MHA / Linear units
  overlap (latency = max over units); baseline serializes them.

Energy per pass: every DAC holds its analog value for the whole pass;
VCSELs emit for the optical flight window scaled by the loss-budget laser
factor; PDs/ADCs burn their own stage; weight-bank EO retunes amortize over
``weight_reuse`` passes.  The ECU softmax energy is per score element.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.core.photonic import devices as dev
from repro_torch.core.photonic.arch import DiffLightConfig
from repro_torch.core.photonic.workload import Workload

WEIGHT_REUSE = 64      # passes a weight tile stays resident (output tiling)


@dataclasses.dataclass
class SimReport:
    name: str
    latency_s: float
    energy_j: float
    ops: float                       # nominal (dense) ops
    unit_latency: Dict[str, float]
    unit_energy: Dict[str, float]

    @property
    def gops(self) -> float:
        return self.ops / self.latency_s / 1e9

    @property
    def epb_pj(self) -> float:
        """Energy-per-bit, pJ (8-bit operands, 2 operands per MAC)."""
        bits = 8.0 * self.ops
        return self.energy_j / bits * 1e12


def _pass_times(cfg: DiffLightConfig):
    t_prop = dev.propagation_delay()
    imprint = dev.DAC_8B.latency * (2 if cfg.dac_sharing else 1)
    stages = [imprint, dev.VCSEL.latency, t_prop,
              dev.PHOTODETECTOR.latency, dev.ADC_8B.latency]
    t_seq = sum(stages)
    t_pipe = max(stages)
    return (t_pipe if cfg.pipelined else t_seq), t_prop


def _bank_pass_energy(n_rows: int, n_cols: int, n_banks: int, t_pass: float,
                      cfg: DiffLightConfig, laser_factor: float) -> float:
    """Energy of one pass through one block built from `n_banks` MR bank
    arrays of (n_rows x n_cols)."""
    n_mrs = n_banks * n_rows * n_cols
    n_dacs = n_mrs / (2 if cfg.dac_sharing else 1)
    e_dac = n_dacs * dev.DAC_8B.power * t_pass
    t_optical = (dev.VCSEL.latency + dev.propagation_delay()
                 + dev.PHOTODETECTOR.latency)
    e_vcsel = n_cols * dev.VCSEL.power * laser_factor * t_optical
    e_pd = 2 * n_rows * dev.PHOTODETECTOR.power * dev.PHOTODETECTOR.latency
    e_adc = n_rows * dev.ADC_8B.power * dev.ADC_8B.latency
    # weight-bank EO retuning amortized over reuse
    e_tune = (n_mrs / 2) * dev.EO_TUNING.power * dev.EO_TUNING.latency \
        / WEIGHT_REUSE
    return e_dac + e_vcsel + e_pd + e_adc + e_tune


ECU_SOFTMAX_E_PER_ELEM = (
    dev.COMPARATOR.power * dev.COMPARATOR.latency +
    dev.SUBTRACTOR.power * dev.SUBTRACTOR.latency +
    2 * dev.LUT.power * dev.LUT.latency)          # max-track, sub, exp+ln

ECU_SOFTMAX_T_PER_ELEM = (dev.COMPARATOR.latency + dev.SUBTRACTOR.latency +
                          2 * dev.LUT.latency)

SOA_E_PER_ELEM = (dev.SOA.power * dev.SOA.latency +
                  dev.VCSEL.power * dev.VCSEL.latency +
                  dev.PHOTODETECTOR.power * dev.PHOTODETECTOR.latency)


def simulate(w: Workload, cfg: DiffLightConfig,
             name: str | None = None) -> SimReport:
    cfg.validate()
    t_pass, _ = _pass_times(cfg)
    laser = dev.laser_power_factor(cfg.mrs_per_waveguide())

    # --- unit workloads (MACs) ---
    convt = w.convt_macs * (1.0 - w.convt_zero_frac
                            if cfg.sparse_dataflow else 1.0)
    residual_macs = w.conv_macs + convt
    mha_macs = w.proj_macs + w.attn_score_macs + w.attn_v_macs
    linear_macs = w.linear_macs

    # --- throughput per pass (MACs) ---
    res_rate = cfg.conv_macs_per_pass * cfg.tiles
    mha_rate = cfg.mha_macs_per_pass * cfg.tiles
    lin_rate = cfg.linear_macs_per_pass * cfg.tiles

    res_passes = residual_macs / res_rate
    mha_passes = mha_macs / mha_rate
    lin_passes = linear_macs / lin_rate

    t_res = res_passes * t_pass
    t_mha = mha_passes * t_pass
    t_lin = lin_passes * t_pass
    # ECU softmax: pipelined -> concurrent with score generation (hidden);
    # baseline -> serialized behind the MHA unit, H elements in parallel
    t_ecu = 0.0 if cfg.pipelined else \
        w.softmax_elems / cfg.H * ECU_SOFTMAX_T_PER_ELEM

    if cfg.pipelined:            # inter-unit overlap
        latency = max(t_res, t_mha, t_lin)
    else:
        latency = t_res + t_mha + t_lin + t_ecu

    # --- energy ---
    e_res = res_passes * cfg.Y * _bank_pass_energy(
        cfg.K, cfg.N, 2, t_pass, cfg, laser)
    e_mha = mha_passes * cfg.H * (
        _bank_pass_energy(cfg.M, cfg.L, 4, t_pass, cfg, laser) +
        _bank_pass_energy(cfg.M, cfg.N, 3, t_pass, cfg, laser))
    e_lin = lin_passes * _bank_pass_energy(cfg.M, cfg.L, 2, t_pass, cfg,
                                           laser)
    e_ecu = w.softmax_elems * ECU_SOFTMAX_E_PER_ELEM
    e_soa = w.act_elems * SOA_E_PER_ELEM
    energy = e_res + e_mha + e_lin + e_ecu + e_soa

    return SimReport(
        name=name or w.name,
        latency_s=latency,
        energy_j=energy,
        ops=w.total_ops_nominal,
        unit_latency={'residual': t_res, 'mha': t_mha, 'linear': t_lin,
                      'ecu': t_ecu},
        unit_energy={'residual': e_res, 'mha': e_mha, 'linear': e_lin,
                     'ecu': e_ecu, 'soa': e_soa},
    )


def ablation(w: Workload) -> Dict[str, SimReport]:
    """Paper Fig. 8: baseline / S/W-opt / pipelined / DAC-sharing / all."""
    base = DiffLightConfig(sparse_dataflow=False, pipelined=False,
                           dac_sharing=False)
    return {
        'baseline': simulate(w, base, 'baseline'),
        'sw_opt': simulate(w, dataclasses.replace(
            base, sparse_dataflow=True), 'sw_opt'),
        'pipelined': simulate(w, dataclasses.replace(
            base, pipelined=True), 'pipelined'),
        'dac_sharing': simulate(w, dataclasses.replace(
            base, dac_sharing=True), 'dac_sharing'),
        'combined': simulate(w, DiffLightConfig(), 'combined'),
    }


def dse_score(w: Workload, cfg: DiffLightConfig) -> float:
    """The paper's DSE metric: maximize GOPS / EPB."""
    r = simulate(w, cfg)
    return r.gops / r.epb_pj
