"""Request/response surface of the continuous-batching serving engine
(copy of ``repro/serving/api.py``).

A ``GenerationRequest`` is one user's image: its own seed, its own DDIM
step count, its own guidance scale, an optional latency SLO — and its own
*precision*.  ``precision`` picks the accuracy-vs-energy point the
paper's analog photonic compute exposes: ``"fp32"`` (digital baseline),
``"w8a8"`` (the 8-bit MR-bank path, ~2 orders of magnitude lower EPB) or
``"w8a8+noise"`` (8-bit plus the analog perturbation model).  The engine
multiplexes many requests into fixed-shape UNet step calls, grouping
compatible precisions per tick; a ``GenerationResult`` carries the
decoded image plus the latency breakdown, the resolved
``PrecisionPolicy``, the photonic energy attributed to exactly this
request's denoising work, and — for sampled quantized requests — the
quality delta (PSNR/MSE) against the fp32 reference.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.precision import PRECISION_NAMES, PrecisionPolicy


@dataclasses.dataclass(frozen=True)
class GenerationRequest:
    """One image-generation request.

    ``arrival_time`` is the request's nominal arrival on the serving
    clock (seconds; used by trace replay).  ``priority``: larger values
    are admitted first; FIFO within a class.  ``slo_ms``: optional
    end-to-end latency objective.  Violations of completed requests are
    always tallied in the metrics; additionally, when the engine's
    ``AdmissionQueue`` runs the ``'deadline-aware'`` shed policy, the
    SLO becomes an absolute deadline (``enqueue + slo_ms``): at the
    queue's depth bound the entry with the least slack is shed first,
    and a request whose deadline passes while queued is dropped at
    admission instead of occupying a slot.  ``precision``: one of
    ``'fp32' | 'w8a8' | 'w8a8+noise'`` — the execution policy for this
    request's UNet evaluations.

    Scheduler knobs (None = inherit the engine's defaults):

    ``cache_interval`` — DeepCache participation.  ``1`` opts this
    request out of feature caching (every tick is a full UNet pass);
    any value ``> 1`` opts in to the *engine's* shared refresh cadence
    (phase alignment means the engine interval governs the actual
    schedule, the per-request value only gates participation).

    ``exit_tol`` / ``exit_patience`` — speculative early exit: drain the
    request once the relative change of its x0 prediction,
    ``||x0_t - x0_{t-1}|| / ||x0_{t-1}||``, stays below ``exit_tol`` for
    ``exit_patience`` consecutive ticks.  ``exit_tol <= 0`` disables
    early exit for this request.

    ``trace_id`` — opaque caller-provided correlation id threaded
    through to the ``GenerationResult`` and every trace event the
    observability layer records for this request (None: the engine
    derives ``req-<request_id>``).  ``request_id`` stays the engine's
    primary key; ``trace_id`` exists so an upstream gateway can stitch
    serving spans into its own distributed trace.
    """
    request_id: int
    seed: int
    steps: int = 50
    guidance: float = 0.0
    priority: int = 0
    arrival_time: float = 0.0
    slo_ms: Optional[float] = None
    precision: str = 'fp32'
    cache_interval: Optional[int] = None
    exit_tol: Optional[float] = None
    exit_patience: Optional[int] = None
    trace_id: Optional[str] = None

    @property
    def effective_trace_id(self) -> str:
        """The caller's ``trace_id``, or the derived default."""
        return self.trace_id if self.trace_id is not None \
            else f'req-{self.request_id}'

    def __post_init__(self):
        if self.steps < 1:
            raise ValueError(f'request {self.request_id}: steps must be >=1')
        if self.precision not in PRECISION_NAMES:
            raise ValueError(
                f'request {self.request_id}: unknown precision '
                f'{self.precision!r} (expected one of {PRECISION_NAMES})')
        if self.slo_ms is not None and self.slo_ms <= 0:
            raise ValueError(f'request {self.request_id}: slo_ms must be '
                             '> 0 when given')
        if self.cache_interval is not None and self.cache_interval < 1:
            raise ValueError(f'request {self.request_id}: cache_interval '
                             'must be >= 1 when given')
        if self.exit_patience is not None and self.exit_patience < 1:
            raise ValueError(f'request {self.request_id}: exit_patience '
                             'must be >= 1 when given')


@dataclasses.dataclass
class GenerationResult:
    """Completed request: image plus timing, energy and quality accounting.

    ``policy`` is the resolved ``PrecisionPolicy`` the engine executed
    this request under.  ``quality_psnr_db`` / ``quality_mse`` compare
    the served output against the full-step fp32 reference for the same
    seed/steps/guidance — populated for quality-probed quantized,
    cached, or early-exited requests, ``None`` otherwise (full-step
    fp32 requests ARE the reference).

    Step accounting: ``steps`` is what the request *asked* for;
    ``steps_executed`` is how many denoise ticks actually ran (fewer
    when speculative early exit drained the slot), split into
    ``full_evals`` full-UNet passes and ``cached_evals`` shallow
    DeepCache passes.  ``early_exit`` marks a convergence drain.
    """
    request_id: int
    image: np.ndarray
    steps: int
    submit_time: float
    start_time: float
    finish_time: float
    energy_j: float = 0.0          # simulated DiffLight energy, this request
    epb_pj: float = 0.0            # energy-per-bit of the same workload
    precision: str = 'fp32'
    policy: Optional[PrecisionPolicy] = None
    quality_psnr_db: Optional[float] = None
    quality_mse: Optional[float] = None
    steps_executed: Optional[int] = None   # None = all requested steps ran
    full_evals: int = 0            # full-UNet denoise ticks consumed
    cached_evals: int = 0          # shallow (DeepCache skip) ticks consumed
    early_exit: bool = False       # drained by x0-convergence early exit
    trace_id: Optional[str] = None  # correlation id (request's, or derived)

    @property
    def steps_saved(self) -> int:
        """Requested-minus-executed steps (0 when the full trajectory ran)."""
        if self.steps_executed is None:
            return 0
        return self.steps - self.steps_executed

    @property
    def queue_delay_s(self) -> float:
        return self.start_time - self.submit_time

    @property
    def service_s(self) -> float:
        return self.finish_time - self.start_time

    @property
    def latency_s(self) -> float:
        return self.finish_time - self.submit_time
