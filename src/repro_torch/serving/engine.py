"""Continuous-batching diffusion engine on one device, port of
``repro/serving/engine.py``.

The engine owns a fixed ``(slots, H, W, C)`` latent buffer.  Each slot
carries one in-flight request at its own DDIM step index: every denoise
step is one UNet call with a per-sample timestep vector, so requests at
different depths share it.  Each request also carries its own precision.
Per tick:

  1. free slots are refilled from the admission queue (a request's
     initial noise comes from its own seed, exactly as
     ``DiffusionPipeline.generate`` draws it);
  2. occupied slots are grouped by precision (``batcher.plan_tick``) and
     ONE masked mixed-timestep step per group advances that group's
     slots; the other slots pass through unchanged.  A group with a
     guided slot evaluates the UNet twice (conditional and
     unconditional) and blends per slot;
  3. slots at the end of their trajectory drain through the VAE decode
     and are immediately refillable.  Sampled quantized requests also run
     an fp32 reference generation for the same seed and report PSNR/MSE
     against it.

With eta = 0 DDIM is deterministic given the initial noise, and the UNet
and the per-row w8a8 activation scales treat batch rows independently,
so a request served here matches ``DiffusionPipeline.generate(seed,
batch=1, ...)`` on its own.

The engine runs eagerly (no graph capture).  Not in this slice of the
port: DeepCache refresh/skip phases and early exit, the ``w8a8+noise``
policy, photonic energy accounting (results report ``energy_j = epb_pj =
0``), tracing, and mesh sharding; a request asking for one of the first
two is refused at ``submit``.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.precision import PrecisionPolicy
from repro_torch.diffusion import samplers
from repro_torch.diffusion.pipeline import DiffusionPipeline, initial_noise
from repro_torch.serving.api import GenerationRequest, GenerationResult
from repro_torch.serving.batcher import plan_tick
from repro_torch.serving.metrics import ServingMetrics
from repro_torch.serving.queue import AdmissionQueue


@dataclasses.dataclass
class _Active:
    """One occupied slot: the request and its trajectory cursor."""
    request: GenerationRequest
    ts: np.ndarray               # this request's DDIM timestep trajectory
    i: int                       # next step index into `ts`
    submit_time: float
    start_time: float


class ContinuousBatchingEngine:
    #: queue shed causes -> the metrics ledger's reason names
    _SHED_REASONS = {'rejected': 'queue_full', 'evicted': 'deadline_evict',
                     'expired': 'expired'}

    def __init__(self, pipe: DiffusionPipeline, slots: int = 4,
                 context: Optional[torch.Tensor] = None,
                 queue: Optional[AdmissionQueue] = None,
                 metrics: Optional[ServingMetrics] = None,
                 quality_probe: int = 1):
        """``context``: the ``(slots, T, context_dim)`` conditioning the
        conditional branch attends to (None: unconditional model).
        ``quality_probe``: run the fp32 reference + PSNR/MSE probe for
        every k-th completed quantized request (0 disables it)."""
        if slots < 1:
            raise ValueError('need at least one slot')
        self._created = time.perf_counter()   # time-to-first-tick origin
        self.pipe = pipe
        self.device = pipe.device
        self.slots = slots
        self.context = None if context is None else context.to(self.device)
        # `is not None`: an empty AdmissionQueue is falsy
        self.queue = queue if queue is not None else AdmissionQueue()
        self.metrics = metrics if metrics is not None else ServingMetrics()
        self._user_on_shed = self.queue.on_shed
        self.queue.on_shed = self._queue_shed
        self.quality_probe = quality_probe
        cfg = pipe.unet_cfg
        self._sample_shape = (cfg.img_size, cfg.img_size, cfg.in_ch)
        self.x = torch.zeros((slots,) + self._sample_shape, device=self.device)
        # previous-tick x0 predictions and the per-slot relative x0
        # movement of the last step: the convergence signal early exit
        # will read
        self.x0 = torch.zeros_like(self.x)
        self.delta = torch.zeros(slots, device=self.device)
        self._slot: List[Optional[_Active]] = [None] * slots
        self._traj: Dict[int, np.ndarray] = {}
        self._policies: Dict[str, PrecisionPolicy] = {}
        self._probe_done = 0

    # -- precision machinery ------------------------------------------------
    def _policy_for(self, name: str) -> PrecisionPolicy:
        if name not in self._policies:
            if name == 'fp32':
                pol = PrecisionPolicy.fp32()
            else:
                cal = self.pipe.policy.calibration \
                    if self.pipe.policy.quantized else 'dynamic'
                pol = PrecisionPolicy.w8a8(calibration=cal)
            self._policies[name] = pol
        return self._policies[name]

    @staticmethod
    def _finish_step(sched, eps, x, x0p, t, t_prev, active):
        """DDIM update + x0 tracking for the masked slots.  Returns (x_out,
        x0_out, delta), ``delta`` being the per-slot relative x0 movement
        ``||x0_t - x0_{t-1}|| / ||x0_{t-1}||`` (RMS over sample dims, 0 for
        inactive slots)."""
        x_new, x0_new = samplers.ddim_step(sched, eps, x, t, t_prev,
                                           return_x0=True)
        dims = tuple(range(1, x.ndim))
        num = torch.sqrt(torch.mean((x0_new - x0p) ** 2, dim=dims))
        den = torch.sqrt(torch.mean(x0p ** 2, dim=dims)) + 1e-8
        delta = torch.where(active, num / den, torch.zeros_like(num))
        mask = active.reshape((-1,) + (1,) * (x.ndim - 1))
        return (torch.where(mask, x_new, x), torch.where(mask, x0_new, x0p),
                delta)

    def _step(self, pol: PrecisionPolicy, guided: bool, t, t_prev, active,
              guidance):
        """One masked mixed-timestep step of every slot in ``active``.
        Guided: per-slot classifier-free guidance against the
        unconditional eps, only for slots with guidance > 0."""
        unet, x = self.pipe.unet, self.x
        eps = unet(x, t, self.context, pol)
        if guided:
            eps_u = unet(x, t, None, pol)
            g = guidance.reshape((-1,) + (1,) * (x.ndim - 1))
            eps = torch.where(g > 0, eps_u + g * (eps - eps_u), eps)
        return self._finish_step(self.pipe.sched, eps, x, self.x0, t, t_prev,
                                 active)

    # -- introspection -----------------------------------------------------
    @property
    def active_count(self) -> int:
        return sum(a is not None for a in self._slot)

    @property
    def busy(self) -> bool:
        return self.active_count > 0 or len(self.queue) > 0

    def _queue_shed(self, reason: str, req: GenerationRequest,
                    now: float) -> None:
        self.metrics.record_shed(self._SHED_REASONS.get(reason, reason))
        if self._user_on_shed is not None:
            self._user_on_shed(reason, req, now)

    # -- request flow ------------------------------------------------------
    def submit(self, req: GenerationRequest,
               now: Optional[float] = None) -> bool:
        if req.precision == 'w8a8+noise':
            raise ValueError(
                f'request {req.request_id}: precision w8a8+noise is not '
                'served yet; it waits for the slice of the port that adds a '
                'threefry-compatible noise generator')
        if (req.cache_interval or 1) > 1 or (req.exit_tol or 0.0) > 0.0:
            raise ValueError(
                f'request {req.request_id}: DeepCache phasing and early exit '
                'are not served yet; they wait for a later slice of the port')
        now = time.perf_counter() if now is None else now
        ok = self.queue.submit(req, now)
        if ok:
            self.metrics.record_submit(now)
        self.metrics.observe_queue_depth(len(self.queue))
        return ok

    def _trajectory(self, steps: int) -> np.ndarray:
        if steps not in self._traj:
            self._traj[steps] = samplers.ddim_timesteps(self.pipe.sched, steps)
        return self._traj[steps]

    def _admit(self, now: float) -> None:
        if self.queue.has_deadlines:
            self.queue.expire(now)     # a dead request never takes a slot
        for idx in range(self.slots):
            if self._slot[idx] is not None:
                continue
            q = self.queue.pop()
            if q is None:
                return
            req = q.request
            self._slot[idx] = _Active(
                request=req, ts=self._trajectory(req.steps), i=0,
                submit_time=q.enqueue_time, start_time=now)
            noise = initial_noise(req.seed, (1,) + self._sample_shape,
                                  self.device)[0]
            self.x[idx] = noise
            # the x0 tracker starts at the noise: the first delta is
            # meaningless
            self.x0[idx] = noise

    def _fp32_reference(self, req: GenerationRequest,
                        guided: bool) -> np.ndarray:
        """fp32 generation for the same seed/steps/guidance: the quality
        probe's reference image (context row 0 stands in for the
        engine's conditioning)."""
        ctx = self.context[:1] if (guided and self.context is not None) \
            else None
        ref = self.pipe.generate(req.seed, batch=1, steps=req.steps,
                                 context=ctx,
                                 guidance=req.guidance if guided else 0.0,
                                 policy=PrecisionPolicy.fp32())
        return ref[0].cpu().numpy()

    @staticmethod
    def _quality(image: np.ndarray, ref: np.ndarray):
        """(mse, psnr_db) of the served image vs the fp32 reference."""
        mse = float(np.mean((image.astype(np.float64) -
                             ref.astype(np.float64)) ** 2))
        rng = float(ref.max() - ref.min()) or 1.0
        psnr = math.inf if mse <= 0.0 else 10.0 * math.log10(rng * rng / mse)
        return mse, psnr

    def _drain(self, idx: int, now: float,
               wall_clock: bool) -> GenerationResult:
        """Decode a finished slot, free it, and account the result."""
        a = self._slot[idx]
        req = a.request
        self._slot[idx] = None
        # np.array copies: without a VAE the decode is a view of the slot
        # buffer, which admission overwrites in place
        image = np.array(self.pipe.decode(self.x[idx:idx + 1])[0].cpu())
        if wall_clock:
            # the device sync above makes this the time the image existed
            now = time.perf_counter()
        pol = self._policy_for(req.precision)
        guided = req.guidance > 0.0 and self.context is not None
        mse = psnr = None
        # the probe runs after the latency stamp: it is measurement
        # apparatus, not served work
        if pol.quantized and self.quality_probe > 0:
            if self._probe_done % self.quality_probe == 0:
                mse, psnr = self._quality(
                    image, self._fp32_reference(req, guided))
            self._probe_done += 1
        res = GenerationResult(
            request_id=req.request_id, image=image, steps=req.steps,
            submit_time=a.submit_time, start_time=a.start_time,
            finish_time=now, precision=req.precision, policy=pol,
            quality_psnr_db=psnr, quality_mse=mse, steps_executed=a.i,
            full_evals=a.i, trace_id=req.effective_trace_id)
        self.metrics.record_complete(res, slo_ms=req.slo_ms)
        return res

    @torch.no_grad()
    def tick(self, now: Optional[float] = None,
             wall_clock: Optional[bool] = None) -> List[GenerationResult]:
        """Admit -> one masked mixed-timestep step per precision group ->
        drain finished slots.  ``wall_clock`` (default: ``now`` not given)
        re-stamps each drained result after its device sync, so latencies
        include the last step and the decode."""
        wall_clock = (now is None) if wall_clock is None else wall_clock
        now = time.perf_counter() if now is None else now
        self._admit(now)
        if self.active_count == 0:
            return []
        t = np.zeros(self.slots, np.int64)
        t_prev = np.full(self.slots, -1, np.int64)
        guidance = np.zeros(self.slots, np.float32)
        for idx, a in enumerate(self._slot):
            if a is None:
                continue
            t[idx] = a.ts[a.i]
            t_prev[idx] = a.ts[a.i + 1] if a.i + 1 < len(a.ts) else -1
            guidance[idx] = a.request.guidance
        plan = plan_tick([a.request.precision if a is not None else None
                          for a in self._slot])
        self.metrics.record_tick(self.active_count)
        dev = self.device
        t_d = torch.from_numpy(t).to(dev)
        tp_d = torch.from_numpy(t_prev).to(dev)
        for pname, m in plan:
            g = np.where(m, guidance, 0.0).astype(np.float32)
            guided = self.context is not None and bool(g.any())
            m_d = torch.from_numpy(m).to(dev)
            self.x, self.x0, d = self._step(
                self._policy_for(pname), guided, t_d, tp_d, m_d,
                torch.from_numpy(g).to(dev))
            self.delta = torch.where(m_d, d, self.delta)
        if self.metrics.first_tick_s is None:
            if dev.type == 'cuda':
                torch.cuda.synchronize(dev)
            self.metrics.record_first_tick(time.perf_counter() - self._created)
        done: List[GenerationResult] = []
        for idx, a in enumerate(self._slot):
            if a is None:
                continue
            a.i += 1
            if a.i >= len(a.ts):
                done.append(self._drain(idx, now, wall_clock))
        return done

    def run_until_idle(self, now: Optional[float] = None,
                       max_ticks: int = 100_000,
                       tick_dt: float = 0.0) -> List[GenerationResult]:
        """Drive ticks until queue and slots are empty.  With a logical
        clock (``now`` given), each tick advances it by ``tick_dt``."""
        results: List[GenerationResult] = []
        for _ in range(max_ticks):
            if not self.busy:
                return results
            results.extend(self.tick(now))
            if now is not None:
                now += tick_dt
        raise RuntimeError(f'engine still busy after {max_ticks} ticks')

    def warmup(self, precisions=('fp32',)) -> float:
        """Run one throwaway one-step request per precision (and a guided
        one when the engine holds a context), so the kernels are built
        and loaded and every step variant has run before serving.
        Returns wall seconds, also recorded in the metrics."""
        t0 = time.perf_counter()
        saved = self.queue, self.metrics, self.quality_probe
        self.queue, self.metrics = AdmissionQueue(), ServingMetrics()
        self.quality_probe = 0          # no fp32 references for throwaways
        try:
            for i, pname in enumerate(precisions):
                for j, g in enumerate((0.0, 7.5) if self.context is not None
                                      else (0.0,)):
                    self.submit(GenerationRequest(
                        request_id=-(2 * i + j + 1), seed=0, steps=1,
                        guidance=g, precision=pname), now=0.0)
                    self.run_until_idle(now=0.0)
        finally:
            self.queue, self.metrics, self.quality_probe = saved
        dt = time.perf_counter() - t0
        self.metrics.record_warmup(dt)
        return dt
