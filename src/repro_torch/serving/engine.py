"""Continuous-batching diffusion engine on one device or slot-sharded
over a device mesh, port of ``repro/serving/engine.py``.

The engine owns a fixed ``(slots, H, W, C)`` latent buffer.  Each slot
carries one in-flight request at its own DDIM step index: every denoise
step is one UNet call with a per-sample timestep vector, so requests at
different depths share it.  Each request also carries its own precision
(``fp32``, ``w8a8`` or ``w8a8+noise``).  Per tick:

  1. free slots are refilled from the admission queue (a request's
     initial noise is the reference's for its seed, exactly as
     ``DiffusionPipeline.generate`` draws it);
  2. occupied slots are grouped by precision (``batcher.plan_tick``) and
     ONE masked mixed-timestep step per group advances that group's
     slots; the other slots pass through unchanged.  A group with a
     guided slot evaluates the UNet twice (conditional and
     unconditional) and blends per slot.  A ``w8a8+noise`` group draws
     its analog noise from the tick's key, ``fold_in(PRNGKey(seed),
     tick)`` (``core/prng``), its unconditional pass from
     ``fold_in(key, 1)``, so a serving run is deterministic under
     (noise seed, request sequence) and draws the reference's noise;
  3. slots at the end of their trajectory drain through the VAE decode
     and are immediately refillable, with policy-aware photonic energy
     (``PhotonicAccountant.energy_evals``).  Sampled quantized, cached
     or early-exited requests also run an fp32 full-step reference
     generation for the same seed and report PSNR/MSE against it.

Two schedulers make the per-tick cost dynamic:

  * **DeepCache-phased slots** (``cache_interval > 1``): slot-axis
    feature-cache buffers (a shard's ``cache_c``, and ``cache_u`` for the
    unconditional branch under guidance) hold the activation entering
    the last up level.  A refresh entry of the plan runs the full UNet
    and rewrites the cache rows of the slots it ran; a skip entry runs
    the shallow pass and splices them in.  All cache-enabled slots share
    one refresh cadence: admission holds queued requests until the next
    refresh tick, and the cadence re-anchors when no cached slot is
    active.  Skip ticks are billed at the shallow fraction of a full
    UNet tick.
  * **Speculative early exit** (``exit_tol``): every step also yields
    the x0 prediction; a slot whose relative x0 movement stays under
    ``exit_tol`` for ``exit_patience`` consecutive ticks (after
    ``EXIT_MIN_STEPS`` executed steps) drains early and commits its x0.

With eta = 0 DDIM is deterministic given the initial noise, and the UNet
and the per-row w8a8 activation scales treat batch rows independently,
so an uncached request served here matches ``DiffusionPipeline.generate
(seed, batch=1, ...)`` on its own.

Serving a trace: ``replay`` submits each request once the serving clock
(wall seconds since the replay began) passes its arrival time and ticks
until every request completed or was shed; every time it records,
trace events included, is on that clock.  ``measure_tick_s`` measures
the steady tick time at full occupancy, which sizes overload traffic
(``batcher.overload_factor``) and becomes ``tick_s_estimate``: admission
then also sheds a queued request whose deadline falls inside its own
estimated service time.

Decode overlap (``overlap_decode``, by default on exactly when sharded,
as in the reference): a drained slot's VAE decode is dispatched and the
slot refilled at once; its image materializes only after the NEXT
tick's steps are enqueued, so results surface one tick later and an
idle tick flushes the rest.  On CUDA the decode and its copy to pinned
host memory run on a second stream of the slot's device that first
waits for the main one, so they run behind the next UNet step; on the
CPU the same split runs in order.

Tracing (``tracer=``, a ``repro_torch.obs.Tracer``; default the no-op
``NULL_TRACER``): the reference's event stream, every hook guarded on
``tracer.enabled``: submit, shed (the victim, through the queue's
``on_shed`` hook), slot assignment, one span per step call with its
photonic energy, early exit, decode dispatch and completion, a request
span stamped from the result's own timing fields, tick and warmup spans
and an occupancy counter.  ``reporter`` (a ``SnapshotReporter``) is
polled once per tick.  Step and tick spans time the host's enqueue: the
device runs behind it.

Sharded serving (``mesh=``, a ``launch.mesh.serving_mesh``): the slot
axis splits over the mesh's devices, shard i owning slot rows ``i*spd
... (i+1)*spd - 1`` (``spd`` = slots per device) of x, x0, the DeepCache
buffers and the context, on its device, with one parameter replica per
distinct device (two logical shards on one card share one).  Each plan
entry's step runs once per shard on that shard's rows, every shard's work
issued before any sync, so shards on several cards run at once.  A noisy
step draws what the unsharded step draws: the tick's key folds in global
slot 0's timestep, and each shard's noisy matmuls take their rows of the
draws over the whole slot buffer (``core/photonic/noise``).  Decode
overlap (default on exactly when sharded) uses a side stream per device.
``elastic_resize`` rebuilds the shards on a new mesh after devices drop
or rejoin at the same slots per device: in-flight rows gather to the
host, the overflow parks and re-enters freed slots ahead of the queue
(with a forced DeepCache refresh), and the context is re-tiled when all
its rows are equal.  A ``StepMonitor`` (``engine.monitor``) gets each
tick's wall time for every device, and ``on_straggler`` fires when its
flagged set changes.

The engine runs eagerly (no graph capture).  Its cold start is the
kernels' builds: ``warmup`` and ``aot_warmup`` build (into the
persistent cache, ``serving/compile_cache.py``, when one is enabled) and
load the kernels the served precisions reach, ``aot_warmup`` without a
tick, and ``compile_stats`` counts the argument signatures each step
variant and helper has run with, the port's counterpart of the
reference's jit cache sizes.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.diffusion import samplers
from repro_torch.diffusion.deepcache import unet_apply_cached
from repro_torch.diffusion.pipeline import DiffusionPipeline, initial_noise
from repro_torch.distributed.fault_tolerance import (StepMonitor,
                                                     elastic_serving_plan)
from repro_torch.kernels import ops
from repro_torch.launch.mesh import ServingMesh, serving_mesh
from repro_torch.models.unet import AttnBlock
from repro_torch.obs.tracer import NULL_TRACER, Tracer
from repro_torch.serving.api import GenerationRequest, GenerationResult
from repro_torch.serving.batcher import align_slots, plan_tick
from repro_torch.serving.compile_cache import (enable_persistent_cache,
                                               trim_cache)
from repro_torch.serving.metrics import PhotonicAccountant, ServingMetrics
from repro_torch.serving.queue import AdmissionQueue

#: no early exit before this many executed steps: the x0-convergence
#: signal needs two x0 predictions
EXIT_MIN_STEPS = 2


@dataclasses.dataclass
class _Active:
    """One occupied slot: the request, its trajectory cursor and the
    scheduler state (resolved cache/early-exit knobs, eval counters)."""
    request: GenerationRequest
    ts: np.ndarray               # this request's DDIM timestep trajectory
    i: int                       # next step index into `ts`
    submit_time: float
    start_time: float
    cache_on: bool = False       # rides the shared refresh cadence
    exit_tol: float = 0.0        # <= 0: early exit disabled
    exit_patience: int = 2
    full_evals: int = 0          # full-UNet ticks consumed so far
    cached_evals: int = 0        # shallow (skip) ticks consumed so far
    exit_streak: int = 0         # consecutive ticks under exit_tol
    force_refresh: bool = False  # next tick is a full pass: a parked
    #                              request's DeepCache rows did not survive


@dataclasses.dataclass
class _Shard:
    """Slot rows ``lo ... hi - 1`` on one device: the pipeline replica
    there and those rows of every slot buffer."""
    lo: int
    hi: int
    pipe: DiffusionPipeline
    x: torch.Tensor
    x0: torch.Tensor
    delta: torch.Tensor
    context: Optional[torch.Tensor]
    cache_c: Optional[torch.Tensor]
    cache_u: Optional[torch.Tensor]

    @property
    def device(self) -> torch.device:
        return self.pipe.device


@dataclasses.dataclass
class _Pending:
    """A drained slot whose decode was dispatched: ``host`` is the image
    on the host, complete once ``done`` (a CUDA event on the decode
    stream, None where the decode ran in order) has fired."""
    active: _Active
    host: torch.Tensor
    done: Optional[torch.cuda.Event]
    now: float
    wall_clock: bool
    early: bool
    slot: int


class ContinuousBatchingEngine:
    #: queue shed causes -> the metrics ledger's reason names
    _SHED_REASONS = {'rejected': 'queue_full', 'evicted': 'deadline_evict',
                     'expired': 'expired'}

    def __init__(self, pipe: DiffusionPipeline, slots: int = 4,
                 context: Optional[torch.Tensor] = None,
                 queue: Optional[AdmissionQueue] = None,
                 metrics: Optional[ServingMetrics] = None,
                 noise_seed: int = 0,
                 quality_probe: int = 1,
                 cache_interval: int = 1,
                 exit_tol: Optional[float] = None,
                 exit_patience: int = 2,
                 mesh: Optional[ServingMesh] = None,
                 slots_per_device: Optional[int] = None,
                 overlap_decode: Optional[bool] = None,
                 tracer: Optional[Tracer] = None,
                 on_straggler=None,
                 reporter=None):
        """``context``: the ``(slots, T, context_dim)`` conditioning the
        conditional branch attends to (None: unconditional model); rows
        that are all equal are re-tiled to the slot count.
        ``noise_seed``: the ``w8a8+noise`` policy's seed (its noise model
        is the paper's).  Every result is priced by a
        ``PhotonicAccountant`` for the pipeline's UNet.
        ``quality_probe``: run the fp32 reference + PSNR/MSE probe for
        every k-th completed quantized, cached or early-exited request (0
        disables it).  ``cache_interval``: the shared DeepCache refresh
        cadence, a full pass every ``cache_interval`` ticks (1: caching
        off).  ``exit_tol`` / ``exit_patience``: engine-wide early-exit
        defaults, which requests override per field (``exit_tol=None``
        leaves early exit off).

        ``mesh``: a 1-D ``('data',)`` mesh (``launch.mesh.serving_mesh``)
        over which the slot axis shards.  ``slots_per_device`` then
        overrides ``slots`` with a per-device budget (the invariant
        ``elastic_resize`` keeps); otherwise ``slots`` rounds up to a
        multiple of the mesh size.  ``overlap_decode`` (default: on
        exactly when sharded): run each drained slot's decode behind the
        next tick (on CUDA, on a side stream of its device).
        ``tracer``: a ``repro_torch.obs.Tracer`` recording the request and
        engine event stream (default: the no-op ``NULL_TRACER``).
        ``on_straggler``: called with the ``StragglerReport`` whenever the
        ``StepMonitor``'s flagged-device set changes.
        ``reporter``: a ``repro_torch.obs.SnapshotReporter`` polled once a
        tick."""
        if slots < 1:
            raise ValueError('need at least one slot')
        if cache_interval < 1:
            raise ValueError('cache_interval must be >= 1')
        self._created = time.perf_counter()   # time-to-first-tick origin
        self.pipe = pipe
        self.device = pipe.device
        self.mesh = mesh
        if mesh is not None:
            ndev = mesh.size
            if slots_per_device is not None:
                if slots_per_device < 1:
                    raise ValueError('slots_per_device must be >= 1')
                slots = slots_per_device * ndev
            else:
                slots = align_slots(slots, ndev)
            self._slots_per_device = slots // ndev
            self.monitor = StepMonitor(n_hosts=ndev)
        else:
            self._slots_per_device = slots
            self.monitor = None
        self.slots = slots
        self.overlap_decode = (mesh is not None) if overlap_decode is None \
            else bool(overlap_decode)
        if context is not None:
            context = context.to(self.device)
            if context.shape[0] != slots:
                context = self._retile_context(context, slots)
        self.context = context
        # `is not None`: an empty AdmissionQueue is falsy
        self.queue = queue if queue is not None else AdmissionQueue()
        self.metrics = metrics if metrics is not None else ServingMetrics()
        if mesh is not None:
            self.metrics.devices = mesh.size
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.on_straggler = on_straggler
        self.reporter = reporter
        self._straggler_flagged: Tuple[int, ...] = ()
        self._pending: List[_Pending] = []
        # requests displaced by an elastic shrink: (active, x row, x0 row)
        # on the host, re-admitted ahead of the queue as slots free
        self._parked: List[Tuple[_Active, torch.Tensor, torch.Tensor]] = []
        self._tick_s: Optional[float] = None   # measured seconds per tick
        self._wall_t0 = 0.0          # serving-clock origin (set by replay)
        self._user_on_shed = self.queue.on_shed
        self.queue.on_shed = self._queue_shed
        self.photonic = PhotonicAccountant(pipe.unet_cfg)
        self.noise_seed = noise_seed
        self.quality_probe = quality_probe
        self.cache_interval = cache_interval
        self.exit_tol = exit_tol
        self.exit_patience = exit_patience
        cfg = pipe.unet_cfg
        self._sample_shape = (cfg.img_size, cfg.img_size, cfg.in_ch)
        # the DeepCache row: the activation entering the last up level
        # (full resolution, the second level's channels)
        ch = cfg.base_ch * cfg.ch_mults[min(1, len(cfg.ch_mults) - 1)]
        self._cache_row = (cfg.img_size, cfg.img_size, ch)
        self._slot: List[Optional[_Active]] = [None] * slots
        self._traj: Dict[int, np.ndarray] = {}
        self._policies: Dict[str, PrecisionPolicy] = {}
        self._probe_done = 0
        self._phase = 0              # shared refresh cadence position
        # one parameter replica per distinct device, and per CUDA device
        # a decode stream (the CPU runs the overlapped decode in order)
        self._replicas: Dict[torch.device, DiffusionPipeline] = {
            self.device: pipe}
        self._sides: Dict[torch.device, torch.cuda.Stream] = {}
        self._reset_signatures()
        self._build_shards()

    @staticmethod
    def _retile_context(context: torch.Tensor, slots: int) -> torch.Tensor:
        """``context``'s shared row tiled to ``slots`` rows.  Rows that
        differ cannot follow their requests to other slots (the engine
        keeps no per-request context), so they raise."""
        if not bool((context == context[:1]).all()):
            raise ValueError(
                f'context has {context.shape[0]} distinct rows: the engine '
                'keeps no per-request context, so only a context whose rows '
                'are all equal can be re-tiled to a new slot count or follow '
                'requests that a resize moves to other slots')
        return context[:1].repeat((slots,) + (1,) * (context.ndim - 1))

    def _build_shards(self) -> None:
        """(Re)build one shard per mesh device (one over every slot when
        unsharded) with zeroed buffers, on a replica of the pipeline."""
        devices = self.mesh.devices if self.mesh is not None \
            else (self.device,)
        spd = self._slots_per_device
        self._shards: List[_Shard] = []
        for i, dev in enumerate(devices):
            if dev not in self._replicas:
                self._replicas[dev] = self.pipe.to(dev)
            if self.overlap_decode and dev.type == 'cuda' \
                    and dev not in self._sides:
                self._sides[dev] = torch.cuda.Stream(dev)
            lo, hi = i * spd, (i + 1) * spd
            x = torch.zeros((spd,) + self._sample_shape, device=dev)
            cache_c = cache_u = None
            if self.cache_interval > 1:
                cache_c = torch.zeros((spd,) + self._cache_row, device=dev)
                if self.context is not None:
                    # the unconditional branch's rows, apart under guidance
                    cache_u = torch.zeros_like(cache_c)
            self._shards.append(_Shard(
                lo=lo, hi=hi, pipe=self._replicas[dev], x=x,
                x0=torch.zeros_like(x),
                delta=torch.zeros(spd, device=dev),
                context=None if self.context is None
                else self.context[lo:hi].to(dev),
                cache_c=cache_c, cache_u=cache_u))
        # replicas of devices the mesh no longer holds are freed
        keep = {self.device} | {sh.device for sh in self._shards}
        for dev in [d for d in self._replicas if d not in keep]:
            del self._replicas[dev]

    def _shard_of(self, idx: int) -> Tuple[_Shard, int]:
        """The shard holding slot ``idx`` and the slot's row in it."""
        sh = self._shards[idx // self._slots_per_device]
        return sh, idx - sh.lo

    @property
    def delta(self) -> torch.Tensor:
        """Per-slot relative x0 movement of the last step, (slots,), on
        the first shard's device."""
        parts = [sh.delta for sh in self._shards]
        if len(parts) == 1:
            return parts[0]
        return torch.cat([p.to(parts[0].device) for p in parts])

    # -- precision machinery ------------------------------------------------
    def _policy_for(self, name: str) -> PrecisionPolicy:
        if name not in self._policies:
            if name == 'fp32':
                pol = PrecisionPolicy.fp32()
            elif name == 'w8a8':
                cal = self.pipe.policy.calibration \
                    if self.pipe.policy.quantized else 'dynamic'
                pol = PrecisionPolicy.w8a8(calibration=cal)
            else:  # 'w8a8+noise' (the request validated the name)
                pol = PrecisionPolicy.w8a8_noise(noise_seed=self.noise_seed)
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

    @staticmethod
    def _guide(eps_c, eps_u, guidance):
        """Per-slot classifier-free guidance, only where guidance > 0."""
        g = guidance.reshape((-1,) + (1,) * (eps_c.ndim - 1))
        return torch.where(g > 0, eps_u + g * (eps_c - eps_u), eps_c)

    def _step(self, sh: _Shard, pol: PrecisionPolicy, guided: bool, t,
              t_prev, active, guidance, key, t_first: int):
        """One masked mixed-timestep step of the shard's slots in
        ``active`` (t, t_prev, active and guidance: the shard's rows).
        Guided: per-slot classifier-free guidance against the
        unconditional eps, only for slots with guidance > 0.  ``key``:
        the tick's noise key (None unless the policy is noisy);
        ``t_first``: global slot 0's timestep, which a noisy evaluation's
        key folds in."""
        pipe, x = sh.pipe, sh.x
        # sh.lo: where the shard's rows sit in the draws over every slot
        eps = pipe._eps_fn(sh.context, 0.0, pol, key, sh.lo)(x, t, t_first)
        if guided:
            ukey = None if key is None else prng.fold_in(key, 1)
            eps_u = pipe._eps_fn(None, 0.0, pol, ukey, sh.lo)(x, t, t_first)
            eps = self._guide(eps, eps_u, guidance)
        return self._finish_step(pipe.sched, eps, x, sh.x0, t, t_prev,
                                 active)

    def _cached_step(self, sh: _Shard, pol: PrecisionPolicy, guided: bool,
                     refresh: bool, t, t_prev, active, guidance, key):
        """DeepCache-phased step of the shard: ``refresh`` runs the full
        pass and rewrites the cache rows of the slots in ``active``; a
        skip step runs the shallow pass on the cached rows and leaves the
        buffers as they are.  The noisy key goes to the UNet as it is."""
        pipe, x = sh.pipe, sh.x
        cfg = pipe.unet_cfg
        eps, new_c = unet_apply_cached(pipe.unet, cfg, x, t, sh.cache_c,
                                       refresh, sh.context, pol,
                                       noise_key=key, first_sample=sh.lo)
        if guided:
            ukey = None if key is None else prng.fold_in(key, 1)
            eps_u, new_u = unet_apply_cached(pipe.unet, cfg, x, t,
                                             sh.cache_u, refresh, None,
                                             pol, noise_key=ukey,
                                             first_sample=sh.lo)
            eps = self._guide(eps, eps_u, guidance)
        out = self._finish_step(pipe.sched, eps, x, sh.x0, t, t_prev,
                                active)
        if refresh:
            cm = active.reshape((-1,) + (1,) * (new_c.ndim - 1))
            sh.cache_c = torch.where(cm, new_c, sh.cache_c)
            if guided:
                sh.cache_u = torch.where(cm, new_u, sh.cache_u)
        return out

    def _tick_key(self, pol: PrecisionPolicy,
                  tick_idx: int) -> Optional[prng.Key]:
        """Per-tick analog-noise key: the policy's seed anchor folded with
        the tick index (None for a noise-free policy)."""
        if not pol.noisy:
            return None
        return prng.fold_in(prng.PRNGKey(pol.noise_seed), tick_idx)

    # -- introspection -----------------------------------------------------
    @property
    def active_count(self) -> int:
        return sum(a is not None for a in self._slot)

    @property
    def busy(self) -> bool:
        return (self.active_count > 0 or len(self.queue) > 0
                or bool(self._pending) or bool(self._parked))

    @property
    def tick_s_estimate(self) -> Optional[float]:
        """Measured steady-state seconds per tick (None until
        ``measure_tick_s`` runs; settable, so a deployment can pin it).
        It sets the admission-time SLO margin."""
        return self._tick_s

    @tick_s_estimate.setter
    def tick_s_estimate(self, value: Optional[float]) -> None:
        self._tick_s = None if value is None else float(value)

    def _service_margin_s(self, req: GenerationRequest) -> float:
        """Estimated service time were ``req`` admitted now, the expiry
        margin: one tick advances every slot one step, so ``steps``
        ticks.  0 (expire only dead entries) until an estimate exists."""
        if self._tick_s is None:
            return 0.0
        return req.steps * self._tick_s

    # -- signatures: the port's counterpart of the jit caches -------------
    _HELPERS = ('_init_noise', '_place', '_take', '_decode')

    def _reset_signatures(self) -> None:
        """Forget every signature seen (construction, a resize: the
        reference builds its jitted functions anew then)."""
        self._sigs: Dict[str, set] = {}      # label -> signatures, in order

    @staticmethod
    def _sig(*tensors: torch.Tensor) -> tuple:
        """The argument signature of a call: shapes, dtypes, devices."""
        return tuple((tuple(t.shape), str(t.dtype), str(t.device))
                     for t in tensors)

    def _note(self, label: str, sig: tuple) -> None:
        self._sigs.setdefault(label, set()).add(sig)

    @staticmethod
    def _step_label(pname: str, guided: bool,
                    refresh: Optional[bool]) -> str:
        """The reference's ``compile_stats`` label of a step variant
        (``refresh`` None: the plain, uncached step)."""
        suffix = '' if pname == 'fp32' else f'[{pname}]'
        if refresh is None:
            return ('_step_guided' if guided else '_step') + suffix
        return (('_step_refresh' if refresh else '_step_skip')
                + ('_guided' if guided else '') + suffix)

    def _step_sig(self, sh: _Shard, caching: bool) -> tuple:
        """A shard's step signature: its slot rows (and DeepCache rows)."""
        return self._sig(sh.x, sh.cache_c) if caching else self._sig(sh.x)

    def compile_stats(self) -> Dict[str, int]:
        """The reference's labels (``_step`` / ``_step_guided`` for fp32,
        ``_step[w8a8]``-style for a quantized policy, the DeepCache pair
        as ``_step_refresh`` / ``_step_skip`` variants, then
        ``_init_noise``, ``_place``, ``_take`` and, with a VAE,
        ``_decode``), each with the number of distinct argument
        signatures (shapes, dtypes, device) its counterpart here has run
        with or ``aot_warmup`` prepared.  A new signature means new cuDNN
        plans and kernel configurations, the port's recompilation: after
        one warmup per served policy it is 1 per variant and stays so."""
        out = {label: len(sigs) for label, sigs in self._sigs.items()
               if label not in self._HELPERS}
        for name in self._HELPERS:
            if name != '_decode' or self.pipe.vae is not None:
                out[name] = len(self._sigs.get(name, ()))
        return out

    def step_variants(self, precisions=('fp32',)):
        """Every ``(precision, guided, refresh)`` step variant the given
        request mix can reach on this engine: guided variants exist only
        when the engine holds a ``context``; refresh/skip variants only
        when DeepCache phasing is on (``refresh`` is None for the plain
        uncached step)."""
        guided_opts = (False, True) if self.context is not None else (False,)
        out = []
        for pname in precisions:
            for guided in guided_opts:
                if self.cache_interval > 1:
                    out.append((pname, guided, True))
                    out.append((pname, guided, False))
                else:
                    out.append((pname, guided, None))
        return out

    def _kernels_for(self, precisions) -> List[str]:
        """The kernels the precisions reach: GroupNorm+swish and the
        convolution in every evaluation; W8A8 in a ``w8a8`` evaluation of
        a UNet with attention (a ``w8a8+noise`` product is a float one)."""
        names = ['fused_gn_swish', 'conv2d_nhwc']
        if 'w8a8' in precisions and any(
                isinstance(m, AttnBlock) for m in self.pipe.unet.modules()):
            names.append('w8a8_matmul')
        return names

    def aot_warmup(self, precisions=('fp32',),
                   cache_dir: Optional[str] = None) -> Dict[str, float]:
        """Ahead-of-time warmup without a tick: build (where the cache
        lacks them) and load the kernel libraries every variant of
        ``step_variants(precisions)`` reaches, set each kernel's
        shared-memory attribute on every device the shards use, and
        prepare each variant's and helper's signature on every shard.
        ``cache_dir`` enables the persistent cache first.  Returns
        ``{'variants': n, 'seconds': wall}``, n the reference's count:
        the variants, the three helpers and, with a VAE, the decode."""
        if cache_dir is not None:
            enable_persistent_cache(cache_dir)
        t0 = time.perf_counter()
        variants = self.step_variants(precisions)
        ops.prepare(self._kernels_for(precisions),
                    [sh.device for sh in self._shards])
        for pname, guided, refresh in variants:
            label = self._step_label(pname, guided, refresh)
            for sh in self._shards:
                self._note(label, self._step_sig(sh, refresh is not None))
        for sh in self._shards:
            one = sh.x[:1]
            self._note('_init_noise', self._sig(one))
            self._note('_place', self._sig(sh.x))
            self._note('_take', self._sig(sh.x))
            if sh.pipe.vae is not None:
                self._note('_decode', self._sig(one))
        n = len(variants) + 3 + (self.pipe.vae is not None)
        trim_cache()    # the persistent cache's size bound, if any
        dt = time.perf_counter() - t0
        if self.tracer.enabled:
            t1 = self.tracer.now()
            self.tracer.complete('aot_warmup', t1 - dt, t1, cat='engine',
                                 variants=n, seconds=dt)
        return {'variants': n, 'seconds': dt}

    def _step_energy_j(self, precision: str, refresh: bool,
                       guided: bool) -> float:
        """Energy one slot consumes in one tick of this kind: the delta a
        ``step`` span carries per slot."""
        full, cached = (1, 0) if refresh else (0, 1)
        energy_j, _ = self.photonic.energy_evals(full, cached, guided,
                                                 precision=precision)
        return energy_j

    def _slot_device(self, idx: int) -> Optional[int]:
        """Mesh position of the device carrying slot ``idx`` (None
        unsharded)."""
        if self.mesh is None:
            return None
        return idx // self._slots_per_device

    def _poll_straggler(self):
        """Check the ``StepMonitor`` and, when its flagged-device set
        changes, emit a ``straggler`` trace event and call
        ``on_straggler`` (edge-triggered: a persistent straggler does not
        fire every tick).  Returns the current report (None when
        clean)."""
        if self.monitor is None:
            return None
        report = self.monitor.check()
        flagged = tuple(report.slow_hosts) if report is not None else ()
        if flagged and flagged != self._straggler_flagged:
            self.tracer.instant('straggler', cat='engine',
                                slow_devices=list(flagged),
                                median_s=report.median_s,
                                threshold_s=report.threshold_s,
                                recommendation=report.recommendation)
            if self.on_straggler is not None:
                self.on_straggler(report)
        self._straggler_flagged = flagged
        return report

    def _queue_shed(self, reason: str, req: GenerationRequest,
                    now: float) -> None:
        """The queue's per-request shed hook: tally the cause and name
        the victim in the trace."""
        self.metrics.record_shed(self._SHED_REASONS.get(reason, reason))
        if self.tracer.enabled:
            self.tracer.instant('shed', cat='queue', ts=now,
                                rid=req.request_id,
                                reason=self._SHED_REASONS.get(reason, reason),
                                trace_id=req.effective_trace_id)
        if self._user_on_shed is not None:
            self._user_on_shed(reason, req, now)

    # -- request flow ------------------------------------------------------
    def submit(self, req: GenerationRequest,
               now: Optional[float] = None) -> bool:
        now = time.perf_counter() - self._wall_t0 if now is None else now
        ok = self.queue.submit(req, now)
        if ok:
            self.metrics.record_submit(now)
            if self.tracer.enabled:
                self.tracer.instant('submit', cat='queue', ts=now,
                                    rid=req.request_id, steps=req.steps,
                                    precision=req.precision,
                                    trace_id=req.effective_trace_id)
        self.metrics.observe_queue_depth(len(self.queue))
        return ok

    def _trajectory(self, steps: int) -> np.ndarray:
        if steps not in self._traj:
            self._traj[steps] = samplers.ddim_timesteps(self.pipe.sched, steps)
        return self._traj[steps]

    def _cached_active(self) -> int:
        return sum(a is not None and a.cache_on for a in self._slot)

    def _unpark(self, idx: int) -> None:
        """Re-admit the oldest parked request into free slot ``idx``: its
        latent and x0 rows come back from the host.  Its DeepCache rows
        were not parked (a resize rebuilds those buffers), so a cached
        request re-enters with ``force_refresh``: its first tick back is
        a full pass that rewrites them."""
        a, hx, hx0 = self._parked.pop(0)
        sh, row = self._shard_of(idx)
        self._note('_place', self._sig(sh.x))
        sh.x[row] = hx.to(sh.device)
        sh.x0[row] = hx0.to(sh.device)
        if a.cache_on:
            a.force_refresh = True
        self._slot[idx] = a
        if self.tracer.enabled:
            self.tracer.instant('unpark', cat='queue',
                                rid=a.request.request_id, slot=idx,
                                device=self._slot_device(idx),
                                step_index=a.i)

    def _admit(self, now: float) -> None:
        if self.queue.has_deadlines:
            # a request dead now, or dead before it could finish, never
            # takes a slot
            self.queue.expire(now, margin_s=self._service_margin_s)
        # parked (resize-displaced) requests re-enter ahead of the queue;
        # force_refresh lets them rejoin mid-cadence (a mixed tick)
        for idx in range(self.slots):
            if not self._parked:
                break
            if self._slot[idx] is None:
                self._unpark(idx)
        if self.cache_interval > 1:
            if self._cached_active() == 0:
                # nothing rides the cadence: re-anchor it, so an idle
                # engine never delays admission
                self._phase = 0
            if self._phase != 0 and self.queue.peek() is not None:
                # phase-aligned admission: hold queued requests until the
                # next refresh tick, so every skip tick stays a whole-batch
                # shallow pass
                return
        for idx in range(self.slots):
            if self._slot[idx] is not None:
                continue
            q = self.queue.pop()
            if q is None:
                return
            req = q.request
            interval = self.cache_interval if req.cache_interval is None \
                else req.cache_interval
            tol = self.exit_tol if req.exit_tol is None else req.exit_tol
            patience = self.exit_patience if req.exit_patience is None \
                else req.exit_patience
            self._slot[idx] = _Active(
                request=req, ts=self._trajectory(req.steps), i=0,
                submit_time=q.enqueue_time, start_time=now,
                cache_on=self.cache_interval > 1 and interval > 1,
                exit_tol=0.0 if tol is None else float(tol),
                exit_patience=patience)
            if self.tracer.enabled:
                self.tracer.instant('slot_assign', cat='queue', ts=now,
                                    rid=req.request_id, slot=idx,
                                    device=self._slot_device(idx),
                                    queue_wait_s=now - q.enqueue_time)
            sh, row = self._shard_of(idx)
            noise = initial_noise(req.seed, (1,) + self._sample_shape,
                                  sh.device)
            self._note('_init_noise', self._sig(noise))
            self._note('_place', self._sig(sh.x))
            noise = noise[0]
            sh.x[row] = noise
            # the x0 tracker starts at the noise: the first delta is
            # meaningless
            sh.x0[row] = noise

    def _fp32_reference(self, req: GenerationRequest,
                        guided: bool) -> np.ndarray:
        """fp32 full-step generation for the same seed/steps/guidance: the
        quality probe's reference image (context row 0 stands in for the
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

    def _begin_drain(self, idx: int, now: float, wall_clock: bool,
                     early: bool = False) -> _Pending:
        """Dispatch a finished slot's decode and free the slot.  An
        early-exit drain decodes the converged x0 prediction instead of
        the partly denoised latent.  With a decode stream nothing here
        waits for the device."""
        a = self._slot[idx]
        self._slot[idx] = None
        sh, row = self._shard_of(idx)
        # the copy, on the main stream before the slot is refilled:
        # admission overwrites the slot row in place, and without a VAE
        # the decode is that row itself
        self._note('_take', self._sig(sh.x))
        z = (sh.x0 if early else sh.x)[row:row + 1].clone()
        if sh.pipe.vae is not None:
            self._note('_decode', self._sig(z))
        done = None
        side = self._sides.get(sh.device)
        if side is None:
            host = sh.pipe.decode(z)[0].cpu()
        else:
            side.wait_stream(torch.cuda.current_stream(sh.device))
            z.record_stream(side)    # made on the main stream, used here
            with torch.cuda.stream(side):
                image = sh.pipe.decode(z)[0]
                host = torch.empty(image.shape, dtype=image.dtype,
                                   pin_memory=True)
                host.copy_(image, non_blocking=True)
                done = torch.cuda.Event()
                done.record(side)
        if self.tracer.enabled:
            if early:
                self.tracer.instant('early_exit', cat='request', ts=now,
                                    rid=a.request.request_id, slot=idx,
                                    device=self._slot_device(idx),
                                    steps_executed=a.i,
                                    steps_requested=a.request.steps)
            self.tracer.instant('decode_dispatch', cat='decode', ts=now,
                                rid=a.request.request_id, slot=idx,
                                device=self._slot_device(idx))
        return _Pending(active=a, host=host, done=done, now=now,
                        wall_clock=wall_clock, early=early, slot=idx)

    def _finish_drain(self, p: _Pending,
                      overlapped: bool = False) -> GenerationResult:
        """Wait for a dispatched decode, stamp the latency, and account
        the result.  ``overlapped`` marks a decode that ran behind the
        following tick's steps."""
        a, now, early = p.active, p.now, p.early
        req = a.request
        if p.done is not None:
            p.done.synchronize()
        image = p.host.numpy()
        if p.wall_clock:
            # only now has the last step and the decode run
            now = time.perf_counter() - self._wall_t0
        pol = self._policy_for(req.precision)
        guided = req.guidance > 0.0 and self.context is not None
        # skip ticks are billed at the shallow fraction of a full tick; an
        # early exit pays only for the ticks that ran
        energy_j, epb = self.photonic.energy_evals(
            a.full_evals, a.cached_evals, guided, precision=req.precision)
        mse = psnr = None
        # the probe runs after the latency stamp: it is measurement
        # apparatus, not served work.  Cached or early-exited requests are
        # probed at any precision: their distance from the full-step fp32
        # image is what the saved work cost
        reduced = early or a.cached_evals > 0
        if (pol.quantized or reduced) and self.quality_probe > 0:
            if self._probe_done % self.quality_probe == 0:
                mse, psnr = self._quality(
                    image, self._fp32_reference(req, guided))
            self._probe_done += 1
        res = GenerationResult(
            request_id=req.request_id, image=image, steps=req.steps,
            submit_time=a.submit_time, start_time=a.start_time,
            finish_time=now, energy_j=energy_j, epb_pj=epb,
            precision=req.precision, policy=pol,
            quality_psnr_db=psnr, quality_mse=mse, steps_executed=a.i,
            full_evals=a.full_evals, cached_evals=a.cached_evals,
            early_exit=early, trace_id=req.effective_trace_id)
        self.metrics.record_complete(res, slo_ms=req.slo_ms)
        if self.tracer.enabled:
            self.tracer.instant('decode_done', cat='decode', ts=now,
                                rid=req.request_id, slot=p.slot,
                                device=self._slot_device(p.slot),
                                overlapped=overlapped)
            # stamped from the result's own timing fields, so the trace's
            # latency is the metrics' latency
            self.tracer.complete(
                'request', a.submit_time, now, cat='request',
                rid=req.request_id, slot=p.slot,
                device=self._slot_device(p.slot), trace_id=res.trace_id,
                precision=req.precision, steps_executed=a.i,
                full_evals=a.full_evals, cached_evals=a.cached_evals,
                early_exit=early, queue_wait_s=res.queue_delay_s,
                energy_j=energy_j, slo_ms=req.slo_ms)
            self.tracer.instant('complete', cat='request', ts=now,
                                rid=req.request_id, slot=p.slot,
                                latency_s=res.latency_s)
        return res

    def _flush_pending(self, overlapped: bool) -> List[GenerationResult]:
        """Materialize every dispatched decode.  ``overlapped``: a tick's
        steps were enqueued between the dispatch and now."""
        if not self._pending:
            return []
        pending, self._pending = self._pending, []
        if overlapped:
            self.metrics.record_overlapped_decode(len(pending))
        return [self._finish_drain(p, overlapped=overlapped)
                for p in pending]

    @torch.no_grad()
    def tick(self, now: Optional[float] = None,
             wall_clock: Optional[bool] = None) -> List[GenerationResult]:
        """Admit (phase-aligned when caching) -> one masked mixed-timestep
        step per (precision group, refresh|skip) entry of the plan ->
        drain finished and converged slots.  ``wall_clock`` (default:
        ``now`` not given) re-stamps each drained result after its device
        sync, so latencies include the last step and the decode.  Under
        decode overlap a result surfaces on the following tick, after that
        tick's steps are enqueued; an idle tick flushes the rest."""
        wall_clock = (now is None) if wall_clock is None else wall_clock
        now = time.perf_counter() - self._wall_t0 if now is None else now
        t_tick0 = time.perf_counter()
        self._admit(now)
        if self.active_count == 0:
            # no step to hide behind: not counted as overlapped
            return self._flush_pending(overlapped=False)
        caching = self.cache_interval > 1
        refresh_tick = self._phase == 0
        t = np.zeros(self.slots, np.int64)
        t_prev = np.full(self.slots, -1, np.int64)
        guidance = np.zeros(self.slots, np.float32)
        needs_refresh = np.ones(self.slots, bool)
        track_exit = False
        for idx, a in enumerate(self._slot):
            if a is None:
                continue
            t[idx] = a.ts[a.i]
            t_prev[idx] = a.ts[a.i + 1] if a.i + 1 < len(a.ts) else -1
            guidance[idx] = a.request.guidance
            needs_refresh[idx] = ((not a.cache_on) or a.i == 0
                                  or refresh_tick or a.force_refresh)
            if a.exit_tol > 0.0 and a.i + 1 >= EXIT_MIN_STEPS:
                track_exit = True
        plan = plan_tick([a.request.precision if a is not None else None
                          for a in self._slot], needs_refresh, caching)
        tick_idx = self.metrics.ticks
        active = np.array([a is not None for a in self._slot])
        self.metrics.record_tick(
            int(active.sum()),
            full_slots=int((active & needs_refresh).sum()),
            cached_slots=int((active & ~needs_refresh).sum()))
        had_cached = self._cached_active() > 0

        def rows(sh, a):
            return torch.from_numpy(a[sh.lo:sh.hi]).to(sh.device)

        ts_d = [(rows(sh, t), rows(sh, t_prev)) for sh in self._shards]
        traced = self.tracer.enabled
        for pname, refresh, m in plan:
            pol = self._policy_for(pname)
            g = np.where(m, guidance, 0.0).astype(np.float32)
            guided = self.context is not None and bool(g.any())
            key = self._tick_key(pol, tick_idx)
            t_step0 = self.tracer.now() if traced else 0.0
            # every shard runs the entry on its rows; nothing here syncs,
            # so shards on different cards run at once
            label = self._step_label(pname, guided,
                                     refresh if caching else None)
            for sh, (t_d, tp_d) in zip(self._shards, ts_d):
                m_d, g_d = rows(sh, m), rows(sh, g)
                self._note(label, self._step_sig(sh, caching))
                if caching:
                    sh.x, sh.x0, d = self._cached_step(
                        sh, pol, guided, refresh, t_d, tp_d, m_d, g_d, key)
                else:
                    sh.x, sh.x0, d = self._step(
                        sh, pol, guided, t_d, tp_d, m_d, g_d, key,
                        int(t[0]))
                sh.delta = torch.where(m_d, d, sh.delta)
            if traced:
                n_m = int(m.sum())
                self.tracer.complete(
                    'step', t_step0, self.tracer.now(), cat='tick',
                    tick=tick_idx, precision=pname, refresh=refresh,
                    guided=guided, slots=n_m,
                    energy_j=self._step_energy_j(pname, refresh,
                                                 guided) * n_m)
        # decode overlap: the decodes dispatched last tick materialize
        # now, behind the steps just enqueued
        done = self._flush_pending(overlapped=True)
        if self.metrics.first_tick_s is None:
            for dev in {sh.device for sh in self._shards}:
                if dev.type == 'cuda':
                    torch.cuda.synchronize(dev)
            self.metrics.record_first_tick(time.perf_counter() - self._created)
        # the x0-convergence deltas reach the host (one small sync) only
        # when some slot may exit this tick
        deltas = self.delta.cpu().numpy() if track_exit else None
        for idx, a in enumerate(self._slot):
            if a is None:
                continue
            if needs_refresh[idx]:
                a.full_evals += 1
                a.force_refresh = False      # cache rows rewritten
            else:
                a.cached_evals += 1
            a.i += 1
            finished = early = False
            if a.i >= len(a.ts):
                finished = True
            elif a.exit_tol > 0.0 and a.i >= EXIT_MIN_STEPS:
                if deltas[idx] < a.exit_tol:
                    a.exit_streak += 1
                else:
                    a.exit_streak = 0
                if a.exit_streak >= a.exit_patience:
                    finished = early = True
            if finished:
                p = self._begin_drain(idx, now, wall_clock, early=early)
                if self.overlap_decode:
                    self._pending.append(p)   # waited for next tick
                else:
                    done.append(self._finish_drain(p))
        if caching and had_cached:
            self._phase = (self._phase + 1) % self.cache_interval
        if self.monitor is not None:
            # one process drives every shard, so each records the tick's
            # wall time: the hook a deployment feeds per-device timings
            # into (check() then recommends the elastic_resize target)
            dt = time.perf_counter() - t_tick0
            for i in range(self.mesh.size):
                self.monitor.record(i, dt)
            self._poll_straggler()
        if traced:
            t1 = self.tracer.now()
            self.tracer.complete(
                'tick', t1 - (time.perf_counter() - t_tick0), t1,
                cat='tick', tick=tick_idx, active=int(active.sum()),
                drained=len(done))
            self.tracer.counter('occupancy', cat='engine', tick=tick_idx,
                                active=self.active_count,
                                queued=len(self.queue))
        if self.reporter is not None:
            self.reporter.maybe_report(engine=self)
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

    def replay(self, requests: List[GenerationRequest],
               max_ticks: int = 1_000_000,
               on_result=None) -> List[GenerationResult]:
        """Wall-clock replay of an arrival trace: each request is
        submitted once the serving clock (seconds since this call began)
        passes its ``arrival_time``; the engine sleeps while nothing has
        arrived.  ``on_result`` is called with each result as it
        completes."""
        pending = sorted(requests, key=lambda r: r.arrival_time)
        t0 = self._wall_t0 = time.perf_counter()
        # the trace's clock is the serving clock, so trace timestamps and
        # the results' timing fields agree
        self.tracer.set_origin(t0)
        results: List[GenerationResult] = []
        for _ in range(max_ticks):
            now = time.perf_counter() - t0
            while pending and pending[0].arrival_time <= now:
                self.submit(pending.pop(0), now=now)
            if not self.busy:
                if not pending:
                    return results
                time.sleep(max(0.0, pending[0].arrival_time - now))
                continue
            batch = self.tick(now=time.perf_counter() - t0, wall_clock=True)
            results.extend(batch)
            if on_result is not None:
                for res in batch:
                    on_result(res)
        raise RuntimeError('replay exceeded max_ticks')

    def _throwaway(self):
        """Swap in an empty queue and metrics, no quality probe and no
        tracer for throwaway requests; returns what to restore."""
        saved = (self.queue, self.metrics, self.quality_probe, self.tracer)
        self.queue, self.metrics = AdmissionQueue(), ServingMetrics()
        self.quality_probe = 0          # no fp32 references for throwaways
        self.tracer = NULL_TRACER       # throwaways stay out of the trace
        return saved

    def _restore(self, saved) -> None:
        self.queue, self.metrics, self.quality_probe, self.tracer = saved

    def elastic_resize(self, n_devices: Optional[int] = None,
                       devices=None, warm: bool = True,
                       precisions=('fp32',)) -> List[GenerationResult]:
        """Rebuild the shards on a new ``('data',)`` mesh after devices
        drop or rejoin, keeping in-flight work.

        ``elastic_serving_plan`` sizes the new slot buffer at this
        engine's slots per device (dropped devices shrink it, never
        overload a survivor).  Pending overlapped decodes flush first and
        their results are returned.  In-flight latent and x0 rows gather
        to the host and park ahead of work parked earlier, then re-enter
        the new buffer's free slots; when it is smaller, the overflow
        stays parked and re-enters ahead of the queue as slots free.  The
        context is re-tiled to the new slot count (``_retile_context``:
        its rows must all be equal, even at an unchanged count, since
        requests change slots).
        ``warm=True`` runs ``aot_warmup(precisions)`` on the new shards
        before any parked work re-enters: the kernels loaded and their
        attributes set on every new device, no tick.  ``n_devices`` takes
        the first N devices of the engine's kind (``serving_mesh``);
        ``devices`` names the surviving list."""
        if self.mesh is None:
            raise ValueError('elastic_resize needs a mesh-sharded engine '
                             '(construct with mesh=serving_mesh(...))')
        if n_devices is None and devices is None:
            raise ValueError('pass n_devices or an explicit device list')
        mesh = serving_mesh(n_devices=n_devices, devices=devices,
                            device=self.mesh.devices[0].type)
        old_ndev, new_ndev = self.mesh.size, mesh.size
        _, _, new_slots = elastic_serving_plan(new_ndev,
                                               self._slots_per_device)
        # checked before anything changes: live requests re-pack into the
        # first slots, so rows that differ raise here even at one count
        context = None if self.context is None else \
            self._retile_context(self.context, new_slots)
        flushed = self._flush_pending(overlapped=False)
        live = []
        for idx, a in enumerate(self._slot):
            if a is not None:
                sh, row = self._shard_of(idx)
                live.append((a, sh.x[row].cpu(), sh.x0[row].cpu()))
        # in-flight work ahead of work parked earlier, ahead of the queue
        parked = live + self._parked
        self.mesh, self.slots, self.context = mesh, new_slots, context
        self._slot = [None] * new_slots
        self._parked = []
        self._build_shards()
        self._reset_signatures()
        self.monitor = StepMonitor(n_hosts=new_ndev)
        self._straggler_flagged = ()
        if warm:
            self.aot_warmup(precisions=precisions)
        self._parked = parked
        self.metrics.record_resize(old_ndev, new_ndev)
        self.tracer.instant('elastic_resize', cat='engine',
                            old_devices=old_ndev, new_devices=new_ndev,
                            slots=new_slots, parked=len(self._parked))
        for idx in range(self.slots):
            if not self._parked:
                break
            self._unpark(idx)
        return flushed

    def warmup(self, precisions=('fp32',),
               cache_dir: Optional[str] = None) -> float:
        """Build (all at once) and load the kernels the precisions reach,
        then run throwaway requests per precision (and a guided one when
        the engine holds a context), so every step variant has run on
        every shard before serving; with caching on, each long enough to
        cross a refresh boundary (a refresh and a skip step).
        ``cache_dir`` first enables the persistent kernel cache
        (``compile_cache.enable_persistent_cache``): a cold warmup builds
        the libraries into it, a warm one in a fresh process loads them.
        Returns wall seconds, also recorded in the metrics."""
        if cache_dir is not None:
            enable_persistent_cache(cache_dir)
        t0 = time.perf_counter()
        ops.prepare(self._kernels_for(precisions),
                    [sh.device for sh in self._shards])
        saved = self._throwaway()
        steps = 1 if self.cache_interval <= 1 else self.cache_interval + 1
        try:
            for i, pname in enumerate(precisions):
                for j, g in enumerate((0.0, 7.5) if self.context is not None
                                      else (0.0,)):
                    self.submit(GenerationRequest(
                        request_id=-(2 * i + j + 1), seed=0, steps=steps,
                        guidance=g, exit_tol=0.0, precision=pname), now=0.0)
                    self.run_until_idle(now=0.0)
        finally:
            self._restore(saved)
        dt = time.perf_counter() - t0
        self.metrics.record_warmup(dt)
        if self.tracer.enabled:
            t1 = self.tracer.now()
            self.tracer.complete('warmup', t1 - dt, t1, cat='engine',
                                 precisions=list(precisions), seconds=dt)
        trim_cache()    # the persistent cache's size bound, if any
        return dt

    def measure_tick_s(self, steps: int = 4) -> float:
        """Steady-state wall seconds per tick at full slot occupancy
        (throwaway requests; metrics and trace untouched): the capacity
        anchor for overload sizing, since the engine completes ``slots /
        (steps * tick_s)`` requests/s.  Call after warmup, so no build
        or first-call time leaks in.  Also sets ``tick_s_estimate``."""
        saved = self._throwaway()
        try:
            for i in range(self.slots):
                self.submit(GenerationRequest(request_id=-(100 + i),
                                              seed=i, steps=steps,
                                              exit_tol=0.0), now=0.0)
            t0 = time.perf_counter()
            self.run_until_idle(now=0.0)
            dt = time.perf_counter() - t0
            ticks = max(self.metrics.ticks, 1)
        finally:
            self._restore(saved)
        self._tick_s = dt / ticks
        return self._tick_s
