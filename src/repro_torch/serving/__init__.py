"""Continuous-batching diffusion serving on the GPU with per-request
precision selection, DeepCache phasing, early exit, photonic energy
accounting, decode overlap, tracing, the slot axis sharded over a device
mesh with elastic resize, and per-bucket routing (port of
``repro/serving``)::

    pipe = DiffusionPipeline.init(0, SD_V1_4, VAE_512)        # on the GPU
    engine = ContinuousBatchingEngine(pipe, slots=4, context=ctx,
                                      cache_interval=3, exit_tol=0.01)
    engine.warmup(precisions=('fp32', 'w8a8', 'w8a8+noise'),
                  cache_dir='/var/cache/repro-kernels')    # kernels kept
    engine.submit(GenerationRequest(request_id=0, seed=42, steps=50,
                                    precision='w8a8+noise'))
    while engine.busy:
        for result in engine.tick():
            ...  # result.image, result.energy_j, result.quality_psnr_db

    sharded = ContinuousBatchingEngine(pipe, mesh=serving_mesh(2),
                                       slots_per_device=2, context=ctx)
    sharded.elastic_resize(n_devices=1)   # a card dropped: work parks
"""
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.serving.api import GenerationRequest, GenerationResult
from repro_torch.serving.batcher import (Bucket, BucketRouter, align_slots,
                                         bucket_for, choose_slots,
                                         group_by_precision, offered_load,
                                         overload_factor, plan_tick,
                                         split_cache_phase)
from repro_torch.serving.compile_cache import (active_cache_dir,
                                               cache_entries,
                                               cache_evictions,
                                               disable_persistent_cache,
                                               enable_persistent_cache,
                                               trim_cache)
from repro_torch.serving.engine import ContinuousBatchingEngine
from repro_torch.serving.metrics import (FrontierPoint, MetricsSnapshot,
                                         PhotonicAccountant, ServingMetrics)
from repro_torch.serving.queue import SHED_POLICIES, AdmissionQueue

__all__ = [
    'GenerationRequest', 'GenerationResult', 'ContinuousBatchingEngine',
    'AdmissionQueue', 'SHED_POLICIES', 'ServingMetrics', 'MetricsSnapshot',
    'PrecisionPolicy', 'PhotonicAccountant', 'FrontierPoint',
    'Bucket', 'BucketRouter', 'bucket_for', 'align_slots', 'choose_slots', 'group_by_precision', 'offered_load',
    'overload_factor', 'plan_tick', 'split_cache_phase',
    'enable_persistent_cache', 'disable_persistent_cache',
    'active_cache_dir', 'cache_entries', 'cache_evictions', 'trim_cache',
]
