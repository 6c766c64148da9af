"""Continuous-batching diffusion serving on one GPU with per-request
precision selection (port of ``repro/serving``)::

    pipe = DiffusionPipeline.init(0, SD_V1_4, VAE_512)        # on the GPU
    engine = ContinuousBatchingEngine(pipe, slots=4, context=ctx)
    engine.warmup(precisions=('fp32', 'w8a8'))    # builds the kernels
    engine.submit(GenerationRequest(request_id=0, seed=42, steps=50,
                                    precision='w8a8'))
    while engine.busy:
        for result in engine.tick():
            ...  # result.image, result.quality_psnr_db
"""
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.serving.api import GenerationRequest, GenerationResult
from repro_torch.serving.batcher import group_by_precision, plan_tick
from repro_torch.serving.engine import ContinuousBatchingEngine
from repro_torch.serving.metrics import (FrontierPoint, MetricsSnapshot,
                                         ServingMetrics)
from repro_torch.serving.queue import SHED_POLICIES, AdmissionQueue

__all__ = [
    'GenerationRequest', 'GenerationResult', 'ContinuousBatchingEngine',
    'AdmissionQueue', 'SHED_POLICIES', 'ServingMetrics', 'MetricsSnapshot',
    'PrecisionPolicy', 'FrontierPoint', 'group_by_precision', 'plan_tick',
]
