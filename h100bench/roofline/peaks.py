"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, at the
700 W power limit; a card set below it runs slower, and the result line
gives no power reading: ``PERF.md`` states the limit beside each run).

``FP32_FLOPS`` is the rate at which the tensor cores compute float32
products exactly enough to stand for float32: error-compensated TF32
(three TF32 products per float32 product), 495 / 3 TFLOP/s, the rate
the repository's own flash kernel runs at.  The SIMT float32 rate, 67
TFLOP/s, is lower than what a correct 3xTF32 kernel reaches, so a share
of it could pass 100%.
"""
INT8_OPS = 1979e12          # int8 tensor-core operations per second
FP32_FLOPS = 495e12 / 3     # float32 products through 3xTF32
HBM_BYTES = 3.35e12         # device memory bytes per second

PEAK = {'int8': INT8_OPS, 'fp32': FP32_FLOPS}


def least_s(ops: float, nbytes: float, precision: str) -> float:
    """The least time the card needs for one call: operations over the
    peak of their precision, or bytes over the memory rate, the larger."""
    return max(ops / PEAK[precision], nbytes / HBM_BYTES)
