"""The flash-attention kernel (``csrc/flash_attention.cu``): the least
time of the slice's prefill attention (float32 products at the 3xTF32
rate) over the kernel's device time."""
from roofline.shares import roofline


def read(layers):
    return roofline(layers, 'flash', 'flash_attention_tf32_kernel')
