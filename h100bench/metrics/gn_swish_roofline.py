"""The GroupNorm+swish kernel (``csrc/fused_gn_swish.cu``): the least time
of the calls the slice's UNet evaluations made, over the kernel's device
time."""
from roofline.shares import roofline


def read(layers):
    return roofline(layers, 'gn_swish', 'fused_gn_swish_kernel')
