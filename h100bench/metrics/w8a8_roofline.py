"""The W8A8 GEMM (``csrc/w8a8_matmul.cu``): the int8 product with its
scales, the least time of the slice's products over the device time of
the GEMM and its epilogue (the activations' quantization is outside)."""
from roofline.shares import roofline


def read(layers):
    return roofline(layers, 'w8a8', 'w8a8_wgmma_kernel', 'w8a8_epilogue_kernel')
