"""PyTorch/CUDA port of the DiffLight diffusion-serving reproduction.

Mirrors the module layout of the JAX package ``repro`` so each function
has an obvious counterpart, but imports nothing of it (and never
``jax``).  Plain tensor code is PyTorch; the two Pallas kernels on the
Stable Diffusion serving path (fused GroupNorm+swish and the W8A8 GEMM)
are hand-written CUDA C++ for Hopper under ``csrc/``, built on first use
by ``kernels/build.py``.

Entry points run on the GPU unless the caller asks for the CPU
(``device='cpu'``), where every kernel wrapper runs its plain PyTorch
version instead.
"""
