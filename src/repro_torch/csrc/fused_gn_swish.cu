// Fused GroupNorm + swish over NHWC float32 activations, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/fused_gn_swish.py::fused_gn_swish_kernel
// which normalises one (batch, group) slab (H, W, C/g) per program, applies
// the per-channel affine and then y * sigmoid(y), in one pass through VMEM.
//
// What bounds it on the H100: bytes.  Each element is read once and written
// once (2 * N*H*W*C * 4 bytes over 3.35 TB/s); the arithmetic (about ten
// float operations per element) is far below the card's rate.
//
// Design.  One block of 512 threads per (group, n).  The TPU kernel holds
// the whole slab in VMEM; a 64x64x34 float slab of the Stable Diffusion
// v1.4 UNet is 557 KB, above the 227 KB of shared memory a block may use, so
// this kernel stages nothing: it re-reads the slab from device memory on
// each of three passes (the slab is small enough to stay in the 50 MB L2
// between passes).
//   pass 1: block reduction of sum(x)           -> mean
//   pass 2: block reduction of sum((x - mean)^2) -> variance (two-pass, as
//           the reference computes it)
//   pass 3: y = (x - mean) * rsqrt(var + eps) * scale[c] + bias[c];
//           out = y * sigmoid(y)
// Sums accumulate in double so the statistics do not depend on the
// summation order to within float rounding.  The group width C/g is not a
// power of two on the UNet's path (17, 34, 68, 85), so the NHWC offset
// n*HWC + hw*C + g*cg + c is formed with a true division by cg.
//
// Known limit (a later change's problem): only N*G blocks run, B*20 to B*32
// on the UNet's path, fewer than the card's 132 SMs at small batch, so the
// kernel cannot reach the memory rate there.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 512;

__device__ double block_sum(double v, double* scratch) {
  // warp shuffle, then one value per warp through shared memory
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  double total = 0.0;
  if (warp == 0) {
    total = lane < (kThreads / 32) ? scratch[lane] : 0.0;
    for (int off = 16; off > 0; off >>= 1)
      total += __shfl_down_sync(0xffffffffu, total, off);
    if (lane == 0) scratch[0] = total;
  }
  __syncthreads();
  total = scratch[0];
  __syncthreads();  // scratch is reused by the next reduction
  return total;
}

__global__ void __launch_bounds__(kThreads)
fused_gn_swish_kernel(const float* __restrict__ x, const float* __restrict__ scale,
                      const float* __restrict__ bias, float* __restrict__ out,
                      int HW, int C, int cg, float eps) {
  __shared__ double scratch[kThreads / 32];
  const int g = blockIdx.x, n = blockIdx.y;
  const long long base = (long long)n * HW * C + (long long)g * cg;
  const int count = HW * cg;

  double s = 0.0;
  for (int i = threadIdx.x; i < count; i += kThreads) {
    const int hw = i / cg, c = i - hw * cg;
    s += x[base + (long long)hw * C + c];
  }
  const float mean = (float)(block_sum(s, scratch) / count);

  double ss = 0.0;
  for (int i = threadIdx.x; i < count; i += kThreads) {
    const int hw = i / cg, c = i - hw * cg;
    const float d = x[base + (long long)hw * C + c] - mean;
    ss += (double)d * d;
  }
  const float var = (float)(block_sum(ss, scratch) / count);
  const float rstd = 1.0f / sqrtf(var + eps);

  for (int i = threadIdx.x; i < count; i += kThreads) {
    const int hw = i / cg, c = i - hw * cg;
    const long long off = base + (long long)hw * C + c;
    float y = (x[off] - mean) * rstd;
    y = y * scale[g * cg + c] + bias[g * cg + c];
    out[off] = y / (1.0f + expf(-y));
  }
}

}  // namespace

// x, out: (N, H, W, C) contiguous float32; scale, bias: (C,) float32.
// C % groups == 0.  Launches on `stream`; returns cudaGetLastError().
extern "C" int fused_gn_swish_f32(const float* x, const float* scale, const float* bias,
                                  float* out, int N, int HW, int C, int groups, float eps,
                                  cudaStream_t stream) {
  dim3 grid(groups, N);
  fused_gn_swish_kernel<<<grid, kThreads, 0, stream>>>(x, scale, bias, out, HW, C,
                                                       C / groups, eps);
  return (int)cudaGetLastError();
}
