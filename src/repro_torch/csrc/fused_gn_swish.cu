// Fused GroupNorm + swish over NHWC float32 activations, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/fused_gn_swish.py::fused_gn_swish_kernel
// which normalises one (batch, group) slab (H, W, C/g) per program, applies
// the per-channel affine and then y * sigmoid(y), in one pass through VMEM;
// and the earlier version of this file, one 512-thread block per slab that
// read the slab from device memory three times.
//
// What bounds it on the H100: bytes.  Each element must be read once and
// written once (2 * N*H*W*C * 4 bytes over 3.35 TB/s); the arithmetic (about
// ten float operations per element) is far below the card's rate.  A slab of
// the Stable Diffusion v1.4 UNet is up to 64x64x34 floats = 557 KB, above
// the 227 KB of shared memory one block may use, and at batch 4 there are
// only 80 to 128 slabs for 132 SMs.
//
// Design: one thread-block cluster per (n, group) slab.  The slab is split
// along H*W into `cluster` chunks of `chunk` positions, one per block (the
// host plans both, at most 8 blocks a cluster, about 32 KB a block, so that
// a chunk fits in shared memory and the grid has 160 to 960 blocks at
// batch 4 instead of 80 to 128).  Each block copies its chunk from device
// memory into shared memory once, with cp.async of 16, 8 or 4 bytes as C/g
// allows (C/g is 68, 34, or 17 and 85 on the path, so rows are not 16-byte
// aligned), each thread owning fixed channels of every R-th row, then
//   1. sums its chunk, and the cluster adds the blocks' partial sums through
//      distributed shared memory (every block reads them in rank order, so
//      all blocks hold the same mean);
//   2. sums (x - mean)^2 over its chunk the same way -> the variance, the
//      reference's two-pass formula, both passes from shared memory;
//   3. writes y = (x - mean) * rsqrt(var + eps) * scale[c] + bias[c],
//      out = y * sigmoid(y), once.
// Device traffic is then the bound's count: one read, one write.  Sums
// accumulate in double so the statistics do not depend on the summation
// order to within float rounding.  A chunk too large for shared memory even
// in a cluster of 8 (no Stable Diffusion v1.4 slab is) is read from device
// memory in each pass instead (RESIDENT = false), with the same arithmetic.
//
// What still holds it back: a block's load, reductions and store run one
// after the other, and the blocks of a wave run them in step, so the read
// and write streams do not overlap within a wave; the 64x64 slabs fill 0.9
// to 2.7 waves.  A group's row is only 68 to 340 bytes of a longer NHWC
// row, which costs sectors at its edges.  A persistent cluster that loads
// its next slab while it writes this one is the next step.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;

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
  }
  return total;   // valid in thread 0
}

template <int VEC> struct Vec;
template <> struct Vec<1> { using T = float; };
template <> struct Vec<2> { using T = float2; };
template <> struct Vec<4> { using T = float4; };

__device__ __forceinline__ float lane(float v, int) { return v; }
__device__ __forceinline__ float lane(float2 v, int j) { return j ? v.y : v.x; }
__device__ __forceinline__ float lane(float4 v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}
__device__ __forceinline__ void set_lane(float& v, int, float f) { v = f; }
__device__ __forceinline__ void set_lane(float2& v, int j, float f) { (j ? v.y : v.x) = f; }
__device__ __forceinline__ void set_lane(float4& v, int j, float f) {
  (j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w) = f;
}

// A row of the chunk is cg = C/g channels, read as P = cg / VEC vectors of
// VEC floats (VEC divides cg).  Thread t owns the vector columns t % P +
// j * kThreads (one column unless P > kThreads) of the rows t / P + k * R,
// R = max(1, kThreads / P): consecutive threads cover consecutive
// addresses, a thread keeps its channels' scale and bias in registers, and
// no element index is divided by cg.
template <bool RESIDENT, int VEC>
__global__ void __launch_bounds__(kThreads)
fused_gn_swish_kernel(const float* __restrict__ x, const float* __restrict__ scale,
                      const float* __restrict__ bias, float* __restrict__ out,
                      int HW, int C, int cg_, int chunk, float eps) {
  using V = typename Vec<VEC>::T;
  extern __shared__ __align__(16) float slab[];
  __shared__ double scratch[kThreads / 32];
  __shared__ double partial[2];          // this block's sum, sum of squares
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int nblk = (int)cluster.num_blocks();
  const int g = blockIdx.y, n = blockIdx.z;
  const int hw0 = rank * chunk;
  const int rows = max(0, min(chunk, HW - hw0));
  const long long base = (long long)n * HW * C + (long long)hw0 * C + (long long)g * cg_;
  const int per_row = cg_ / VEC;
  const int R = max(1, kThreads / per_row);
  const int r = threadIdx.x / per_row;
  const int col0 = (threadIdx.x - r * per_row) * VEC;
  const int hw_begin = r < R ? r : rows;  // idle threads own no row
  auto load = [&](int hw, int c) -> V {
    return RESIDENT ? *reinterpret_cast<const V*>(slab + hw * cg_ + c)
                    : *reinterpret_cast<const V*>(x + base + (long long)hw * C + c);
  };

  // Each thread reads back only what it copied itself: no barrier between
  // the copies and the first pass.
  if (RESIDENT) {
    for (int c = col0; c < cg_; c += kThreads * VEC) {
      for (int hw = hw_begin; hw < rows; hw += R) {
        const unsigned dst =
            static_cast<unsigned>(__cvta_generic_to_shared(slab + hw * cg_ + c));
        const float* src = x + base + (long long)hw * C + c;
        if (VEC == 4)
          asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" :: "r"(dst), "l"(src) : "memory");
        else if (VEC == 2)
          asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" :: "r"(dst), "l"(src) : "memory");
        else
          asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" :: "r"(dst), "l"(src) : "memory");
      }
    }
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
  }

  double s = 0.0;
  for (int c = col0; c < cg_; c += kThreads * VEC) {
    for (int hw = hw_begin; hw < rows; hw += R) {
      const V v = load(hw, c);
#pragma unroll
      for (int j = 0; j < VEC; ++j) s += lane(v, j);
    }
  }
  s = block_sum(s, scratch);
  if (threadIdx.x == 0) partial[0] = s;
  cluster.sync();
  double total = 0.0;
  for (int q = 0; q < nblk; ++q) total += *cluster.map_shared_rank(&partial[0], q);
  const double n_elem = (double)HW * cg_;
  const float mean = (float)(total / n_elem);

  double ss = 0.0;
  for (int c = col0; c < cg_; c += kThreads * VEC) {
    for (int hw = hw_begin; hw < rows; hw += R) {
      const V v = load(hw, c);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float d = lane(v, j) - mean;
        ss += (double)d * d;
      }
    }
  }
  __syncthreads();                       // scratch is reused
  ss = block_sum(ss, scratch);
  if (threadIdx.x == 0) partial[1] = ss;
  cluster.sync();
  total = 0.0;
  for (int q = 0; q < nblk; ++q) total += *cluster.map_shared_rank(&partial[1], q);
  // done reading the other blocks' shared memory: they may exit once all
  // have arrived
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  const float var = (float)(total / n_elem);
  const float rstd = 1.0f / sqrtf(var + eps);

  for (int c = col0; c < cg_ && r < R; c += kThreads * VEC) {
    float sc[VEC], bi[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      sc[j] = scale[g * cg_ + c + j];
      bi[j] = bias[g * cg_ + c + j];
    }
    for (int hw = hw_begin; hw < rows; hw += R) {
      V v = load(hw, c);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        float y = (lane(v, j) - mean) * rstd;
        y = y * sc[j] + bi[j];
        set_lane(v, j, y / (1.0f + expf(-y)));
      }
      *reinterpret_cast<V*>(out + base + (long long)hw * C + c) = v;
    }
  }
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Raise the kernel's dynamic shared-memory limit on the current device to
// `smem` if it is lower (0 in the table: the default 48 KiB).
template <bool RESIDENT, int VEC>
cudaError_t allow_smem(size_t smem) {
  static size_t allowed[kMaxDevices] = {};
  const int dev = device_slot();
  if (dev < 0) return cudaErrorInvalidDevice;
  if (smem <= (allowed[dev] ? allowed[dev] : 48 * 1024)) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(fused_gn_swish_kernel<RESIDENT, VEC>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) allowed[dev] = smem;
  return e;
}

template <bool RESIDENT, int VEC>
int launch(const float* x, const float* scale, const float* bias, float* out,
           int N, int HW, int C, int groups, int cluster, int chunk, float eps,
           cudaStream_t stream) {
  const int cgw = C / groups;
  const size_t smem = RESIDENT ? sizeof(float) * (size_t)chunk * cgw : 0;
  cudaError_t e = allow_smem<RESIDENT, VEC>(smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, groups, N);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, fused_gn_swish_kernel<RESIDENT, VEC>, x, scale, bias, out,
                         HW, C, cgw, chunk, eps);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <bool RESIDENT, int VEC>
int max_clusters(int cluster, size_t smem) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (allow_smem<RESIDENT, VEC>(smem) != cudaSuccess) return -1;
  int n = -1;
  if (cudaOccupancyMaxActiveClusters(&n, fused_gn_swish_kernel<RESIDENT, VEC>, &cfg) != cudaSuccess)
    return -1;
  return n;
}

template <bool RESIDENT>
int launch_vec(const float* x, const float* scale, const float* bias, float* out,
               int N, int HW, int C, int groups, int cluster, int chunk, float eps,
               cudaStream_t stream) {
  const int cgw = C / groups;
  const uintptr_t align = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out);
  if (cgw % 4 == 0 && align % 16 == 0)
    return launch<RESIDENT, 4>(x, scale, bias, out, N, HW, C, groups, cluster, chunk, eps, stream);
  if (cgw % 2 == 0 && align % 8 == 0)
    return launch<RESIDENT, 2>(x, scale, bias, out, N, HW, C, groups, cluster, chunk, eps, stream);
  return launch<RESIDENT, 1>(x, scale, bias, out, N, HW, C, groups, cluster, chunk, eps, stream);
}

}  // namespace

// x, out: (N, H, W, C) contiguous float32; scale, bias: (C,) float32;
// C % groups == 0.  One cluster of `cluster` blocks (1..8) per (n, group),
// `chunk` H*W positions per block (cluster * chunk >= HW); resident != 0
// keeps each chunk in shared memory (chunk * C/groups * 4 bytes).
// Launches on `stream`; returns a CUDA error code.
extern "C" int fused_gn_swish_f32(const float* x, const float* scale, const float* bias,
                                  float* out, int N, int HW, int C, int groups,
                                  int cluster, int chunk, int resident, float eps,
                                  cudaStream_t stream) {
  if (groups <= 0 || C % groups || cluster < 1 || cluster > 8 ||
      (long long)cluster * chunk < HW)
    return (int)cudaErrorInvalidValue;
  return resident ? launch_vec<true>(x, scale, bias, out, N, HW, C, groups, cluster,
                                     chunk, eps, stream)
                  : launch_vec<false>(x, scale, bias, out, N, HW, C, groups, cluster,
                                      chunk, eps, stream);
}

// How many clusters of `cluster` blocks with `smem` bytes of dynamic shared
// memory each (0: streaming) the card holds at once, for a group width cg;
// -1 on error.  A diagnostic: launches nothing.
extern "C" int fused_gn_swish_max_clusters(int cg, int cluster, int smem) {
  const int vec = cg % 4 == 0 ? 4 : cg % 2 == 0 ? 2 : 1;
  if (smem == 0)
    return vec == 4 ? max_clusters<false, 4>(cluster, 0)
         : vec == 2 ? max_clusters<false, 2>(cluster, 0) : max_clusters<false, 1>(cluster, 0);
  return vec == 4 ? max_clusters<true, 4>(cluster, smem)
       : vec == 2 ? max_clusters<true, 2>(cluster, smem) : max_clusters<true, 1>(cluster, smem);
}

// Raise the shared-memory limit of every resident variant on the current
// device to the most a block may opt in to, less its static shared memory,
// so no launch there needs to (the streaming variants use none); launches
// nothing.  Returns a CUDA error code.
template <int VEC>
cudaError_t allow_most(int most) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, fused_gn_swish_kernel<true, VEC>);
  if (e != cudaSuccess) return e;
  return allow_smem<true, VEC>((size_t)most - a.sharedSizeBytes);
}

extern "C" int fused_gn_swish_prepare() {
  int dev = 0, most = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = allow_most<4>(most);
  if (e == cudaSuccess) e = allow_most<2>(most);
  if (e == cudaSuccess) e = allow_most<1>(most);
  return (int)e;
}
