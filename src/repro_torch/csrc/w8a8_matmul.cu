// W8A8 GEMM for Hopper (sm_90a) on the int8 tensor cores:
//   int8 (M, K) x int8 (K, N) accumulated exactly in int32, then the float32
//   epilogue  out[m][n] = (float)acc * xs[m] * ws[n].
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/w8a8_matmul.py::w8a8_matmul_kernel
// (DiffLight C1: MR-bank MACs; the int32 accumulator stands for the balanced
// photodetector, the two scales for the MR transmission calibration), and
// the earlier __dp4a kernel of this file, which ran on the CUDA cores.
//
// What bounds it on the H100.  At the Stable Diffusion v1.4 shapes
// (M = B*1024 .. B*77 rows, K and N 680 .. 1360) every product is bound by
// bytes, chiefly the float32 output, and is so small (a few microseconds at
// 3.35 TB/s) that latency and the number of blocks in flight decide its
// time.  At the InternLM2-1.8B prefill (M = 4000, K, N up to 8192) it is
// bound by the int8 tensor-core rate (1979 TOP/s).  At the LM's decode step
// (M = 4) it is bound by the weight bytes alone.
//
// Design.
// * wgmma.mma_async m64nNk32 .s32.s8.s8 on operands in shared memory.  The
//   8-bit forms take both operands K-major only (no transpose flag), so the
//   weight comes as an (N, Kp) K-major copy, built by the wrapper.  Both
//   operands have K padded to a multiple of 16 with zeros (TMA needs global
//   row strides that are multiples of 16 bytes; a zero adds nothing to an
//   int32 sum), and nothing else: TMA's out-of-bounds zero fill covers
//   ragged M, N and the last K box.
// * A block computes a 128 x BN tile D[r][c] = sum_k P[r][k] Q[c][k]: two
//   consumer warpgroups of 64 rows each, and one producer warp that keeps a
//   ring of STAGES shared-memory stages full with TMA loads (128-byte
//   swizzle, boxes of 128 K bytes), with a full and an empty mbarrier per
//   stage.  Each stage feeds four wgmma of k32.
// * Large M (M >= 64): P is the activation tile (rows m), Q the weight tile
//   (rows n), BN = 128.  The grid runs M tiles fastest, so blocks that run
//   together share one weight tile in L2 (the TPU kernel's "DAC sharing").
// * Small M (M < 64, the LM decode step): A and B swap.  The weight is P,
//   the activations Q with BN = M rounded up to 8/16/32/64, so no 64-row
//   tile is spent on four rows, and K is split over blockIdx.z until about
//   132 blocks stream the weight.  Split partials add exactly into a zeroed
//   int32 scratch (atomics on integers are exact in any order), and a second
//   kernel applies the float32 epilogue once the sum is complete.
// * The epilogue multiplies in the reference's order with __fmul_rn, no
//   fused add, and writes float32 with masked stores (a TMA store would need
//   N * 4 to be a multiple of 16).  The file must not be built with
//   --use_fast_math.
// * Tensor maps are encoded on the host per call and passed as
//   __grid_constant__ parameters; cuTensorMapEncodeTiled comes from the
//   driver through the runtime's entry-point query, so no -lcuda is needed.
//   These helpers, the mbarriers and the descriptors live in hopper.cuh,
//   shared with the flash-attention kernel.
//
// What still holds it back: the SD products are a few microseconds of
// launch and pipeline fill each (18 to 192 blocks, 6 to 11 K boxes); at the
// LM prefill the consumers wait for each stage's wgmma before releasing it
// and one 132 KB block runs per SM (about a third of the int8 peak).
// Keeping a wgmma group in flight, wider tiles and a persistent grid are
// the next steps.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BK = 128;               // K bytes per stage: one swizzle row
constexpr int ROWS = 128;             // P rows per block
constexpr int kConsumers = 2;         // consumer warpgroups of 64 rows
constexpr int kThreads = 128 * kConsumers + 32;   // + one producer warp

constexpr int STAGES = 4;           // shared-memory ring depth
template <int BN> constexpr int smem_bytes() {
  return STAGES * (ROWS + BN) * BK + 2 * STAGES * 8 + 1024;
}

__device__ __forceinline__ void wgmma_s8_n8(int (&d)[4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_s8_n16(int (&d)[8], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_s8_n32(int (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_s8_n64(int (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}


template <int BN>
__device__ __forceinline__ void wgmma_s8(int (&d)[BN / 2], uint64_t da, uint64_t db) {
  if constexpr (BN == 8) wgmma_s8_n8(d, da, db);
  else if constexpr (BN == 16) wgmma_s8_n16(d, da, db);
  else if constexpr (BN == 32) wgmma_s8_n32(d, da, db);
  else if constexpr (BN == 64) wgmma_s8_n64(d, da, db);
  else wgmma_s8_n128(d, da, db);
}

// One 128 x BN tile of D = P Q^T over the K boxes [z * nk, (z + 1) * nk).
// SWAP: P holds the weight (rows n) and Q the activations (rows m).
// acc_out != nullptr: add the int32 tile into acc_out (split K); else write
// the float32 epilogue into out.
template <int BN, bool SWAP>
__global__ void __launch_bounds__(kThreads, 1)
w8a8_wgmma_kernel(const __grid_constant__ CUtensorMap tp,
                  const __grid_constant__ CUtensorMap tq,
                  const float* __restrict__ xs, const float* __restrict__ ws,
                  float* __restrict__ out, int* __restrict__ acc_out,
                  int M, int N, int nk) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sp = smem;                              // STAGES x ROWS x BK
  uint8_t* sq = smem + STAGES * ROWS * BK;         // STAGES x BN x BK
  uint64_t* full = reinterpret_cast<uint64_t*>(sq + STAGES * BN * BK);
  uint64_t* empty = full + STAGES;

  const int r0 = blockIdx.x * ROWS, c0 = blockIdx.y * BN;
  const int kb0 = blockIdx.z * nk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * kConsumers) {                    // producer warp
    if (lane == 0) {
      for (int i = 0; i < nk; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(&empty[s], (i / STAGES - 1) & 1);
        mbar_expect_tx(&full[s], (ROWS + BN) * BK);
        const int k = (kb0 + i) * BK;
        tma_load(sp + s * ROWS * BK, &tp, k, r0, &full[s]);
        tma_load(sq + s * BN * BK, &tq, k, c0, &full[s]);
      }
    }
    return;
  }

  const int wg = warp >> 2;                        // consumer warpgroup
  int acc[BN / 2];
#pragma unroll
  for (int j = 0; j < BN / 2; ++j) acc[j] = 0;
#pragma unroll
  for (int j = 0; j < BN / 2; ++j) fence_operand(acc[j]);

  for (int i = 0; i < nk; ++i) {
    const int s = i % STAGES;
    mbar_wait(&full[s], (i / STAGES) & 1);
    const uint32_t pa = smem_u32(sp + s * ROWS * BK + wg * 64 * BK);
    const uint32_t qa = smem_u32(sq + s * BN * BK);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk)
      wgmma_s8<BN>(acc, desc_sw128(pa + kk * 32), desc_sw128(qa + kk * 32));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) fence_operand(acc[j]);
    if ((threadIdx.x & 127) == 0) mbar_arrive(&empty[s]);
  }

  // accumulator fragment of m64nBN: register 4 j + 2 h + e holds row
  // 16 (warp % 4) + lane / 4 + 8 h, column 8 j + 2 (lane % 4) + e
  const int rbase = r0 + wg * 64 + (warp & 3) * 16 + (lane >> 2);
  const int cbase = c0 + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = rbase + 8 * h, c = cbase + 8 * j;
      const int v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if constexpr (SWAP) {            // rows are n, columns m
        if (r >= N) continue;
        const float sw = ws[r];
        if (c < M) {
          if (acc_out) atomicAdd(&acc_out[(long long)c * N + r], v0);
          else out[(long long)c * N + r] = __fmul_rn(__fmul_rn((float)v0, xs[c]), sw);
        }
        if (c + 1 < M) {
          if (acc_out) atomicAdd(&acc_out[(long long)(c + 1) * N + r], v1);
          else out[(long long)(c + 1) * N + r] = __fmul_rn(__fmul_rn((float)v1, xs[c + 1]), sw);
        }
      } else {                         // rows are m, columns n
        if (r >= M || c >= N) continue;
        const float sx = xs[r];
        const long long o = (long long)r * N + c;
        if (acc_out) {
          atomicAdd(&acc_out[o], v0);
          if (c + 1 < N) atomicAdd(&acc_out[o + 1], v1);
        } else if (c + 1 < N && (N & 1) == 0) {    // 8-byte aligned pair
          *reinterpret_cast<float2*>(out + o) =
              make_float2(__fmul_rn(__fmul_rn((float)v0, sx), ws[c]),
                          __fmul_rn(__fmul_rn((float)v1, sx), ws[c + 1]));
        } else {
          out[o] = __fmul_rn(__fmul_rn((float)v0, sx), ws[c]);
          if (c + 1 < N) out[o + 1] = __fmul_rn(__fmul_rn((float)v1, sx), ws[c + 1]);
        }
      }
    }
  }
}

// The float32 epilogue over a complete int32 sum (after a split-K GEMM).
__global__ void w8a8_epilogue_kernel(const int* __restrict__ acc,
                                     const float* __restrict__ xs,
                                     const float* __restrict__ ws,
                                     float* __restrict__ out, int M, int N) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)M * N) return;
  const int m = (int)(i / N), n = (int)(i - (long long)m * N);
  out[i] = __fmul_rn(__fmul_rn((float)acc[i], xs[m]), ws[n]);
}

// Tensor map of a (rows, kp) int8 K-major matrix, boxes of box_rows x BK,
// 128-byte swizzle, zero fill out of bounds.
bool encode(CUtensorMap* map, const int8_t* ptr, int rows, int kp, int box_rows) {
  EncodeTiled fn = encode_fn();
  if (!fn) return false;
  cuuint64_t dims[2] = {(cuuint64_t)kp, (cuuint64_t)rows};
  cuuint64_t strides[1] = {(cuuint64_t)kp};
  cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)box_rows};
  cuuint32_t estr[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<int8_t*>(ptr),
            dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Raise the kernel's dynamic shared-memory limit on the current device,
// once per device.
template <int BN, bool SWAP>
cudaError_t configure() {
  static bool configured[kMaxDevices] = {};
  const int dev = device_slot();
  if (dev < 0) return cudaErrorInvalidDevice;
  if (configured[dev]) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(w8a8_wgmma_kernel<BN, SWAP>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       smem_bytes<BN>());
  if (e == cudaSuccess) configured[dev] = true;
  return e;
}

template <int BN, bool SWAP>
int launch(const int8_t* xq, const float* xs, const int8_t* wt, const float* ws,
           float* out, int* scratch, int M, int N, int kp, int split,
           cudaStream_t stream) {
  {
    cudaError_t e = configure<BN, SWAP>();
    if (e != cudaSuccess) return (int)e;
  }
  const int rows_p = SWAP ? N : M, rows_q = SWAP ? M : N;
  const int kboxes = (kp + BK - 1) / BK;
  if (split < 1 || kboxes % split) return (int)cudaErrorInvalidValue;
  CUtensorMap tp, tq;
  if (!encode(&tp, SWAP ? wt : xq, rows_p, kp, ROWS) ||
      !encode(&tq, SWAP ? xq : wt, rows_q, kp, BN))
    return (int)cudaErrorInvalidValue;
  int* acc_out = nullptr;
  if (split > 1) {
    cudaError_t e = cudaMemsetAsync(scratch, 0, sizeof(int) * (size_t)M * N, stream);
    if (e != cudaSuccess) return (int)e;
    acc_out = scratch;
  }
  dim3 grid((rows_p + ROWS - 1) / ROWS, (rows_q + BN - 1) / BN, split);
  w8a8_wgmma_kernel<BN, SWAP><<<grid, kThreads, smem_bytes<BN>(), stream>>>(
      tp, tq, xs, ws, out, acc_out, M, N, kboxes / split);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || split == 1) return (int)e;
  const long long total = (long long)M * N;
  w8a8_epilogue_kernel<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      scratch, xs, ws, out, M, N);
  return (int)cudaGetLastError();
}

}  // namespace

// xq (M, kp) int8 and wt (N, kp) int8, both K-major with K zero-padded to
// kp % 16 == 0 and 16-byte aligned; xs (M,) and ws (N,) float32; out (M, N)
// float32; scratch (M, N) int32 when split > 1 (else unused).  bn is the
// tile width: 128 with swap = 0 (M >= 64), or 8 / 16 / 32 / 64 >= M with
// swap = 1.  split divides the number of 128-byte K boxes.  Launches on
// `stream` (split > 1: memset, GEMM, epilogue); returns a CUDA error code.
extern "C" int w8a8_matmul_s8(const int8_t* xq, const float* xs, const int8_t* wt,
                              const float* ws, float* out, int* scratch, int M,
                              int N, int kp, int swap, int bn, int split,
                              cudaStream_t stream) {
  if (M <= 0 || N <= 0 || kp <= 0 || kp % 16) return (int)cudaErrorInvalidValue;
  if (!swap && bn == 128)
    return launch<128, false>(xq, xs, wt, ws, out, scratch, M, N, kp, split, stream);
  if (swap && bn >= M) {
    switch (bn) {
      case 8: return launch<8, true>(xq, xs, wt, ws, out, scratch, M, N, kp, split, stream);
      case 16: return launch<16, true>(xq, xs, wt, ws, out, scratch, M, N, kp, split, stream);
      case 32: return launch<32, true>(xq, xs, wt, ws, out, scratch, M, N, kp, split, stream);
      case 64: return launch<64, true>(xq, xs, wt, ws, out, scratch, M, N, kp, split, stream);
    }
  }
  return (int)cudaErrorInvalidValue;
}

// Raise every tile width's shared-memory limit on the current device, as
// its first launch there would; launches nothing.  Returns a CUDA error
// code.
extern "C" int w8a8_matmul_prepare() {
  cudaError_t e = configure<128, false>();
  if (e == cudaSuccess) e = configure<8, true>();
  if (e == cudaSuccess) e = configure<16, true>();
  if (e == cudaSuccess) e = configure<32, true>();
  if (e == cudaSuccess) e = configure<64, true>();
  return (int)e;
}
