// W8A8 GEMM for Hopper (sm_90a): int8 (M, K) x int8 (K, N) accumulated in
// int32, then the float32 epilogue  out[m][n] = (float)acc * xs[m] * ws[n].
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/w8a8_matmul.py::w8a8_matmul_kernel
// (DiffLight C1: MR-bank MACs; the int32 accumulator stands for the balanced
// photodetector, the two scales for the MR transmission calibration).
//
// What bounds it on the H100: on the Stable Diffusion v1.4 path the products
// run from (B*1024 x 680 x 680) down to (B*77 x 768 x 680).  Against the
// card's int8 tensor-core rate (1979 TOP/s) every one of them is bound by
// bytes, chiefly the float32 output (4*M*N bytes over 3.35 TB/s).  In
// practice this kernel is bound by its own issue rate: it does not use the
// tensor cores (__dp4a on the CUDA cores) and reaches a small share of that
// bound.  It is the simple, exact first version; wgmma with TMA-fed
// shared-memory rings, and a fused epilogue for the consumer, are a later
// change's work.
//
// Design.  64 x 64 output tile per block of 256 threads, K in steps of 32.
// Each step stages the A tile (64 rows x 32 k) and the B tile transposed
// (64 columns x 32 k) in shared memory as bytes, so four consecutive k of a
// row or column form one 32-bit word; each thread then holds a 4 x 4 block
// of int32 accumulators in registers and issues __dp4a on packed words.
// Rows and columns owned by a thread are strided by 16 (m = ty + 16 i,
// n = tx + 16 j) and shared rows are padded to 9 words, so the shared reads
// of a warp hit distinct banks and the epilogue's stores are coalesced.
// Ragged M, N and K are masked in the kernel (zero fill), which replaces
// the reference's padding to multiples of 128.  The epilogue multiplies in
// the reference's order, with no fused add, so it rounds as the plain
// version does; the file must not be built with --use_fast_math.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;       // output tile edge
constexpr int kStep = 32;       // k per shared-memory stage
constexpr int kWords = kStep / 4 + 1;  // 32-bit words per padded shared row
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
w8a8_matmul_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
                   const int8_t* __restrict__ wq, const float* __restrict__ ws,
                   float* __restrict__ out, int M, int N, int K) {
  __shared__ int a_s[kTile][kWords];   // a_s[m][k/4]: A tile, rows along k
  __shared__ int b_s[kTile][kWords];   // b_s[n][k/4]: B tile, transposed
  int8_t* a_b = reinterpret_cast<int8_t*>(a_s);
  int8_t* b_b = reinterpret_cast<int8_t*>(b_s);
  constexpr int kRowBytes = kWords * 4;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  int acc[4][4] = {};

  for (int k0 = 0; k0 < K; k0 += kStep) {
    // A: 64 x 32 bytes, consecutive threads on consecutive k (coalesced)
    for (int e = threadIdx.x; e < kTile * kStep; e += kThreads) {
      const int r = e / kStep, k = e % kStep;
      const int gm = m0 + r, gk = k0 + k;
      a_b[r * kRowBytes + k] = (gm < M && gk < K) ? xq[(long long)gm * K + gk] : 0;
    }
    // B: 32 x 64 bytes, consecutive threads on consecutive n (coalesced),
    // stored transposed so that k is the fast axis in shared memory
    for (int e = threadIdx.x; e < kTile * kStep; e += kThreads) {
      const int k = e / kTile, c = e % kTile;
      const int gk = k0 + k, gn = n0 + c;
      b_b[c * kRowBytes + k] = (gk < K && gn < N) ? wq[(long long)gk * N + gn] : 0;
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kStep / 4; ++w) {
      int a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = a_s[ty + 16 * i][w];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = b_s[tx + 16 * j][w];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
    const float sx = xs[m];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) out[(long long)m * N + n] = __fmul_rn(__fmul_rn((float)acc[i][j], sx), ws[n]);
    }
  }
}

}  // namespace

// xq (M, K) int8, xs (M,) float32, wq (K, N) int8, ws (N,) float32 -> out
// (M, N) float32; all contiguous.  Launches on `stream`; returns
// cudaGetLastError().
extern "C" int w8a8_matmul_s8(const int8_t* xq, const float* xs, const int8_t* wq,
                              const float* ws, float* out, int M, int N, int K,
                              cudaStream_t stream) {
  dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile);
  w8a8_matmul_kernel<<<grid, kThreads, 0, stream>>>(xq, xs, wq, ws, out, M, N, K);
  return (int)cudaGetLastError();
}
