// Flash attention for Hopper (sm_90a): the paper's streaming LSE softmax
// (Eq. 4) as the online-softmax recurrence, float32 throughout.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention.py::flash_attention_kernel
// and computes what it computes: q (BH, S, d), k/v (BH, T, d) -> out
// (BH, S, d) in q's type, with q scaled before the product, an optional
// causal mask k_pos <= q_pos (both counted from 0), masked scores set to
// -1e30, corr = exp(m_prev - m_new), and the final acc / max(l, 1e-30).
//
// What bounds it on the H100: on the InternLM2-1.8B prefill path (BH = 64,
// S = T = 1000, d = 128, causal, float32) the product work is
// 4 * BH * d * S(S+1)/2 = 16.4 GFLOP against 0.13 GB of operands, so the
// bound is the operations: 0.245 ms at the card's 67 TFLOP/s of float32
// outside the tensor cores.  This first version stays on the CUDA cores,
// where its shared-memory reads (one per two FMAs in the score loop) hold
// it below that rate; tensor-core tiles (TF32 or bf16 wgmma) are a later
// change's work and would change the arithmetic the reference fixes.
//
// Design.  One block of 256 threads per (bh, tile of 64 query rows); a loop
// inside the block walks the KV tiles of 64 keys, which takes the place of
// the TPU grid's sequential KV axis.  The scaled Q tile and each K and V
// tile are staged in shared memory as float32 (bf16 inputs convert on
// load), rows padded to d + 1 floats so that the 16 rows a half-warp reads
// at once sit in distinct banks.  Thread (ty, tx) = (tid / 16, tid % 16)
// owns query rows ty + 16 i (i < 4), score columns tx + 16 j (j < 4) and
// output columns tx + 16 j (j < d / 16): the 16 threads of a row are one
// half-warp, so the row max and row sum reduce with four shuffles and each
// thread keeps m, l and its accumulators in registers.  Only the
// probabilities go through shared memory, for the P V product.  Under
// `causal` the KV tiles wholly above the diagonal are skipped (they would
// add exp(-1e30 - m) = 0).  Ragged S and T are masked here, not padded by
// the caller: key columns past T score -1e30, query rows past S load as 0
// and are not stored.  Shared memory is 115,712 bytes at d = 128, above
// the 48 KB default, so each launch first raises the kernel's dynamic
// shared-memory limit.  Built without --use_fast_math: expf and the
// division round as the plain version's do.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per KV tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kLP = kBK + 1;   // padded row of the probability tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((kBQ + 2 * kBK) * (D + 1) + kBQ * kLP);
}

template <int D, typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                       const TKV* __restrict__ v, TQ* __restrict__ out, int S,
                       int T, float scale, int causal) {
  constexpr int LD = D + 1;    // padded row of the Q, K and V tiles
  constexpr int NC = D / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;               // [kBQ][LD], already scaled
  float* k_s = q_s + kBQ * LD;     // [kBK][LD]
  float* v_s = k_s + kBK * LD;     // [kBK][LD]
  float* p_s = v_s + kBK * LD;     // [kBQ][kLP]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * kBQ;
  const long long bh = blockIdx.y;
  const TQ* qb = q + bh * S * D;
  const TKV* kb = k + bh * T * D;
  const TKV* vb = v + bh * T * D;
  TQ* ob = out + bh * S * D;

  for (int e = threadIdx.x; e < kBQ * D; e += kThreads) {
    const int r = e / D, c = e % D;
    q_s[r * LD + c] =
        q0 + r < S ? __fmul_rn(to_f32(qb[(long long)(q0 + r) * D + c]), scale) : 0.f;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;
  }

  // under `causal`, keys past this tile's last query row never count
  const int t_end = causal ? min(T, q0 + kBQ) : T;
  for (int k0 = 0; k0 < t_end; k0 += kBK) {
    __syncthreads();   // the previous tile's K, V and P are no longer read
    for (int e = threadIdx.x; e < kBK * D; e += kThreads) {
      const int r = e / D, c = e % D;
      const bool in = k0 + r < T;
      const long long g = (long long)(k0 + r) * D + c;
      k_s[r * LD + c] = in ? to_f32(kb[g]) : 0.f;
      v_s[r * LD + c] = in ? to_f32(vb[g]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = q_s[(ty + 16 * i) * LD + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = k_s[(tx + 16 * j) * LD + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q_pos = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k_pos = k0 + tx + 16 * j;
        if (k_pos >= T || (causal && k_pos > q_pos)) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        p_s[(ty + 16 * i) * kLP + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = p_s[(ty + 16 * i) * kLP + kk];
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const float vv = v_s[kk * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NC; ++j)
      store(&ob[(long long)r * D + tx + 16 * j], acc[i][j] / denom);
  }
}

template <int D, typename TQ, typename TKV>
int launch(const void* q, const void* k, const void* v, void* out, int BH,
           int S, int T, float scale, int causal, cudaStream_t stream) {
  auto kern = flash_attention_kernel<D, TQ, TKV>;
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + kBQ - 1) / kBQ, BH);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), static_cast<TQ*>(out), S, T, scale, causal);
  return (int)cudaGetLastError();
}

template <int D>
int dispatch_types(const void* q, const void* k, const void* v, void* out,
                   int BH, int S, int T, int q_bf16, int kv_bf16, float scale,
                   int causal, cudaStream_t stream) {
  if (!q_bf16 && !kv_bf16)
    return launch<D, float, float>(q, k, v, out, BH, S, T, scale, causal, stream);
  if (q_bf16 && kv_bf16)
    return launch<D, __nv_bfloat16, __nv_bfloat16>(q, k, v, out, BH, S, T, scale,
                                                   causal, stream);
  if (!q_bf16 && kv_bf16)
    return launch<D, float, __nv_bfloat16>(q, k, v, out, BH, S, T, scale, causal,
                                           stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q (BH, S, D), k and v (BH, T, D), out (BH, S, D) in q's type; all
// contiguous.  q is float32 (q_bf16 = 0) or bfloat16 (1), k and v likewise
// (kv_bf16); a bfloat16 q with float32 k/v is refused.  D is 16, 32, 64 or
// 128.  Launches on `stream`; returns cudaGetLastError() (or the error of
// raising the shared-memory limit, or cudaErrorInvalidValue for a shape or
// type it does not take).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* out, int BH, int S, int T, int D,
                                   int q_bf16, int kv_bf16, float scale,
                                   int causal, cudaStream_t stream) {
  if (BH <= 0 || BH > 65535 || S <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 16:
      return dispatch_types<16>(q, k, v, out, BH, S, T, q_bf16, kv_bf16, scale, causal, stream);
    case 32:
      return dispatch_types<32>(q, k, v, out, BH, S, T, q_bf16, kv_bf16, scale, causal, stream);
    case 64:
      return dispatch_types<64>(q, k, v, out, BH, S, T, q_bf16, kv_bf16, scale, causal, stream);
    case 128:
      return dispatch_types<128>(q, k, v, out, BH, S, T, q_bf16, kv_bf16, scale, causal, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
