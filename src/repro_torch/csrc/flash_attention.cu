// Flash attention for Hopper (sm_90a) on the tensor cores: the paper's
// streaming LSE softmax (Eq. 4) as the online-softmax recurrence, with both
// products in error-compensated TF32 ("3xTF32") so that the arithmetic keeps
// the reference's float32 contract.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention.py::flash_attention_kernel
// and computes what it computes: q (B, S, H, d), k/v (B, T, G, d) with KV
// head h / (H / G) -> out (B, S, H, d) in q's type, with q scaled before
// the product, an optional causal mask k_pos <= q_pos (both counted from 0),
// masked scores set to -1e30, corr = exp(m_prev - m_new), and the final
// acc / max(l, 1e-30).  Every operand comes with its own batch, row and head
// strides (last dimension contiguous), so the LM's grouped KV cache is read
// where it lies and the (BH, S, d) entry is the case B = BH, H = G = 1.
//
// What bounds it on the H100: on the InternLM2-1.8B prefill (B x H = 64,
// S = T = 1000, d = 128, causal, float32) attention is 16.4 GFLOP against
// 0.13 GB of operands.  Each product here is three TF32 products, so the
// bound is 3 x 16.4 GFLOP at the 495 TFLOP/s TF32 peak: 0.099 ms a launch.
//
// The split.  A float32 x is hi + lo with hi = x rounded to the nearest
// TF32 value and lo = x - hi (exact: Sterbenz) rounded the same way; the
// rounding is done explicitly on the bits (add half a TF32 ulp, clear the
// 13 low bits), so no operand relies on how the tensor core drops bits.  A
// product a b is then hi_a hi_b + hi_a lo_b + lo_a hi_b, each exact in the
// tensor core's float32 accumulator, which leaves out lo_a lo_b and lo's
// rounding: at most about 3 x 2^-22 of |a b| and unbiased, against 2^-11 for
// one plain TF32 product (plain TF32 misses the 2e-5 tolerance of the
// reference's tests).  Truncating instead of rounding (x & 0xffffe000)
// doubles the bound and biases every operand towards zero; on inputs whose
// low mantissa bits are all set it missed that tolerance.  A bf16 K or V is
// exact in TF32: its lo is 0 and its products take two passes.  The small
// passes are summed first.
//
// Design.  One block per (64 query rows, b, h): a consumer warpgroup that
// runs the products and the softmax, and a split warpgroup that feeds it.
// * The consumers load the Q tile once, scale it and split it: hi stays in
//   registers as the A fragment of two of S's three passes (64 registers a
//   thread at d = 128), lo goes to shared memory, K-major in the layout
//   TMA's swizzle gives (rows of 32 floats with 128-byte swizzle, 16 floats
//   with 64-byte swizzle at d = 16).
// * One thread of the split warpgroup loads each raw K/V tile of 32 keys
//   with 4-D TMA (the tensor map carries the strides, so the LM's cache is
//   read where it lies; its zero fill covers the ragged last tile), on an
//   mbarrier with a wait that traps instead of hanging.  The warpgroup
//   splits K into hi/lo tiles of the same layout, and V into hi/lo tiles
//   of V^T (d rows of 32 keys, 128-byte swizzle): TF32 wgmma takes B only
//   K-major, and for P V the reduction runs over the keys.  The keys of
//   each group of 8 are stored in the order in which the S accumulator
//   holds them (0 2 4 6 1 3 5 7), so that the accumulator registers of P
//   are the A fragment of the next product without a shuffle.  After these
//   generic stores, a proxy fence and a barrier, it hands the split tiles
//   to the consumers through a ring of STAGES stages with a full and an
//   empty mbarrier each, so that the split of tile i + 1 runs while the
//   consumers compute on tile i.  It loads the next raw tile as soon as
//   it holds this one, split, in registers, so the load runs under the
//   stores.
// * S = Q K^T: wgmma m64n32k8, 3 x d/8 of them (2 x d/8 for bf16 K): hi(Q)
//   lo(K) and hi(Q) hi(K) with A from registers, lo(Q) hi(K) with A from
//   shared memory.  With both operands in shared memory every one of them
//   would read its 2 KB A tile again, and the consumers, not the split
//   warpgroup, set the pace.  The mask is applied to the diagonal and the
//   ragged tile only; softmax runs in registers, with the row max over the
//   four threads of a row by shuffles.
// * O += P V: P is split in registers and is the A operand from registers
//   of wgmma m64n{d}k8 over V^T, 3 x 4 of them (2 x 4 for bf16 V).
// * Causal q-tiles go out heaviest first (reverse blockIdx.x), and KV tiles
//   wholly above the diagonal are never loaded.
// What still holds it back: one consumer warpgroup's chain per KV tile
// (wait for S, softmax, wait for P V) with four warps an SM to hide it; a
// bf16 K/V, with a third fewer products, runs no faster.  A second
// consumer warpgroup needs more registers than a 384-thread block has
// (setmaxnreg did not lift ptxas's 168), and wider key tiles more than
// 227 KB of shared memory.
// Built without --use_fast_math: expf and the division round as the plain
// version's do.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BQ = 64;               // query rows per block: one warpgroup
constexpr int BK = 32;               // keys per KV tile: one 128-byte row of V^T
constexpr int STAGES = 2;            // depth of the ring of split K/V tiles
constexpr int kThreads = 2 * 128;    // consumer warpgroup + split warpgroup
constexpr float kNegInf = -1e30f;

// Shared-memory geometry at head dim D.  Q is 64 rows, K and V tiles 32;
// Q and K are stored as D / CB column blocks of CB floats a row (one
// swizzle row each), V^T as D rows of 32 floats.
template <int D>
struct Geo {
  static constexpr int CB = D < 32 ? D : 32;
  static constexpr int SW = 4 * CB;             // swizzle width, bytes
  static constexpr int Q_BYTES = BQ * D * 4;
  static constexpr int KV_BYTES = BK * D * 4;
  // qlo, STAGES x (khi, klo, vhi, vlo), raw K, raw V, barriers (one for
  // the raw tile, a full and an empty one per stage): 193.0 KB at D = 128
  static constexpr int SMEM = Q_BYTES + 4 * STAGES * KV_BYTES + 2 * KV_BYTES +
                              (1 + 2 * STAGES) * 8 + 1024;
};

// The TMA swizzle of a byte offset in a 1024-byte aligned buffer: the
// 16-byte chunk index XOR the row index (128-byte rows) or the row index
// over 2 (64-byte rows).
template <int SW>
__device__ __forceinline__ uint32_t swz(uint32_t off) {
  return off ^ (((off >> 7) & (SW == 128 ? 7u : 3u)) << 4);
}

// Byte offset of float (r, c) in a K-major tile of `rows` rows at head dim D.
template <int D>
__device__ __forceinline__ uint32_t tile_off(int r, int c, int rows) {
  using G = Geo<D>;
  return swz<G::SW>((c / G::CB) * rows * G::SW + r * G::SW + (c % G::CB) * 4);
}

// wgmma descriptor of k-step kk (8 floats) of a K-major tile of `rows` rows.
template <int D>
__device__ __forceinline__ uint64_t kstep_desc(uint32_t base, int kk, int rows) {
  using G = Geo<D>;
  const uint32_t a = base + (kk * 8 / G::CB) * rows * G::SW + (kk * 8 % G::CB) * 4;
  return G::SW == 128 ? desc_sw128(a) : desc_sw64(a);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&x)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
  x[0] = __low2float(a); x[1] = __high2float(a);
  x[2] = __low2float(b); x[3] = __high2float(b);
}

__device__ __forceinline__ void store4(uint8_t* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// the 128 consumer threads only (the split warpgroup syncs on barrier 2)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

// S += A B^T on the tensor cores in TF32, m64n32k8: A (64 x 8) and B
// (32 x 8) K-major in shared memory.  scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_tf32_ss_n32(float (&d)[16], uint64_t da,
                                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&d)[D / 2], const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (D == 16) wgmma_tf32_rs_n16(d, a, db);
  else if constexpr (D == 32) wgmma_tf32_rs_n32(d, a, db);
  else if constexpr (D == 64) wgmma_tf32_rs_n64(d, a, db);
  else wgmma_tf32_rs_n128(d, a, db);
}

// S = Q K^T of one tile into sc, small passes first; one commit group.
// Q's hi part comes from registers (qa[kk]: the A fragment of k-step kk),
// its lo part from shared memory.
template <int D, bool KV_BF16>
__device__ __forceinline__ void issue_s(float (&sc)[16],
                                        const uint32_t (&qa)[D / 8][4],
                                        uint32_t qlo_a, uint32_t khi_a,
                                        uint32_t klo_a) {
#pragma unroll
  for (int j = 0; j < 16; ++j) sc[j] = 0.f;
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  if constexpr (!KV_BF16) {
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk)
      wgmma_tf32_rs_n32(sc, qa[kk], kstep_desc<D>(klo_a, kk, BK));
  }
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk)
    wgmma_tf32_ss_n32(sc, kstep_desc<D>(qlo_a, kk, BQ),
                      kstep_desc<D>(khi_a, kk, BK), 1);
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk)
    wgmma_tf32_rs_n32(sc, qa[kk], kstep_desc<D>(khi_a, kk, BK));
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// O += P V of one tile, P split in ph/pl; one commit group.  The A
// fragment of k-step j is rows (r0, r0 + 8) x k (t, t + 4) = keys
// (2 t, 2 t + 1) of group j, i.e. accumulator registers 4 j + {0, 2, 1, 3}.
template <int D, bool KV_BF16>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         const uint32_t (&ph)[16],
                                         const uint32_t (&pl)[16],
                                         uint32_t vhi_a, uint32_t vlo_a) {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t a[4] = {pl[4 * j], pl[4 * j + 2], pl[4 * j + 1], pl[4 * j + 3]};
    wgmma_pv<D>(o, a, desc_sw128(vhi_a + 32 * j));
  }
  if constexpr (!KV_BF16) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t a[4] = {ph[4 * j], ph[4 * j + 2], ph[4 * j + 1], ph[4 * j + 3]};
      wgmma_pv<D>(o, a, desc_sw128(vlo_a + 32 * j));
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t a[4] = {ph[4 * j], ph[4 * j + 2], ph[4 * j + 1], ph[4 * j + 3]};
    wgmma_pv<D>(o, a, desc_sw128(vhi_a + 32 * j));
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// The online-softmax step on one tile of scores, in place: mask (the
// diagonal and the ragged tile only), row max over the four threads of a
// row, p = exp(s - m_new) into sc, this thread's share of the row sum, and
// corr = exp(m_prev - m_new) for the caller to rescale O with.
// sc[4 j + 2 hh + e] is row r0 + 8 hh, key k0 + 8 j + 2 t + e.
__device__ __forceinline__ void online_softmax(float (&sc)[16], float (&m)[2],
                                               float (&l)[2], float (&corr)[2],
                                               int k0, int q0, int r0, int t,
                                               int T, int causal) {
  if (k0 + BK > T || (causal && k0 + BK - 1 > q0)) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + 8 * j + 2 * t + e;
          if (key >= T || (causal && key > q0 + r0 + 8 * hh))
            sc[4 * j + 2 * hh + e] = kNegInf;
        }
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * hh], sc[4 * j + 2 * hh + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[hh], mx);
    corr[hh] = expf(m[hh] - m_new);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float pr = expf(sc[4 * j + 2 * hh + e] - m_new);
        sc[4 * j + 2 * hh + e] = pr;
        sum += pr;
      }
    l[hh] = l[hh] * corr[hh] + sum;    // this thread's share of the row sum
    m[hh] = m_new;
  }
}

__device__ __forceinline__ void split_p(const float (&sc)[16], uint32_t (&ph)[16],
                                        uint32_t (&pl)[16]) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    float hi, lo;
    split(sc[j], hi, lo);
    ph[j] = __float_as_uint(hi);
    pl[j] = __float_as_uint(lo);
  }
}

struct Params {
  const void* q;
  void* out;
  long long qsB, qsS, qsH;     // q strides (elements): batch, row, head
  long long osB, osS, osH;     // out strides
  int S, T, H, G, causal;
  float scale;
};

// One thread: the TMA loads of the raw K and V tile at row k0, completing
// on `bar`.  float32 as D / CB swizzled column blocks, bf16 as one plain
// box of 32 rows of D.
template <int D, bool KV_BF16>
__device__ __forceinline__ void load_kv(uint8_t* kraw, uint8_t* vraw,
                                        const CUtensorMap* tk,
                                        const CUtensorMap* tv, int g, int k0,
                                        int b, uint64_t* bar) {
  using Gm = Geo<D>;
  mbar_expect_tx(bar, KV_BF16 ? Gm::KV_BYTES : 2 * Gm::KV_BYTES);
  if constexpr (KV_BF16) {
    tma_load_4d(kraw, tk, 0, g, k0, b, bar);
    tma_load_4d(vraw, tv, 0, g, k0, b, bar);
  } else {
    for (int cb = 0; cb < D / Gm::CB; ++cb) {
      tma_load_4d(kraw + cb * BK * Gm::SW, tk, cb * Gm::CB, g, k0, b, bar);
      tma_load_4d(vraw + cb * BK * Gm::SW, tv, cb * Gm::CB, g, k0, b, bar);
    }
  }
}

template <int D, typename TQ, bool KV_BF16>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_tf32_kernel(const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const Params p) {
  using Gm = Geo<D>;
  constexpr int C4 = D / 4;            // 16-byte chunks of a row
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qlo = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* ring = qlo + Gm::Q_BYTES;   // stage s: khi, klo, vhi, vlo
  uint8_t* kraw = ring + 4 * STAGES * Gm::KV_BYTES;
  uint8_t* vraw = kraw + Gm::KV_BYTES;
  uint64_t* raw_full = reinterpret_cast<uint64_t*>(vraw + Gm::KV_BYTES);
  uint64_t* full = raw_full + 1;       // per stage: split K and V written
  uint64_t* empty = full + STAGES;     // ... and read by both products

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // heaviest first
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int g = h / (p.H / p.G);
  // under `causal`, keys past this tile's last query row never count
  const int t_end = p.causal ? min(p.T, q0 + BQ) : p.T;
  const int ntiles = (t_end + BK - 1) / BK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(raw_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);         // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4) {                     // ---- split warpgroup ----
    const int ptid = threadIdx.x - 128, pw = warp - 4;
    // where key `lane` of a tile goes in V^T: the order in which the S
    // accumulator holds the keys of each group of 8 (0 2 4 6 1 3 5 7)
    const int kpos = (lane & ~7) | ((lane & 7) >> 1) | ((lane & 1) << 2);
    if (ptid == 0) load_kv<D, KV_BF16>(kraw, vraw, &tk, &tv, g, 0, b, raw_full);
    for (int it = 0; it < ntiles; ++it) {
      const int s = it % STAGES;
      uint8_t* khi = ring + 4 * s * Gm::KV_BYTES;
      uint8_t* klo = khi + Gm::KV_BYTES;
      uint8_t* vhi = klo + Gm::KV_BYTES;
      uint8_t* vlo = vhi + Gm::KV_BYTES;
      // raw tile -> split in registers: K chunk ptid + 128 j (the tile's
      // own layout), V chunk c = 4 (pw + 4 j) of key `lane`.  A bf16 K or
      // V is exact in TF32: its lo stays 0 and is never stored.
      float kh[D / 16][4], kl[D / 16][4], vh[D / 16][4], vl[D / 16][4];
      mbar_wait(raw_full, it & 1);
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        const int i = ptid + 128 * j, c = (pw + 4 * j) * 4;
        if constexpr (KV_BF16) {
          load4(reinterpret_cast<const __nv_bfloat16*>(kraw) + 4 * i, kh[j]);
          load4(reinterpret_cast<const __nv_bfloat16*>(vraw) + lane * D + c, vh[j]);
        } else {
          float kx[4], vx[4];
          load4(reinterpret_cast<const float*>(kraw + 16 * i), kx);
          load4(reinterpret_cast<const float*>(vraw + tile_off<D>(lane, c, BK)), vx);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            split(kx[e], kh[j][e], kl[j][e]);
            split(vx[e], vh[j][e], vl[j][e]);
          }
        }
      }
      // every thread has read its share (the split above consumed the
      // loads, and the proxy fence orders them before the TMA's writes):
      // the raw tile may take the next one while the stores run
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync 2, 128;\n" ::: "memory");
      if (ptid == 0 && it + 1 < ntiles)
        load_kv<D, KV_BF16>(kraw, vraw, &tk, &tv, g, (it + 1) * BK, b, raw_full);
      if (it >= STAGES) mbar_wait(&empty[s], (it / STAGES - 1) & 1);
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        const int i = ptid + 128 * j, c = (pw + 4 * j) * 4;
        if constexpr (KV_BF16) {
          store4(khi + tile_off<D>(i / C4, (i % C4) * 4, BK), kh[j]);
        } else {
          store4(khi + 16 * i, kh[j]);
          store4(klo + 16 * i, kl[j]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t off = swz<128>((c + e) * 128 + kpos * 4);
          *reinterpret_cast<float*>(vhi + off) = vh[j][e];
          if constexpr (!KV_BF16) *reinterpret_cast<float*>(vlo + off) = vl[j][e];
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      // the split tiles are written, by all: hand them over
      asm volatile("bar.sync 2, 128;\n" ::: "memory");
      if (ptid == 0) mbar_arrive(&full[s]);
    }
    return;
  }

  // ---- consumer warpgroup ----
  const int tid = threadIdx.x;
  const int t = lane & 3;
  const int r0 = warp * 16 + (lane >> 2);   // rows r0 and r0 + 8 of the tile

  // Q, scaled and split: lo to shared memory (K-major, swizzled), hi to
  // registers in the A fragment of each k-step kk: rows (r0, r0 + 8) x
  // columns (8 kk + t, 8 kk + t + 4)
  const TQ* qb = static_cast<const TQ*>(p.q) + b * p.qsB + h * p.qsH;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int i = tid + 128 * j;       // 16-byte chunk of the Q tile
    const int r = i / C4, c = (i % C4) * 4;
    float x[4] = {0.f, 0.f, 0.f, 0.f}, hi[4], lo[4];
    if (q0 + r < p.S) load4(qb + (long long)(q0 + r) * p.qsS + c, x);
#pragma unroll
    for (int e = 0; e < 4; ++e) split(__fmul_rn(x[e], p.scale), hi[e], lo[e]);
    store4(qlo + tile_off<D>(r, c, BQ), lo);
  }
  uint32_t qa[D / 8][4];
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk)
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int r = q0 + r0 + 8 * (f & 1), c = 8 * kk + t + 4 * (f >> 1);
      const float x = r < p.S ? to_f32(qb[(long long)r * p.qsS + c]) : 0.f;
      qa[kk][f] = __float_as_uint(tf32_round(__fmul_rn(x, p.scale)));
    }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  consumer_sync();                     // the Q tile is visible to wgmma

  const uint32_t qlo_a = smem_u32(qlo), ring_a = smem_u32(ring);
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, corr[2];
  float o[D / 2], sc[16];
  uint32_t ph[16], pl[16];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) o[j] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int s = it % STAGES;
    const uint32_t khi_a = ring_a + 4 * s * Gm::KV_BYTES;
    const uint32_t klo_a = khi_a + Gm::KV_BYTES;
    const uint32_t vhi_a = klo_a + Gm::KV_BYTES;
    const uint32_t vlo_a = vhi_a + Gm::KV_BYTES;
    mbar_wait(&full[s], (it / STAGES) & 1);
    issue_s<D, KV_BF16>(sc, qa, qlo_a, khi_a, klo_a);
    wgmma_wait_all();
#pragma unroll
    for (int j = 0; j < 16; ++j) fence_operand(sc[j]);
    online_softmax(sc, m, l, corr, it * BK, q0, r0, t, p.T, p.causal);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        o[4 * j + 2 * hh] *= corr[hh];
        o[4 * j + 2 * hh + 1] *= corr[hh];
      }
    split_p(sc, ph, pl);
    issue_pv<D, KV_BF16>(o, ph, pl, vhi_a, vlo_a);
    wgmma_wait_all();
#pragma unroll
    for (int j = 0; j < D / 2; ++j) fence_operand(o[j]);
    if (lane == 0) mbar_arrive(&empty[s]);   // this warp is done with stage s
  }

  TQ* ob = static_cast<TQ*>(p.out) + b * p.osB + h * p.osH;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float lt = l[hh] + __shfl_xor_sync(0xffffffffu, l[hh], 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const float denom = fmaxf(lt, 1e-30f);
    const int row = q0 + r0 + 8 * hh;
    if (row >= p.S) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      store2(ob + (long long)row * p.osS + 8 * j + 2 * t,
             o[4 * j + 2 * hh] / denom, o[4 * j + 2 * hh + 1] / denom);
  }
}

// 4-D tensor map of K or V as (d, G, T, B), innermost first, with a box of
// one head and 32 rows: float32 as column blocks of CB floats with the
// swizzle the wgmma descriptors expect, bf16 as one plain box of d.
bool encode_kv(CUtensorMap* map, const void* ptr, bool bf16, int D, int B,
               int T, int G, long long sB, long long sT, long long sG) {
  EncodeTiled fn = encode_fn();
  if (!fn) return false;
  const long long esz = bf16 ? 2 : 4;
  cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)G, (cuuint64_t)T, (cuuint64_t)B};
  cuuint64_t strides[3] = {(cuuint64_t)(sG * esz), (cuuint64_t)(sT * esz),
                           (cuuint64_t)(sB * esz)};
  cuuint32_t box[4] = {(cuuint32_t)(bf16 ? D : (D < 32 ? D : 32)), 1, BK, 1};
  cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle sw = bf16 ? CU_TENSOR_MAP_SWIZZLE_NONE
                                : D >= 32 ? CU_TENSOR_MAP_SWIZZLE_128B
                                          : CU_TENSOR_MAP_SWIZZLE_64B;
  return fn(map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
            4, const_cast<void*>(ptr), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, sw, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Args {
  const void *q, *k, *v;
  void* out;
  int B, H, G, S, T;
  const long long* st;   // q (B, S, H), k (B, T, G), v (B, T, G), out (B, S, H)
  float scale;
  int causal;
};

template <int D, typename TQ, bool KV_BF16>
int launch(const Args& a, cudaStream_t stream) {
  auto kern = flash_attention_tf32_kernel<D, TQ, KV_BF16>;
  static bool configured[kMaxDevices] = {};
  const int dev = device_slot();
  if (dev < 0) return (int)cudaErrorInvalidDevice;
  if (!configured[dev]) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Geo<D>::SMEM);
    if (e != cudaSuccess) return (int)e;
    configured[dev] = true;
  }
  const long long* st = a.st;
  CUtensorMap tk, tv;
  if (!encode_kv(&tk, a.k, KV_BF16, D, a.B, a.T, a.G, st[3], st[4], st[5]) ||
      !encode_kv(&tv, a.v, KV_BF16, D, a.B, a.T, a.G, st[6], st[7], st[8]))
    return (int)cudaErrorInvalidValue;
  const Params p{a.q, a.out, st[0], st[1], st[2], st[9], st[10], st[11],
                 a.S, a.T, a.H, a.G, a.causal, a.scale};
  dim3 grid((a.S + BQ - 1) / BQ, a.B * a.H);
  kern<<<grid, kThreads, Geo<D>::SMEM, stream>>>(tk, tv, p);
  return (int)cudaGetLastError();
}

template <int D>
int dispatch_types(const Args& a, int q_bf16, int kv_bf16, cudaStream_t stream) {
  if (!q_bf16 && !kv_bf16) return launch<D, float, false>(a, stream);
  if (q_bf16 && kv_bf16) return launch<D, __nv_bfloat16, true>(a, stream);
  if (!q_bf16 && kv_bf16) return launch<D, float, true>(a, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q (B, S, H, D), k and v (B, T, G, D), out (B, S, H, D) in q's type, each
// with the last dimension contiguous and the element strides of its other
// three dimensions in `strides` (12 values: q batch, row, head; k batch,
// row, head; v likewise; out likewise), multiples of 8, pointers 16-byte
// aligned.  KV head of query head h is h / (H / G).  q is float32
// (q_bf16 = 0) or bfloat16 (1), k and v likewise (kv_bf16); a bfloat16 q
// with float32 k/v is refused.  D is 16, 32, 64 or 128.  Launches on
// `stream`; returns cudaGetLastError() (or the error of raising the
// shared-memory limit, or cudaErrorInvalidValue for a shape, type or
// layout it does not take).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* out, int B, int H, int G, int S, int T,
                                   int D, const long long* strides, int q_bf16,
                                   int kv_bf16, float scale, int causal,
                                   cudaStream_t stream) {
  if (B <= 0 || H <= 0 || G <= 0 || H % G || S <= 0 || T <= 0 ||
      (long long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, out, B, H, G, S, T, strides, scale, causal};
  switch (D) {
    case 16: return dispatch_types<16>(a, q_bf16, kv_bf16, stream);
    case 32: return dispatch_types<32>(a, q_bf16, kv_bf16, stream);
    case 64: return dispatch_types<64>(a, q_bf16, kv_bf16, stream);
    case 128: return dispatch_types<128>(a, q_bf16, kv_bf16, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory of one block at head dim D (bytes), or -1.
extern "C" int flash_attention_smem(int D) {
  switch (D) {
    case 16: return Geo<16>::SMEM;
    case 32: return Geo<32>::SMEM;
    case 64: return Geo<64>::SMEM;
    case 128: return Geo<128>::SMEM;
    default: return -1;
  }
}
