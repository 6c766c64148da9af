// Convolution on NHWC for Hopper (sm_90a): an implicit GEMM on the TF32
// tensor cores, each product error-compensated ("3xTF32") so that the
// arithmetic keeps float32's contract, with the bias, a per-(image,
// channel) row and a residual added in the epilogue.
//
// It replaces no TPU kernel: the JAX package leaves convolution to XLA
// (`jax.lax.conv_general_dilated` in src/repro/core/sparse_dataflow.py and
// src/repro/models/layers.py), and the port handed it to cuDNN, whose
// float32 kernels run on the CUDA cores (its TF32 kernels round each
// operand to 10 mantissa bits, which the float32 contract does not allow).
//
// What it computes: out[n, oy, ox, co] = sum over taps (ky, kx) of the
// (kh, kw) grid and input channels ci of
//   x[n, s oy + dy0 + ky, s ox + dx0 + kx, ci] * w[co, ky, kx, ci]
// with x read as zero outside the image (so dy0 = -pad_lo gives XLA's SAME
// padding, asymmetric or negative), s the stride (1 or 2); then
//   v = acc + bias[co];  v = v + row[n, co];  v = res[n, oy, ox, co] + v
// (each term optional, in this order, as the unfused code adds them), and
// v is stored through the output's own strides (n, oy, ox; channels
// contiguous), so a phase of the sparse transposed convolution writes
// straight into out[:, py::2, px::2, :].
//
// What bounds it on the H100: at Stable Diffusion v1.4's shapes (48 rows
// of 64x64 .. 8x8 latents, 340 .. 2720 channels) every convolution is bound
// by operations: one UNet evaluation is 20.6 TFLOP of float32 products,
// and each is three TF32 products here, so the bound is the TF32 peak over
// three, 165 TFLOP/s (125 ms for that evaluation).  The operands are read
// from L2 about 9 times (once per tap), so what else can hold it back is
// L2's bandwidth into the SMs and the split of the activations, which runs
// on the CUDA cores.
//
// Design.  M = output pixels, N = output channels, K = taps x input
// channels, ordered (ky, kx, ci), so that a K chunk of 32 channels of one
// tap is one 128-byte row of an NHWC pixel.
// * A block computes a BM x BN tile (BM 128 or 64 output pixels, BN 128,
//   64 or 16 channels), with BM / 64 consumer warpgroups and one producer
//   warp that keeps a ring of STAGES stages full with TMA loads, on a full
//   and an empty mbarrier per stage (a wait that traps instead of hanging).
// * The BM pixels are a box of the output (bw x bh pixels of bn images),
//   so a stage's activations are one 4-D TMA box of the NHWC input
//   (32 channels, bw, bh, bn) at the tap's offset: TMA's zero fill of
//   coordinates outside the tensor is the padding, at any offset, and the
//   ragged channel tail.  Stride 2 reads one of four parity views of x
//   (every second pixel from (py, px), a tensor map with doubled strides),
//   so a stage is still one box.  No padded or transposed copy is made.
// * The weight is laid out once, by the wrapper, as (Cout, kh, kw, Cin) and
//   split into TF32 hi and lo tensors; a stage loads both (32 channels of
//   one tap for BN output channels, 128-byte swizzle), the K-major B
//   operand TF32 wgmma needs.
// * Each consumer thread reads its A fragment of the stage from shared
//   memory, splits it into hi and lo in registers, and issues per 8 channels
//   lo(A) hi(B), hi(A) lo(B) and hi(A) hi(B) as wgmma m64nBNk8 with A from
//   registers (the small products first) into a partial sum of the stage,
//   which it adds to its float32 sum over the stages with round to nearest:
//   the tensor cores' own float32 sum truncates, and over the 1,530 k-steps
//   of a 3x3 conv of 1360 channels that bias grew the error ~20-fold over
//   float32's.  The two consumer warpgroups alternate, so one splits while
//   the other's products run.
// * The grid runs the pixel tiles fastest, so the blocks in flight share
//   one weight tile in L2.
// What still holds it back: the wait for each stage's products before the
// next split (one warpgroup's products and split do not overlap), the
// output channels past the last full tile (340 = 2 x 128 + 84), and L2
// traffic: a stage reads 16 KB of activations and 32 KB of weights.
// Built without --use_fast_math: the epilogue adds round as the plain
// version's do.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BK = 32;                 // channels per stage: one 128-byte row
constexpr int kSmemLimit = 232448;     // dynamic shared memory a block may use

template <int BM, int BN>
struct Geo {
  static constexpr int kConsumers = BM / 64;
  static constexpr int kThreads = 128 * kConsumers + 32;
  static constexpr int A_BYTES = BM * BK * 4;
  static constexpr int B_BYTES = BN * BK * 4;
  static constexpr int STAGE = A_BYTES + 2 * B_BYTES;
  static constexpr int STAGES_FIT = (kSmemLimit - 1024 - 256) / STAGE;
  static constexpr int STAGES = STAGES_FIT < 8 ? STAGES_FIT : 8;
  static constexpr int SMEM = STAGES * STAGE + 2 * STAGES * 8 + 1024;
};

// The parity views of x: one for stride 1, four for stride 2 (index
// 2 py + px).
struct AMaps {
  CUtensorMap m[4];
};

struct Params {
  int N, Ho, Wo, Cout;
  int kw, dy0, dx0, stride;
  int nc, nk;                          // channel chunks per tap; K stages
  int bw, bh, bn;                      // the output box of a pixel tile
  int tiles_x, tiles_y;
  int a_bytes;                         // bytes of one activation box
  int vec2;                            // pairs of channels stored at once
  const float* bias;                   // (Cout,) or null
  const float* row;                    // (N, Cout) or null
  const float* res;                    // (N, Ho, Wo, Cout) or null
  float* out;
  long long osN, osH, osW;             // output strides, elements
};

template <int BN>
__device__ __forceinline__ void wgmma_rs(float (&d)[BN / 2], const uint32_t (&a)[4],
                                         uint64_t db, int scale_d = 1) {
  if constexpr (BN == 16) wgmma_tf32_rs_n16(d, a, db, scale_d);
  else if constexpr (BN == 64) wgmma_tf32_rs_n64(d, a, db, scale_d);
  else wgmma_tf32_rs_n128(d, a, db, scale_d);
}

// byte offset of float (r, c) in a tile of 32-float rows, 128-byte swizzle
__device__ __forceinline__ uint32_t swz128(int r, int c) {
  const uint32_t off = r * 128 + c * 4;
  return off ^ (((off >> 7) & 7u) << 4);
}

// This thread's A fragments of a stage: k-step kk's rows (ra, ra + 8) x
// channels (8 kk + t, 8 kk + t + 4), split into TF32 hi and lo.
__device__ __forceinline__ void load_split(const uint8_t* st, int ra, int t,
                                           uint32_t (&ah)[4][4],
                                           uint32_t (&al)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const float x = *reinterpret_cast<const float*>(
          st + swz128(ra + 8 * (f & 1), 8 * kk + t + 4 * (f >> 1)));
      float hi, lo;
      split(x, hi, lo);
      ah[kk][f] = __float_as_uint(hi);
      al[kk][f] = __float_as_uint(lo);
    }
}

// A stage's products into part (overwritten), the small ones first:
// lo(A) hi(B), hi(A) lo(B), hi(A) hi(B); one commit group.
template <int BN>
__device__ __forceinline__ void issue(float (&part)[BN / 2],
                                      const uint32_t (&ah)[4][4],
                                      const uint32_t (&al)[4][4], uint32_t bh,
                                      uint32_t bl) {
#pragma unroll
  for (int j = 0; j < BN / 2; ++j) fence_operand(part[j]);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs<BN>(part, al[kk], desc_sw128(bh + 32 * kk), kk > 0);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs<BN>(part, ah[kk], desc_sw128(bl + 32 * kk));
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs<BN>(part, ah[kk], desc_sw128(bh + 32 * kk));
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int BM, int BN>
__global__ void __launch_bounds__(Geo<BM, BN>::kThreads, 1)
conv2d_tf32x3_kernel(const __grid_constant__ AMaps am,
                     const __grid_constant__ CUtensorMap tbh,
                     const __grid_constant__ CUtensorMap tbl,
                     const Params p) {
  using G = Geo<BM, BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + G::STAGES * G::STAGE);
  uint64_t* empty = full + G::STAGES;

  // the tile: output box (ox0, oy0, n0) and output channels from c0
  const int mt = blockIdx.x;
  const int c0 = blockIdx.y * BN;
  const int tx = mt % p.tiles_x, ty = (mt / p.tiles_x) % p.tiles_y;
  const int ox0 = tx * p.bw, oy0 = ty * p.bh;
  const int n0 = (mt / (p.tiles_x * p.tiles_y)) * p.bn;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < G::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], G::kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * G::kConsumers) {     // ---- producer warp ----
    if (lane == 0) {
      for (int i = 0; i < p.nk; ++i) {
        const int s = i % G::STAGES;
        if (i >= G::STAGES) mbar_wait(&empty[s], (i / G::STAGES - 1) & 1);
        const int tap = i / p.nc, cc = i - tap * p.nc;
        const int ky = tap / p.kw, kx = tap - ky * p.kw;
        const int dy = p.dy0 + ky, dx = p.dx0 + kx;
        // input row s oy + dy: parity view dy mod s, row oy + floor(dy / s)
        int view = 0, iy = oy0 + dy, ix = ox0 + dx;
        if (p.stride == 2) {
          view = 2 * (dy & 1) + (dx & 1);
          iy = oy0 + (dy >> 1);
          ix = ox0 + (dx >> 1);
        }
        uint8_t* st = smem + s * G::STAGE;
        mbar_expect_tx(&full[s], p.a_bytes + 2 * G::B_BYTES);
        tma_load_4d(st, &am.m[view], cc * BK, ix, iy, n0, &full[s]);
        tma_load_3d(st + G::A_BYTES, &tbh, cc * BK, tap, c0, &full[s]);
        tma_load_3d(st + G::A_BYTES + G::B_BYTES, &tbl, cc * BK, tap, c0,
                    &full[s]);
      }
    }
    return;
  }

  // ---- consumer warpgroups: 64 rows each ----
  const int wg = warp >> 2;
  const int t = lane & 3;
  const int ra = wg * 64 + (warp & 3) * 16 + (lane >> 2);  // rows ra, ra + 8
  // part: one stage's products, summed by the tensor cores; acc: the sum
  // over stages, taken here
  float acc[BN / 2], part[BN / 2];
#pragma unroll
  for (int j = 0; j < BN / 2; ++j) acc[j] = part[j] = 0.f;

  for (int i = 0; i < p.nk; ++i) {
    const int s = i % G::STAGES;
    uint32_t ah[4][4], al[4][4];
    mbar_wait(&full[s], (i / G::STAGES) & 1);
    load_split(smem + s * G::STAGE, ra, t, ah, al);
    const uint32_t bh = smem_u32(smem + s * G::STAGE + G::A_BYTES);
    issue<BN>(part, ah, al, bh, bh + G::B_BYTES);
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) fence_operand(part[j]);
    // every warp of this warpgroup has read its A rows (its products could
    // not start before) and the products have read B: the stage may be
    // reloaded
    if ((threadIdx.x & 127) == 0) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(&empty[s]);
    }
    // the tensor cores drop the bits an addition shifts out (round toward
    // zero), which over a chain of thousands of k-steps biases the sum;
    // one stage's 12 products are summed there, the stages here, rounded
    // to nearest
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) acc[j] = __fadd_rn(acc[j], part[j]);
  }

  // epilogue: accumulator register 4 j + 2 h + e holds row ra + 8 h,
  // channel c0 + 8 j + 2 t + e
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = ra + 8 * h;
    const int xb = r % p.bw, yb = (r / p.bw) % p.bh, nb = r / (p.bw * p.bh);
    const int ox = ox0 + xb, oy = oy0 + yb, n = n0 + nb;
    if (nb >= p.bn || ox >= p.Wo || oy >= p.Ho || n >= p.N) continue;
    float* o = p.out + n * p.osN + oy * p.osH + ox * p.osW;
    const float* rrow = p.row ? p.row + (long long)n * p.Cout : nullptr;
    const float* rres = p.res ? p.res + (((long long)n * p.Ho + oy) * p.Wo + ox) * p.Cout
                              : nullptr;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = c0 + 8 * j + 2 * t;
      float v[2] = {acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (c + e >= p.Cout) continue;
        if (p.bias) v[e] = __fadd_rn(v[e], p.bias[c + e]);
        if (rrow) v[e] = __fadd_rn(v[e], rrow[c + e]);
        if (rres) v[e] = __fadd_rn(rres[c + e], v[e]);
      }
      if (p.vec2 && c + 1 < p.Cout) {
        *reinterpret_cast<float2*>(o + c) = make_float2(v[0], v[1]);
      } else {
        if (c < p.Cout) o[c] = v[0];
        if (c + 1 < p.Cout) o[c + 1] = v[1];
      }
    }
  }
}

// Tensor map of one parity view of x (N, H, W, C), C % 4 == 0: pixels
// (vy + s y, vx + s x), as (C, Wv, Hv, N) innermost first, boxes of
// (32, bw, bh, bn), 128-byte swizzle, zero fill outside.
bool encode_x(CUtensorMap* map, const float* x, int N, int H, int W, int C,
              int s, int vy, int vx, int bw, int bh, int bn) {
  EncodeTiled fn = encode_fn();
  if (!fn) return false;
  const int Hv = (H - vy + s - 1) / s, Wv = (W - vx + s - 1) / s;
  if (Hv <= 0 || Wv <= 0) return false;
  cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)Wv, (cuuint64_t)Hv,
                        (cuuint64_t)N};
  cuuint64_t strides[3] = {(cuuint64_t)s * C * 4, (cuuint64_t)s * W * C * 4,
                           (cuuint64_t)H * W * C * 4};
  cuuint32_t box[4] = {(cuuint32_t)BK, (cuuint32_t)bw, (cuuint32_t)bh,
                       (cuuint32_t)bn};
  cuuint32_t estr[4] = {1, 1, 1, 1};
  const float* base = x + ((long long)vy * W + vx) * C;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<float*>(base),
            dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Tensor map of a (Cout, taps, C) weight half, boxes of (32, 1, bn).
bool encode_w(CUtensorMap* map, const float* w, int Cout, int taps, int C,
              int bn) {
  EncodeTiled fn = encode_fn();
  if (!fn) return false;
  cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)taps, (cuuint64_t)Cout};
  cuuint64_t strides[2] = {(cuuint64_t)C * 4, (cuuint64_t)taps * C * 4};
  cuuint32_t box[3] = {(cuuint32_t)BK, 1, (cuuint32_t)bn};
  cuuint32_t estr[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(w),
            dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BM, int BN>
cudaError_t configure() {
  static bool configured[kMaxDevices] = {};
  const int dev = device_slot();
  if (dev < 0) return cudaErrorInvalidDevice;
  if (configured[dev]) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(conv2d_tf32x3_kernel<BM, BN>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       Geo<BM, BN>::SMEM);
  if (e == cudaSuccess) configured[dev] = true;
  return e;
}

struct Args {
  const float *x, *whi, *wlo;
  int N, H, W, C, kh, kw, s;
  int bw, bh, bn, tiles_m, tiles_x, tiles_y;
  Params p;
};

template <int BM, int BN>
int launch(Args& a, cudaStream_t stream) {
  cudaError_t e = configure<BM, BN>();
  if (e != cudaSuccess) return (int)e;
  AMaps am;
  for (int v = 0; v < a.s * a.s; ++v)
    if (!encode_x(&am.m[v], a.x, a.N, a.H, a.W, a.C, a.s, v / a.s, v % a.s,
                  a.bw, a.bh, a.bn))
      return (int)cudaErrorInvalidValue;
  CUtensorMap tbh, tbl;
  if (!encode_w(&tbh, a.whi, a.p.Cout, a.kh * a.kw, a.C, BN) ||
      !encode_w(&tbl, a.wlo, a.p.Cout, a.kh * a.kw, a.C, BN))
    return (int)cudaErrorInvalidValue;
  constexpr int threads = Geo<BM, BN>::kThreads, smem = Geo<BM, BN>::SMEM;
  dim3 grid(a.tiles_m, (a.p.Cout + BN - 1) / BN);
  conv2d_tf32x3_kernel<BM, BN><<<grid, threads, smem, stream>>>(am, tbh, tbl, a.p);
  return (int)cudaGetLastError();
}

template <int BM>
int dispatch_bn(Args& a, int bn_cols, cudaStream_t stream) {
  switch (bn_cols) {
    case 16: return launch<BM, 16>(a, stream);
    case 64: return launch<BM, 64>(a, stream);
    case 128: return launch<BM, 128>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x (N, H, W, C) float32 contiguous, C % 4 == 0, 16-byte aligned; w_hi and
// w_lo (Cout, kh, kw, C) float32 contiguous, the TF32 halves of the weight;
// bias (Cout,), row (N, Cout) and res (N, Ho, Wo, Cout) contiguous, each
// optional (null); out (N, Ho, Wo, Cout) at element strides osN, osH, osW
// with channels contiguous.  Input pixel of output (oy, ox) and tap
// (ky, kx): (stride oy + dy0 + ky, stride ox + dx0 + kx), zero outside;
// stride 1 or 2 (2 needs H, W >= 2).  The tile: bm (128 or 64) output
// pixels as a box of box_w x box_h pixels of box_n images, bn_cols (128,
// 64 or 16) channels.  Launches on `stream`; returns a CUDA error code.
extern "C" int conv2d_nhwc_f32(const float* x, const float* w_hi,
                               const float* w_lo, const float* bias,
                               const float* row, const float* res, float* out,
                               int N, int H, int W, int C, int Ho, int Wo,
                               int Cout, int kh, int kw, int dy0, int dx0,
                               int stride, long long osN, long long osH,
                               long long osW, int bm, int bn_cols, int box_w,
                               int box_h, int box_n, cudaStream_t stream) {
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || C % 4 || Ho <= 0 || Wo <= 0 ||
      Cout <= 0 || kh <= 0 || kw <= 0 || (stride != 1 && stride != 2) ||
      box_w <= 0 || box_h <= 0 || box_n <= 0 || box_w > 256 || box_h > 256 ||
      box_n > 256 || box_w * box_h * box_n > bm)
    return (int)cudaErrorInvalidValue;
  Args a{x, w_hi, w_lo, N, H, W, C, kh, kw, stride, box_w, box_h, box_n};
  a.tiles_x = (Wo + box_w - 1) / box_w;
  a.tiles_y = (Ho + box_h - 1) / box_h;
  a.tiles_m = a.tiles_x * a.tiles_y * ((N + box_n - 1) / box_n);
  const int nc = (C + BK - 1) / BK;
  const bool vec2 = Cout % 2 == 0 && osN % 2 == 0 && osH % 2 == 0 &&
                    osW % 2 == 0 && reinterpret_cast<uintptr_t>(out) % 8 == 0;
  a.p = Params{N, Ho, Wo, Cout, kw, dy0, dx0, stride, nc, kh * kw * nc,
               box_w, box_h, box_n, a.tiles_x, a.tiles_y,
               box_w * box_h * box_n * BK * 4, vec2 ? 1 : 0,
               bias, row, res, out, osN, osH, osW};
  if (bm == 128) return dispatch_bn<128>(a, bn_cols, stream);
  if (bm == 64) return dispatch_bn<64>(a, bn_cols, stream);
  return (int)cudaErrorInvalidValue;
}

// Raise every tile's shared-memory limit on the current device, as its
// first launch there would; launches nothing.  Returns a CUDA error code.
extern "C" int conv2d_nhwc_prepare() {
  cudaError_t e = configure<128, 128>();
  if (e == cudaSuccess) e = configure<128, 64>();
  if (e == cudaSuccess) e = configure<128, 16>();
  if (e == cudaSuccess) e = configure<64, 128>();
  if (e == cudaSuccess) e = configure<64, 64>();
  if (e == cudaSuccess) e = configure<64, 16>();
  return (int)e;
}
