// Fused ResNet stem for Hopper (sm_90a), plain C interface: conv 7x7/2
// (3 -> 64, pad 3, no bias), train-mode batch norm, ReLU, maxpool 3x3/2
// (pad 1), forward and backward, in five kernels, and the bfloat16 forms
// of four of them (section 6).
//
// Replaces the TPU kernels of raw2logit_tpu/pallas/stem.py:
//   stem_conv_fwd_kernel   <- _conv_kernel          act = x (*) w, and the
//                             per-channel partial sums of act and act^2
//   stem_bnpool_kernel     <- _bnpool_kernel        maxpool(relu(act a + b))
//   stem_pool_bwd_kernel   <- _pool_bn_bwd_kernel   d_n (pool backward in
//                             gather form, ReLU mask) and the partial sums
//                             of d_n and d_n xhat
//   stem_conv_dw_kernel    <- _conv_dw_kernel       partial dW
//   stem_conv_dx_kernel    <- _conv_dxs_kernel      d_x
// Shapes: x (B, 3, H, W), w (64, 3, 7, 7) OIHW, act and d_n (B, 64, Ho, Wo)
// with Ho = H / 2, Wo = W / 2, pooled (B, 64, Ho / 2, Wo / 2); H and W are
// multiples of 4 (the wrapper checks). All planar, contiguous.
//
// The five kernels are templates on T, the storage type of act, pooled,
// d_n and the pooled cotangent; only the pool backward's bfloat16 form is
// its T = __nv_bfloat16 instance. The bfloat16 conv forward, dW and d_x
// are kernels of their own on bf16 tensor cores and the bfloat16 BN-pool
// a strip walk of its own (section 6); the float32 forms are the float
// instances. The bfloat16 forms compute what the TPU kernels compute with
// compute_dtype=bfloat16
// (raw2logit_tpu/pallas/stem.py): x and w are rounded to bfloat16 where
// the convolutions load them, products and sums are float32, act is
// stored rounded while the statistics come from the float32 accumulator,
// BN, ReLU and the pool run in float32 on the widened act, d_n is stored
// rounded while its sums come from the float32 value, and d_a is formed
// in float32 and rounded to bfloat16 before dW and d_x contract it. x, w,
// dW, d_x and every sum stay float32 (float64 partials).
//
// The TPU kernels' space-to-depth phase planes and selector matrices are
// workarounds for Mosaic's lack of lane-strided loads; here the strided
// taps are plain shared-memory addresses. The backward starts from the
// closed train-mode form d_a = g1 (d_n - c1 - xhat c2) with xhat =
// (act - mu) inv, recomputed where dW and d_x read it (as the TPU kernels
// do), so d_a never goes to device memory.
//
// Bounds of the float32 forms on an H100 at B = 256, 256x256 (act is 268
// M elements): the two convolutions are bound by operations, 2 * 147 FMA
// operands per act element, 78.9 GFLOP each (1.18 ms at 67 TFLOP/s of
// non-tensor f32); the BN-pool pass and the pool backward by bytes (1.34
// and 2.42 GB, 0.40 and 0.72 ms at 3.35 TB/s). Design: direct FMAs from
// shared memory, register blocking so that each shared load feeds several
// FMAs, the weights staged in shared memory once per CTA, and CTAs that
// walk many tiles so that the weights are read from L2 a few hundred
// times, not once per tile. No tensor cores (TF32 would break the float32
// contract), no TMA. The bfloat16 pool backward runs the same code on
// widened values; the bfloat16 conv forward, dW and d_x run on bf16
// tensor cores (mma.sync), bound by bytes (0.22, 0.38 and 0.38 ms), and
// the bfloat16 BN-pool walks strips of the planes, bound by bytes (0.20
// ms), section 6.
//
// The conv forward, dW and d_x were redesigned for Hopper: one CTA per SM
// walking all tiles of the batch with a stride of the grid; their inputs
// staged by cp.async into double buffers, so that the next stage's copies
// overlap this stage's FMAs (the forward's input split into even- and
// odd-column phase planes on the way); d_a formed once per staged
// element; register tiles that cut shared loads per FMA to 49/896 (the
// forward), 12/80 (dW) and 76/768 (d_x, the
// space-to-depth form of the TPU kernel, whose 16 taps per output pad 147
// real taps to 192: its FFMA floor is 1.54 ms at B = 256, against the
// 1.18 ms of the real taps). The pool backward was redesigned too: warps
// of a persistent grid walk down 128-column strips of the planes, each
// lane prefetching into its own ring in shared memory (section 3).
//
// Cross-CTA reductions (the BN statistics, dW, the pool backward's sums)
// are per-CTA or per-unit partials in a fixed order, summed by the wrapper
// in float64: no atomics, so two launches are bitwise equal. Products that
// the plain version rounds twice (act a + b, xhat, d_a) are rounded as
// written (__fmul_rn, __fadd_rn), so that the ReLU mask and the pool's
// argmax are decided on the same values as in the plain version. No fast
// math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "kernel_info.cuh"

namespace {

constexpr int C_OUT = 64;
constexpr int C_IN = 3;
constexpr int K = 7;
constexpr int KK = K * K;          // 49
constexpr int TAPS = C_IN * KK;    // 147
constexpr int NTHREADS = 256;

__host__ __device__ constexpr int cdiv(int a, int b) {
  return (a + b - 1) / b;
}

// BN coefficient rows in the coef arrays (each row 64 floats).
// bnpool: [alpha, beta]; pool_bwd: [alpha, beta, mu, inv];
// conv_dw / conv_dx: [g1, c1, c2, mu, inv].

using bf16 = __nv_bfloat16;

// Storage conversions: a T widened to float, a float rounded (to nearest
// even) to T, and a float rounded to T's precision and kept as a float.
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// Four and two consecutive elements of T, as one aligned access.
template <typename T>
struct alignas(4 * sizeof(T)) Vec4 {
  T v[4];
};
template <typename T>
struct alignas(2 * sizeof(T)) Vec2 {
  T v[2];
};

template <typename T>
__device__ __forceinline__ float4 widen4(const Vec4<T>& q) {
  return make_float4(to_f32(q.v[0]), to_f32(q.v[1]), to_f32(q.v[2]),
                     to_f32(q.v[3]));
}

__device__ __forceinline__ float bn_out(float a, float alpha, float beta) {
  return __fadd_rn(__fmul_rn(a, alpha), beta);
}

// d_a = g1 (d_n - c1 - xhat c2), xhat = (a - mu) inv, rounded as written.
__device__ __forceinline__ float bn_input_cotangent(float a, float dn,
                                                    float g1, float c1,
                                                    float c2, float mu,
                                                    float inv) {
  const float xhat = __fmul_rn(__fsub_rn(a, mu), inv);
  return __fmul_rn(g1, __fsub_rn(__fsub_rn(dn, c1), __fmul_rn(xhat, c2)));
}

// cp.async of one float from device memory to shared memory; with `in`
// false the slot is filled with zero and nothing is read.
__device__ __forceinline__ void cp_async_f32(float* dst, const float* src,
                                             bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

// The same for 16 bytes (both addresses 16-byte aligned).
__device__ __forceinline__ void cp_async_f32x4(float* dst, const float* src,
                                               bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

// cp.async of BYTES (4, 8 or 16; both addresses so aligned).
template <int BYTES>
__device__ __forceinline__ void cp_async_n(void* dst, const void* src,
                                           bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
               "l"(src), "n"(BYTES), "r"(in ? BYTES : 0)
               : "memory");
}

// Four elements of T into shared memory (16 or 8 bytes, aligned).
__device__ __forceinline__ void cp_async_vec4(float* dst, const float* src,
                                              bool in) {
  cp_async_f32x4(dst, src, in);
}
__device__ __forceinline__ void cp_async_vec4(bf16* dst, const bf16* src,
                                              bool in) {
  cp_async_n<8>(dst, src, in);
}

// One element of T into shared memory, zero where `in` is false: by
// cp.async for float, by a plain load and store for bfloat16 (cp.async
// copies at least 4 bytes). Either has landed after the next
// cp_async_wait and barrier.
__device__ __forceinline__ void copy_elem(float* dst, const float* src,
                                          bool in) {
  cp_async_n<4>(dst, src, in);
}
__device__ __forceinline__ void copy_elem(bf16* dst, const bf16* src,
                                          bool in) {
  *dst = in ? *src : __float2bfloat16_rn(0.f);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// 1. Conv forward and the statistics' partials.
//
// Tile: 16 x 32 output positions; a CTA walks tiles (image-major) with a
// stride of the grid, one CTA per SM. The tile's input with its halo, 3 x
// 37 x 69 (zero outside the image), is staged by cp.async into a double
// buffer, so that the next tile's copies overlap this tile's FMAs, and is
// split on the way into even- and odd-column phase planes ([even 35 | odd
// 34] per row): the stride-2 tap kx of output column v reads phase kx % 2
// at column v + kx / 2, so a warp's 32 lanes read 32 consecutive words. The
// copies are 4-byte (the split needs a destination per element); the
// input is 3/64 of act, so they cost about 40 instructions per thread per
// tile against 18,816 FMAs. Thread: lane = output column, warp w = channels
// 16 (w % 4) .. + 15 (warp-uniform: the weight loads broadcast) x output
// rows 8 (w / 4) .. + 7: 128 accumulators. Per (channel, kx) a column of
// 21 input values is loaded into registers and feeds the 7 taps ky; per
// tap 4 float4 weight loads feed 128 FMAs: 49 shared loads per 896 FMAs.
// Statistics: each thread sums its 8 rows per channel in float32 and adds
// the sums into its own float64 slots in shared memory once per tile; the
// CTA reduces the slots once, in a fixed order, into partials[cta].
// Shared memory: the weights as [tap][64] (37,632 B), two input tiles
// (61,272 B) and the float64 slots (65,536 B). Only the float instance is
// built: the bfloat16 conv forward runs on tensor cores (section 6c).

constexpr int CF_RPT = 8;              // output rows per thread
constexpr int CF_CPT = 16;             // channels per thread
constexpr int CF_CG = C_OUT / CF_CPT;  // channel groups (warps)
constexpr int CF_RG = NTHREADS / 32 / CF_CG;  // row groups (warps)
constexpr int CF_TH = CF_RG * CF_RPT, CF_TW = 32;  // positions per tile
constexpr int CF_IR = 2 * CF_TH + 5;   // 37 input rows
constexpr int CF_IC = 2 * CF_TW + 5;   // 69 input cols
constexpr int CF_EV = (CF_IC + 1) / 2;  // 35 even cols, then 34 odd ones
constexpr int CF_XS = C_IN * CF_IR * CF_IC;
constexpr int CF_NV = 2 * CF_CPT;      // float64 slots per thread
constexpr size_t CF_SMEM =
    (size_t)CF_NV * NTHREADS * sizeof(double) +
    (size_t)(TAPS * C_OUT + 2 * CF_XS) * sizeof(float);

template <typename T>
__global__ void __launch_bounds__(NTHREADS, 1)
stem_conv_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     T* __restrict__ act, double* __restrict__ partials,
                     int B, int H, int W) {
  extern __shared__ __align__(16) double smd[];
  double* st = smd;                    // [CF_NV][NTHREADS]
  float* ws = reinterpret_cast<float*>(st + CF_NV * NTHREADS);  // [TAPS][64]
  float* xs = ws + TAPS * C_OUT;       // [2][C_IN][CF_IR][CF_IC]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cg = warp % CF_CG, rg = warp / CF_CG;
  const int Ho = H / 2, Wo = W / 2;
  const int ntx = cdiv(Wo, CF_TW), tiles = cdiv(Ho, CF_TH) * ntx;
  const int total = B * tiles;
  const int n_items =
      (total - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const bool stats = partials != nullptr;

  for (int i = tid; i < TAPS * C_OUT; i += NTHREADS) {
    const int t = i / C_OUT, o = i % C_OUT;
    ws[i] = round_to<T>(w[o * TAPS + t]);
  }
  if (stats)
    for (int i = 0; i < CF_NV; ++i) st[i * NTHREADS + tid] = 0.0;

  auto origin = [&](int item, int& b, int& oy0, int& ox0) {
    const int g = (int)blockIdx.x + item * (int)gridDim.x;
    b = g / tiles;
    const int tile = g % tiles;
    oy0 = (tile / ntx) * CF_TH;
    ox0 = (tile % ntx) * CF_TW;
  };
  auto fetch = [&](int item) {
    int b, oy0, ox0;
    origin(item, b, oy0, ox0);
    const int iy0 = 2 * oy0 - 3, ix0 = 2 * ox0 - 3;
    float* xd = xs + (item & 1) * CF_XS;
    const float* xb = x + (size_t)b * C_IN * H * W;
    for (int row = warp; row < C_IN * CF_IR; row += NTHREADS / 32) {
      const int c = row / CF_IR, yy = iy0 + row - c * CF_IR;
      const bool row_in = yy >= 0 && yy < H;
      const float* src = xb + ((size_t)c * H + (row_in ? yy : 0)) * W;
      float* dst = xd + row * CF_IC;
      for (int col = lane; col < CF_IC; col += 32) {
        const int xx = ix0 + col;
        const bool in = row_in && xx >= 0 && xx < W;
        cp_async_f32(dst + (col & 1) * CF_EV + (col >> 1), in ? src + xx : src,
                     in);
      }
    }
  };

  if (n_items > 0) fetch(0);
  cp_async_commit();
  for (int item = 0; item < n_items; ++item) {
    cp_async_wait_all();
    __syncthreads();  // this tile's copies landed; the last tile's reads done
    if (item + 1 < n_items) fetch(item + 1);
    cp_async_commit();

    float acc[CF_RPT][CF_CPT];
#pragma unroll
    for (int i = 0; i < CF_RPT; ++i)
#pragma unroll
      for (int j = 0; j < CF_CPT; ++j) acc[i][j] = 0.f;
    // input row 2 (8 rg + i) + ky of output row 8 rg + i
    const float* xt =
        xs + (item & 1) * CF_XS + 2 * CF_RPT * rg * CF_IC + lane;
#pragma unroll 1
    for (int ckx = 0; ckx < C_IN * K; ++ckx) {
      const int c = ckx / K, kx = ckx - c * K;
      const float* col =
          xt + c * CF_IR * CF_IC + (kx & 1) * CF_EV + (kx >> 1);
      float v[2 * CF_RPT + K - 2];
#pragma unroll
      for (int r = 0; r < 2 * CF_RPT + K - 2; ++r)
        v[r] = round_to<T>(col[r * CF_IC]);
      const float4* wk = reinterpret_cast<const float4*>(
          ws + (c * KK + kx) * C_OUT + CF_CPT * cg);
#pragma unroll
      for (int ky = 0; ky < K; ++ky) {
        const float4* wp = wk + ky * K * (C_OUT / 4);
        float4 w4[CF_CPT / 4];
#pragma unroll
        for (int q = 0; q < CF_CPT / 4; ++q) w4[q] = wp[q];
#pragma unroll
        for (int i = 0; i < CF_RPT; ++i) {
          const float xv = v[2 * i + ky];
#pragma unroll
          for (int q = 0; q < CF_CPT / 4; ++q) {
            acc[i][4 * q + 0] = fmaf(xv, w4[q].x, acc[i][4 * q + 0]);
            acc[i][4 * q + 1] = fmaf(xv, w4[q].y, acc[i][4 * q + 1]);
            acc[i][4 * q + 2] = fmaf(xv, w4[q].z, acc[i][4 * q + 2]);
            acc[i][4 * q + 3] = fmaf(xv, w4[q].w, acc[i][4 * q + 3]);
          }
        }
      }
    }

    int b, oy0, ox0;
    origin(item, b, oy0, ox0);
    const int ox = ox0 + lane, oyr = oy0 + CF_RPT * rg;
    const bool col_in = ox < Wo;
    T* ab = act + ((size_t)b * C_OUT + CF_CPT * cg) * Ho * Wo;
#pragma unroll
    for (int j = 0; j < CF_CPT; ++j) {
      T* plane = ab + (size_t)j * Ho * Wo;
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int i = 0; i < CF_RPT; ++i) {
        if (!col_in || oyr + i >= Ho) continue;
        plane[(size_t)(oyr + i) * Wo + ox] = from_f32<T>(acc[i][j]);
        s1 += acc[i][j];
        s2 += acc[i][j] * acc[i][j];
      }
      if (stats) {
        st[(2 * j) * NTHREADS + tid] += (double)s1;
        st[(2 * j + 1) * NTHREADS + tid] += (double)s2;
      }
    }
  }
  if (!stats) return;
  __syncthreads();
  if (tid < 2 * C_OUT) {
    // partials[cta][k][o]: channel o's 64 threads (row group, lane), in order
    const int k = tid / C_OUT, o = tid % C_OUT;
    const int g = o / CF_CPT, j = o % CF_CPT;
    const double* sv = st + (2 * j + k) * NTHREADS;
    double s = 0.0;
    for (int r = 0; r < CF_RG; ++r)
      for (int l = 0; l < 32; ++l) s += sv[(r * CF_CG + g) * 32 + l];
    partials[(size_t)blockIdx.x * 2 * C_OUT + k * C_OUT + o] = s;
  }
}

// ---------------------------------------------------------------------------
// 2. BN (folded alpha, beta), ReLU and maxpool 3x3/2 pad 1: one thread per
// pooled element; the pad never wins (ReLU output >= 0, and the window's
// centre is always inside the image). Bytes-bound; the 9 taps overlap
// between neighbouring threads and come from L1. Only the float instance
// is built: the bfloat16 BN-pool is the strip walk of section 6d.

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
stem_bnpool_kernel(const T* __restrict__ act,
                   const float* __restrict__ coef, T* __restrict__ out,
                   int B, int Ho, int Wo) {
  const int Hq = Ho / 2, Wq = Wo / 2;
  const size_t n = (size_t)B * C_OUT * Hq * Wq;
  for (size_t idx = (size_t)blockIdx.x * NTHREADS + threadIdx.x; idx < n;
       idx += (size_t)gridDim.x * NTHREADS) {
    const int j = (int)(idx % Wq), i = (int)((idx / Wq) % Hq);
    const size_t plane = idx / ((size_t)Wq * Hq);
    const int c = (int)(plane % C_OUT);
    const float alpha = coef[c], beta = coef[C_OUT + c];
    const T* ap = act + plane * Ho * Wo;
    float m = 0.f;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const int y = 2 * i + dy - 1;
      if (y < 0 || y >= Ho) continue;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const int xx = 2 * j + dx - 1;
        if (xx < 0 || xx >= Wo) continue;
        m = fmaxf(m,
                  bn_out(to_f32(__ldg(ap + (size_t)y * Wo + xx)), alpha, beta));
      }
    }
    out[idx] = from_f32<T>(m);
  }
}

// ---------------------------------------------------------------------------
// 3. Pool, ReLU and BN backward: d_n, the cotangent of n = act alpha +
// beta (the pool backward in gather form, then the ReLU mask), and the
// partial sums of d_n and d_n xhat.
//
// Bound on an H100 by bytes: it reads act (4 B) and the pooled cotangent
// dp (1 B) and writes d_n (4 B) per act element, 2.42 GB at B = 256,
// 256x256 (0.72 ms at 3.35 TB/s), with about 35 instructions per element.
// The first port (a CTA per 8 x 32 windows of one plane, three barriers, a
// 24% halo read as odd-aligned scalar loads, act read twice) moved about
// 1.04 TB/s.
//
// Design: no barrier. A warp walks down a strip of 128 pre-pool columns of
// one plane, four columns (two pooling windows) a lane, one window row (two
// pre-pool rows) a step: a lane reads two float4 of act and a float2 of dp
// and writes two float4 of d_n. Its reads go by cp.async into a ring of PB_S
// steps in shared memory that only the lane itself reads, so that PB_S - 1
// steps of loads are in flight without holding registers (a prefetch one
// step ahead in registers spilled at 64 registers and read 1.66 ms at B =
// 256; the ring reads 0.90 ms, about 2.7 TB/s, and deeper rings or two CTAs
// per SM read no faster). act is read once; r = relu(act alpha + beta), the
// mask and xhat come from that copy. Window j of row k covers rows
// 2k-1..2k+1 and columns 2j-1..2j+1: its top row is the last step's bottom
// row, the column left of a lane comes from its left neighbour by
// __shfl_up_sync (-1 at the plane's edge, a load at a strip's edge), and the
// first window of the lane to the right (its first maximum and cotangent) by
// __shfl_down_sync (lane 31 computes it from loads where the next strip
// holds it). Each window takes its first maximum in tap order (v > best), as
// _argmax_first. A pre-pool position receives from at most four windows, and
// the plain version sums them from 0 in tap order t = 0..8: an odd row 2k-1
// takes window row k's taps (t = 0, 1, 2) before window row k-1's (t = 6, 7,
// 8). So a step holds row k-1's six upper contributions and adds them after
// row k's, each sum written out in that order with an absent contribution as
// +0 (x + 0 = x): d_n is bitwise the plain version's.
//
// Work: units of PB_CH window rows of one strip of one plane, in
// plane-major order; warp w of the persistent grid (n warps, r2l_stem_ctas)
// takes the run of units [w U / n, (w + 1) U / n) and walks each plane's
// part of it top-down, reading one halo row above and two below. Sums: a
// lane's float32 sum over the four positions of a row, added in float64
// over the unit's rows; the unit's warp sum (a fixed butterfly) is its
// partial, so the sums do not depend on the grid. Rows whose width is not
// a multiple of 4 (Wo % 4 == 2) or misaligned tensors take 4-byte copies
// and scalar stores (kVec false). The bfloat16 form (T) keeps the same
// walk: its rows are half as many bytes (8-byte and 4-byte copies; its
// scalar path loads and stores without cp.async, which copies at least 4
// bytes), it widens act and the cotangent on reading, and stores d_n
// rounded while its sums take the float32 values.

constexpr int PB_SW = 128;                // pre-pool columns per strip
constexpr int PB_CH = 8;                  // window rows per unit
constexpr int PB_S = 4;                   // steps in a lane's ring
constexpr int PB_WARPS = NTHREADS / 32;
constexpr int PB_CTAS = 3;                // CTAs per SM (80 registers)
constexpr size_t PB_SMEM =
    (size_t)PB_S * NTHREADS * (2 * sizeof(float4) + sizeof(float2));
constexpr unsigned FULL = 0xffffffffu;

// One pre-pool row at a lane's four columns: act, and r = relu(act alpha +
// beta), -1 outside the plane.
struct PbRow {
  float a[4], r[4];
  float left;    // r of the column left of the lane's
  float e0, e1;  // lane 31 before a next strip: r of its first two columns
};

// First maximum of a window's nine taps in tap order (_argmax_first).
__device__ __forceinline__ int first_max(float v0, float v1, float v2,
                                         float v3, float v4, float v5,
                                         float v6, float v7, float v8) {
  const float v[9] = {v0, v1, v2, v3, v4, v5, v6, v7, v8};
  float best = v[0];
  int id = 0;
#pragma unroll
  for (int t = 1; t < 9; ++t)
    if (v[t] > best) {
      best = v[t];
      id = t;
    }
  return id;
}

__device__ __forceinline__ float sel(int id, int t, float d) {
  return id == t ? d : 0.f;
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <bool kVec, typename T>
__global__ void __launch_bounds__(NTHREADS, PB_CTAS)
stem_pool_bwd_kernel(const T* __restrict__ act, const T* __restrict__ dp,
                     const float* __restrict__ coef, T* __restrict__ dn,
                     double* __restrict__ partials, int B, int Ho, int Wo) {
  // each lane's ring: act rows 2k, 2k + 1 and dp row k of PB_S steps
  extern __shared__ __align__(16) float4 pb_ring[];
  using A4 = Vec4<T>;
  using D2 = Vec2<T>;
  A4 (*ring_a)[2][NTHREADS] = reinterpret_cast<A4 (*)[2][NTHREADS]>(pb_ring);
  D2 (*ring_d)[NTHREADS] = reinterpret_cast<D2 (*)[NTHREADS]>(
      reinterpret_cast<A4*>(pb_ring) + PB_S * 2 * NTHREADS);

  const int tid = threadIdx.x, lane = tid & 31;
  const int Hq = Ho / 2, Wq = Wo / 2;
  const int nstrips = cdiv(Wo, PB_SW), nchunks = cdiv(Hq, PB_CH);
  const long long units = (long long)B * C_OUT * nstrips * nchunks;
  const long long nw = (long long)gridDim.x * PB_WARPS;
  const long long w = (long long)blockIdx.x * PB_WARPS + (tid >> 5);
  const long long u_end = (w + 1) * units / nw;

  for (long long u = w * units / nw; u < u_end;) {
    // A segment: the run's units in one strip of one plane.
    const long long ps = u / nchunks;  // plane * nstrips + strip
    const long long seg_end = min(u_end, (ps + 1) * nchunks);
    const int k_first = (int)(u - ps * nchunks) * PB_CH;
    const int k_last = min(Hq, (int)(seg_end - ps * nchunks) * PB_CH);
    const long long plane = ps / nstrips;
    const int strip = (int)(ps - plane * nstrips);
    const int c = (int)(plane % C_OUT);
    const float alpha = coef[c], beta = coef[C_OUT + c];
    const float mu = coef[2 * C_OUT + c], inv = coef[3 * C_OUT + c];
    const T* ap = act + (size_t)plane * Ho * Wo;
    const T* dpp = dp + (size_t)plane * Hq * Wq;
    T* dnp = dn + (size_t)plane * Ho * Wo;
    const int x0 = strip * PB_SW + 4 * lane;  // the lane's first column
    const int j0 = x0 / 2;                    // its windows j0, j0 + 1
    const bool far_left = lane == 0 && strip > 0;
    const bool far_right = lane == 31 && j0 + 2 < Wq;
    u = seg_end;

    // Step k's copies into ring slot k % PB_S (window row k: act rows 2k,
    // 2k + 1 and dp row k); one commit group a call, empty past the
    // segment's last step.
    auto fetch = [&](int k) {
      if (k <= k_last && k < Hq) {
        const int s = k % PB_S;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const T* row = ap + (size_t)(2 * k + h) * Wo;
          T* dst = ring_a[s][h][tid].v;
          if (kVec) {
            cp_async_vec4(dst, x0 < Wo ? row + x0 : row, x0 < Wo);
          } else {
#pragma unroll
            for (int q = 0; q < 4; ++q)
              copy_elem(dst + q, x0 + q < Wo ? row + x0 + q : row,
                        x0 + q < Wo);
          }
        }
        const T* drow = dpp + (size_t)k * Wq;
        T* dst = ring_d[s][tid].v;
        if (kVec) {
          cp_async_n<2 * sizeof(T)>(dst, j0 < Wq ? drow + j0 : drow, j0 < Wq);
        } else {
          copy_elem(dst, j0 < Wq ? drow + j0 : drow, j0 < Wq);
          copy_elem(dst + 1, j0 + 1 < Wq ? drow + j0 + 1 : drow, j0 + 1 < Wq);
        }
      }
      cp_async_commit();
    };
    auto relu_bn = [&](float a) {
      return fmaxf(bn_out(a, alpha, beta), 0.f);
    };
    // Row y's r from its act a (the lane's columns); the columns beyond
    // the lane's from its neighbours or, across strips, from loads.
    auto make_row = [&](int y, const float4 a4, PbRow& row) {
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        row.a[q] = a[q];
        row.r[q] = x0 + q < Wo ? relu_bn(a[q]) : -1.f;
      }
      const float up = __shfl_up_sync(FULL, row.r[3], 1);
      const T* src = ap + (size_t)y * Wo + x0;
      row.left = lane > 0 ? up : far_left ? relu_bn(to_f32(src[-1])) : -1.f;
      row.e0 = far_right ? relu_bn(to_f32(src[4])) : -1.f;
      row.e1 = far_right ? relu_bn(to_f32(src[5])) : -1.f;
    };
    // d_n of row y from the gathered cotangents d (masked where n <= 0);
    // its sums into the unit's.
    double s_dn = 0.0, s_dx = 0.0;
    auto emit = [&](int y, const PbRow& row, float d0, float d1, float d2,
                    float d3) {
      float v[4] = {d0, d1, d2, d3};
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        v[q] = row.r[q] > 0.f ? v[q] : 0.f;
        const float xhat = __fmul_rn(__fsub_rn(row.a[q], mu), inv);
        s1 += v[q];
        s2 = fmaf(v[q], xhat, s2);
      }
      T* out = dnp + (size_t)y * Wo;
      if (kVec && x0 < Wo) {
        A4 o4;
#pragma unroll
        for (int q = 0; q < 4; ++q) o4.v[q] = from_f32<T>(v[q]);
        *reinterpret_cast<A4*>(out + x0) = o4;
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (x0 + q < Wo) out[x0 + q] = from_f32<T>(v[q]);
      }
      s_dn += (double)s1;
      s_dx += (double)s2;
    };
    auto flush = [&](long long unit) {
      double a = s_dn, b = s_dx;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        a += __shfl_xor_sync(FULL, a, o);
        b += __shfl_xor_sync(FULL, b, o);
      }
      if (lane == 0) {
        partials[2 * unit] = a;
        partials[2 * unit + 1] = b;
      }
      s_dn = s_dx = 0.0;
    };

#pragma unroll
    for (int i = 0; i < PB_S - 1; ++i) fetch(k_first + i);
    // top: row 2k - 1, the bottom row of window row k - 1
    PbRow top;
    if (k_first == 0) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        top.a[q] = 0.f;
        top.r[q] = -1.f;
      }
      top.left = top.e0 = top.e1 = -1.f;
    } else {
      const int y = 2 * k_first - 1;
      float4 a4 = make_float4(0.f, 0.f, 0.f, 0.f);
      const T* row = ap + (size_t)y * Wo;
      if (kVec && x0 < Wo) {
        a4 = widen4(*reinterpret_cast<const A4*>(row + x0));
      } else {
        if (x0 < Wo) a4.x = to_f32(row[x0]);
        if (x0 + 1 < Wo) a4.y = to_f32(row[x0 + 1]);
        if (x0 + 2 < Wo) a4.z = to_f32(row[x0 + 2]);
        if (x0 + 3 < Wo) a4.w = to_f32(row[x0 + 3]);
      }
      make_row(y, a4, top);
    }
    // window row k - 1's contributions to row 2k - 1 (taps 6, 7, 8)
    float u0 = 0.f, u1a = 0.f, u1b = 0.f, u2 = 0.f, u3a = 0.f, u3b = 0.f;
    for (int k = k_first; k <= k_last; ++k) {
      // window row k (none at k = Hq): first maxima and cotangents
      fetch(k + PB_S - 1);
      cp_async_wait<PB_S - 1>();  // step k's copies (the lane's own) landed
      int iA = 0, iB = 0, iC = 0;
      float dA = 0.f, dB = 0.f, dC = 0.f;
      PbRow mid, bot;
      if (k < Hq) {
        const int s = k % PB_S;
        make_row(2 * k, widen4(ring_a[s][0][tid]), mid);
        make_row(2 * k + 1, widen4(ring_a[s][1][tid]), bot);
        const D2 dq = ring_d[s][tid];
        const float2 d = make_float2(to_f32(dq.v[0]), to_f32(dq.v[1]));
        iA = first_max(top.left, top.r[0], top.r[1], mid.left, mid.r[0],
                       mid.r[1], bot.left, bot.r[0], bot.r[1]);
        iB = first_max(top.r[1], top.r[2], top.r[3], mid.r[1], mid.r[2],
                       mid.r[3], bot.r[1], bot.r[2], bot.r[3]);
        dA = d.x;
        dB = d.y;
        iC = __shfl_down_sync(FULL, iA, 1);
        dC = __shfl_down_sync(FULL, dA, 1);
        if (lane == 31) {
          iC = first_max(top.r[3], top.e0, top.e1, mid.r[3], mid.e0, mid.e1,
                         bot.r[3], bot.e0, bot.e1);
          dC = far_right ? to_f32(dpp[(size_t)k * Wq + j0 + 2]) : 0.f;
        }
      }
      // row 2k - 1: window row k's taps 0, 1, 2, then row k - 1's 6, 7, 8
      if (k > k_first) {
        emit(2 * k - 1, top, sel(iA, 1, dA) + u0,
             ((sel(iB, 0, dB) + sel(iA, 2, dA)) + u1a) + u1b,
             sel(iB, 1, dB) + u2,
             ((sel(iC, 0, dC) + sel(iB, 2, dB)) + u3a) + u3b);
        if (k % PB_CH == 0 || k == Hq) flush(ps * nchunks + (k - 1) / PB_CH);
      }
      if (k == k_last) break;
      // row 2k: window row k's taps 3, 4, 5
      emit(2 * k, mid, sel(iA, 4, dA), sel(iB, 3, dB) + sel(iA, 5, dA),
           sel(iB, 4, dB), sel(iC, 3, dC) + sel(iB, 5, dB));
      u0 = sel(iA, 7, dA);
      u1a = sel(iB, 6, dB);
      u1b = sel(iA, 8, dA);
      u2 = sel(iB, 7, dB);
      u3a = sel(iC, 6, dC);
      u3b = sel(iB, 8, dB);
      top = bot;
    }
    cp_async_wait<0>();  // no copy outlives its segment
  }
}

// ---------------------------------------------------------------------------
// 4. dW partials: dW[o, t] = sum over positions p of d_a[o, p] * patch[p, t],
// the product (64 x positions) . (positions x 147).
//
// Tile: 16 x 32 output positions; a CTA walks tiles (image-major) with a
// stride of the grid, one CTA per SM. The tile is staged two rows (64
// positions) at a time: act and d_n for the 64 channels by cp.async
// (16-byte copies where Wo is a multiple of 4) into a double buffer, so
// that the next stage's copies overlap this stage's FMAs; the tile's
// input with its halo, 3 x 37 x 69 (zero outside the image), likewise,
// with the tile's first stage. Each stage forms d_a once per element into
// [position][channel] rows of 68 floats: a thread reads 4 positions of one
// channel (a float4; raw rows of 68 floats, so a quarter-warp's 8 channels
// cover the 32 banks) and a warp stores 32 consecutive channels of a
// position: no bank conflict on either side. The two halves of the CTA
// (warps 0-3, 4-7) take one row of the stage each. Thread: 8 channels
// (4 cg .. 4 cg + 3 and 32 + 4 cg .., two conflict-free float4 loads) x 10
// taps (taps 147..159 are padding, never written): per position 2 float4
// and 10 scalar loads feed 80 FMAs. Sums in two levels: a fresh
// accumulator per stage (the 32 positions of the half's row) in
// registers, added into the CTA's in shared memory ([value][thread],
// conflict-free); each half writes its own partials. (One chain per tile,
// 256 positions, put dW at 72x40 2.0x further from float64 than the
// plain version.) The bfloat16 dW is stem_conv_dw_mma_kernel (section 6a).

constexpr int DW_TH = 16, DW_TW = 32;     // 512 positions per tile
constexpr int DW_SR = 2;                  // rows per stage, one per half
constexpr int DW_SP = DW_SR * DW_TW;      // 64 positions per stage
constexpr int DW_NS = DW_TH / DW_SR;      // 8 stages per tile
constexpr int DW_RS = DW_SP + 4;          // raw row stride (float4 rows)
constexpr int DW_DS = C_OUT + 4;          // d_a row stride (float4 rows)
constexpr int DW_IR = 2 * DW_TH + 5;      // 37
constexpr int DW_IC = 2 * DW_TW + 5;      // 69
constexpr int DW_XS = C_IN * DW_IR * DW_IC;
constexpr int DW_RAW = 2 * C_OUT * DW_RS;  // act and d_n of one stage
constexpr int DW_TB = 10;                 // taps per thread
constexpr int DW_ACC = 8 * DW_TB * NTHREADS;  // the CTA's sums
constexpr size_t DW_SMEM =
    (size_t)(DW_SP * DW_DS + 2 * DW_RAW + 2 * DW_XS + 5 * C_OUT + DW_ACC) *
    sizeof(float);

template <typename T>
__global__ void __launch_bounds__(NTHREADS, 1)
stem_conv_dw_kernel(const float* __restrict__ x, const T* __restrict__ act,
                    const T* __restrict__ dn,
                    const float* __restrict__ coef,
                    float* __restrict__ partials, int B, int H, int W) {
  extern __shared__ __align__(16) float sm[];
  float* das = sm;                        // [DW_SP][DW_DS]
  // [2][act, d_n][C_OUT][DW_RS] of T, in slots sized for float
  T* raw = reinterpret_cast<T*>(das + DW_SP * DW_DS);
  float* xs = das + DW_SP * DW_DS + 2 * DW_RAW;  // [2][C_IN][DW_IR][DW_IC]
  float* cf = xs + 2 * DW_XS;             // [5][C_OUT]
  float* sacc = cf + 5 * C_OUT;           // [8 * DW_TB][NTHREADS]

  const int tid = threadIdx.x, lane = tid & 31;
  const int half = tid >> 7, cg = lane & 7;
  const int tg = ((tid & 127) >> 5) * 4 + (lane >> 3);
  const int Ho = H / 2, Wo = W / 2;
  const bool vec = (Wo & 3) == 0;  // act rows 16-byte aligned
  const int ntx = cdiv(Wo, DW_TW), tiles = cdiv(Ho, DW_TH) * ntx;
  const int total = B * tiles;
  const int n_items =
      (total - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x * DW_NS;

  for (int i = tid; i < 5 * C_OUT; i += NTHREADS) cf[i] = coef[i];
  for (int i = 0; i < 8 * DW_TB; ++i) sacc[i * NTHREADS + tid] = 0.f;
  int off[DW_TB];
#pragma unroll
  for (int k = 0; k < DW_TB; ++k) {
    const int t = DW_TB * tg + k;
    off[k] = t < TAPS ? ((t / KK) * DW_IR + (t % KK) / K) * DW_IC + t % K : 0;
  }

  // item i: stage i % DW_NS of the CTA's tile i / DW_NS; oy0 is the
  // stage's first row
  auto origin = [&](int item, int& b, int& oy0, int& ox0) {
    const int g = (int)blockIdx.x + (item / DW_NS) * (int)gridDim.x;
    b = g / tiles;
    const int tile = g % tiles;
    oy0 = (tile / ntx) * DW_TH + (item % DW_NS) * DW_SR;
    ox0 = (tile % ntx) * DW_TW;
  };
  auto issue = [&](int item) {
    int b, oy0, ox0;
    origin(item, b, oy0, ox0);
    if (item % DW_NS == 0) {
      float* xd = xs + ((item / DW_NS) & 1) * DW_XS;
      const float* xb = x + (size_t)b * C_IN * H * W;
      const int iy0 = 2 * oy0 - 3, ix0 = 2 * ox0 - 3;
      for (int i = tid; i < DW_XS; i += NTHREADS) {
        const int c = i / (DW_IR * DW_IC), rem = i % (DW_IR * DW_IC);
        const int yy = iy0 + rem / DW_IC, xx = ix0 + rem % DW_IC;
        const bool in = yy >= 0 && yy < H && xx >= 0 && xx < W;
        cp_async_f32(xd + i, in ? xb + ((size_t)c * H + yy) * W + xx : xb,
                     in);
      }
    }
    T* rd = raw + (item & 1) * DW_RAW;
    const T* ab = act + (size_t)b * C_OUT * Ho * Wo;
    const T* db = dn + (size_t)b * C_OUT * Ho * Wo;
    // rows (tensor, o, stage row) of 32 positions
    if (vec) {
      for (int e = tid; e < 2 * C_OUT * DW_SR * (DW_TW / 4); e += NTHREADS) {
        const int f = e % (DW_TW / 4), row = e / (DW_TW / 4);
        const int sr = row % DW_SR, to = row / DW_SR;  // to = tensor * 64 + o
        const int oy = oy0 + sr, ox = ox0 + 4 * f;
        const T* src = (to < C_OUT ? ab : db) + (size_t)(to % C_OUT) *
                                                    Ho * Wo;
        const bool in = oy < Ho && ox < Wo;
        cp_async_vec4(rd + to * DW_RS + sr * DW_TW + 4 * f,
                      in ? src + (size_t)oy * Wo + ox : src, in);
      }
    } else {
      for (int e = tid; e < 2 * C_OUT * DW_SP; e += NTHREADS) {
        const int p = e % DW_SP, to = e / DW_SP;
        const int oy = oy0 + p / DW_TW, ox = ox0 + p % DW_TW;
        const T* src = (to < C_OUT ? ab : db) + (size_t)(to % C_OUT) *
                                                    Ho * Wo;
        const bool in = oy < Ho && ox < Wo;
        copy_elem(rd + to * DW_RS + p, in ? src + (size_t)oy * Wo + ox : src,
                  in);
      }
    }
  };

  float tacc[8][DW_TB];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int k = 0; k < DW_TB; ++k) tacc[j][k] = 0.f;

  if (n_items > 0) issue(0);
  cp_async_commit();
  for (int item = 0; item < n_items; ++item) {
    cp_async_wait_all();
    __syncthreads();  // this item's copies landed; the last item's reads done
    if (item + 1 < n_items) issue(item + 1);
    cp_async_commit();

    int b, oy0, ox0;
    origin(item, b, oy0, ox0);
    {
      // d_a: thread = channel o (tid % 64) x groups of 4 positions
      const int o = tid % C_OUT;
      const T* ra = raw + (item & 1) * DW_RAW + o * DW_RS;
      const T* rn = ra + C_OUT * DW_RS;
      const float g1 = cf[o], c1 = cf[C_OUT + o], c2 = cf[2 * C_OUT + o],
                  mu = cf[3 * C_OUT + o], inv = cf[4 * C_OUT + o];
#pragma unroll
      for (int k = 0; k < DW_SP / 4 / (NTHREADS / C_OUT); ++k) {
        const int p0 = 4 * (tid / C_OUT + k * (NTHREADS / C_OUT));
        const float4 a4 = widen4(*reinterpret_cast<const Vec4<T>*>(ra + p0));
        const float4 n4 = widen4(*reinterpret_cast<const Vec4<T>*>(rn + p0));
        const float av[4] = {a4.x, a4.y, a4.z, a4.w};
        const float nv[4] = {n4.x, n4.y, n4.z, n4.w};
        const bool row_in = oy0 + p0 / DW_TW < Ho;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool in = row_in && ox0 + (p0 + j) % DW_TW < Wo;
          das[(p0 + j) * DW_DS + o] =
              in ? round_to<T>(bn_input_cotangent(av[j], nv[j], g1, c1, c2,
                                                  mu, inv))
                 : 0.f;
        }
      }
    }
    __syncthreads();

    const int row = (item % DW_NS) * DW_SR + half;  // row in the tile
    const float* xrow =
        xs + ((item / DW_NS) & 1) * DW_XS + 2 * row * DW_IC;
    const float4* drow =
        reinterpret_cast<const float4*>(das + half * DW_TW * DW_DS);
#pragma unroll 8
    for (int j = 0; j < DW_TW; ++j) {
      const float4 a0 = drow[j * (DW_DS / 4) + cg];
      const float4 a1 = drow[j * (DW_DS / 4) + 8 + cg];
      const float* xp = xrow + 2 * j;
#pragma unroll
      for (int k = 0; k < DW_TB; ++k) {
        const float v = round_to<T>(xp[off[k]]);
        tacc[0][k] = fmaf(a0.x, v, tacc[0][k]);
        tacc[1][k] = fmaf(a0.y, v, tacc[1][k]);
        tacc[2][k] = fmaf(a0.z, v, tacc[2][k]);
        tacc[3][k] = fmaf(a0.w, v, tacc[3][k]);
        tacc[4][k] = fmaf(a1.x, v, tacc[4][k]);
        tacc[5][k] = fmaf(a1.y, v, tacc[5][k]);
        tacc[6][k] = fmaf(a1.z, v, tacc[6][k]);
        tacc[7][k] = fmaf(a1.w, v, tacc[7][k]);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int k = 0; k < DW_TB; ++k) {
        sacc[(j * DW_TB + k) * NTHREADS + tid] += tacc[j][k];
        tacc[j][k] = 0.f;
      }
  }
  float* out =
      partials + ((size_t)blockIdx.x * 2 + half) * C_OUT * TAPS;
#pragma unroll
  for (int k = 0; k < DW_TB; ++k) {
    const int t = DW_TB * tg + k;
    if (t >= TAPS) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int o = (j < 4 ? 0 : 32) + 4 * cg + (j & 3);
      out[o * TAPS + t] = sacc[(j * DW_TB + k) * NTHREADS + tid];
    }
  }
}

// ---------------------------------------------------------------------------
// 5. d_x, as the TPU kernel computes it: by space-to-depth, the input
// gradient's 12 phase planes (3 channels x 2 x 2 parities) at Ho x Wo
// positions are a dense 4 x 4 transposed conv of d_a with the weights
// zero-padded from 7 x 7 to 8 x 8 (ky' = ky + 1 = 2 sy + py):
//   d_x[c, 2u + py, 2v + px] = sum over o, sy, sx of
//       w8[o, c, 2 sy + py, 2 sx + px] d_a[o, u - sy + 2, v - sx + 2].
// Every output has the same 16 taps (147 of the 192 slots are real), so
// the loops unroll with no parity branches.
//
// Tile: 32 x 32 positions (64 x 64 pixels); a CTA walks tiles (image-major)
// with a stride of the grid, one CTA per SM. d_a is staged 8 channels at a
// time on the tile's support, 35 rows of 40 columns (from v0 - 4, so that
// the rows are 16-byte aligned; zero outside the conv output): act and d_n
// by cp.async (16-byte copies where Wo is a multiple of 4) into a double
// buffer, so that the next chunk's copies overlap this chunk's FMAs, and
// d_a formed once per element in place, a float4 at a time. Thread: lane =
// column v, warp w = rows 4 w .. 4 w + 3, all 12 phase outputs: 48
// accumulators. Per channel and tap column sx, 7 d_a values in registers
// feed the 4 taps sy of that column; per tap one broadcast of 12 weights
// (3 float4) feeds 48 FMAs; so 28 scalar and 48 float4 loads feed 768
// FMAs. Each pixel is summed in three levels whose float32 chains are at
// most 16 long: a channel's 16 taps, a pass's 16 channels, the 4 passes.
// Shared: the padded weights as [o][sy][sx][12] (49,152 B) and two chunks
// of act and d_n (179,200 B). The bfloat16 d_x is stem_conv_dx_mma_kernel
// (section 6b).

constexpr int DX_TU = 32, DX_TV = 32;     // positions per tile
constexpr int DX_DR = DX_TU + 3;          // 35 rows of d_a
constexpr int DX_RC = DX_TV + 8;          // 40 columns, from v0 - 4
constexpr int DX_PL = DX_DR * DX_RC;      // 1400 per channel
constexpr int DX_CC = 8;                  // channels per chunk
constexpr int DX_NC = C_OUT / DX_CC;      // 8 chunks per tile
constexpr int DX_PASS = 16 / DX_CC;       // chunks per 16-channel pass
constexpr int DX_RAW = 2 * DX_CC * DX_PL;  // act and d_n of one chunk
constexpr int DX_WS = C_OUT * 16 * 12;    // padded weights
constexpr size_t DX_SMEM =
    (size_t)(DX_WS + 2 * DX_RAW + 5 * C_OUT) * sizeof(float);

template <typename T>
__global__ void __launch_bounds__(NTHREADS, 1)
stem_conv_dx_kernel(const T* __restrict__ act, const T* __restrict__ dn,
                    const float* __restrict__ coef,
                    const float* __restrict__ w, float* __restrict__ dx,
                    int B, int H, int W) {
  extern __shared__ __align__(16) float sm[];
  float* ws = sm;                          // [C_OUT][16][12]
  float* raw = ws + DX_WS;                 // [2][act, d_n][DX_CC][DX_PL]
  float* cf = raw + 2 * DX_RAW;            // [5][C_OUT]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Ho = H / 2, Wo = W / 2;
  const bool vec = (Wo & 3) == 0;  // act rows 16-byte aligned
  const int ntx = cdiv(Wo, DX_TV), tiles = cdiv(Ho, DX_TU) * ntx;
  const int total = B * tiles;
  const int n_items =
      (total - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x * DX_NC;

  for (int i = tid; i < DX_WS; i += NTHREADS) {
    const int o = i / 192, s = (i / 12) % 16, k = i % 12;
    const int c = k / 4, ky = 2 * (s / 4) + (k / 2) % 2 - 1,
              kx = 2 * (s % 4) + k % 2 - 1;
    ws[i] = (ky >= 0 && kx >= 0)
                ? round_to<T>(w[o * TAPS + c * KK + ky * K + kx])
                : 0.f;
  }
  for (int i = tid; i < 5 * C_OUT; i += NTHREADS) cf[i] = coef[i];

  // a chunk's act and d_n as stored ([act, d_n][DX_CC][DX_PL] of T): for
  // float the whole slot (d_a is formed in place over act), for bfloat16
  // its second half
  auto staged = [&](int item) {
    return reinterpret_cast<T*>(raw + (item & 1) * DX_RAW +
                                (sizeof(T) == 4 ? 0 : DX_CC * DX_PL));
  };
  // item i: channel chunk i % DX_NC of the CTA's tile i / DX_NC
  auto origin = [&](int item, int& b, int& u0, int& v0) {
    const int g = (int)blockIdx.x + (item / DX_NC) * (int)gridDim.x;
    b = g / tiles;
    const int tile = g % tiles;
    u0 = (tile / ntx) * DX_TU;
    v0 = (tile % ntx) * DX_TV;
  };
  auto issue = [&](int item) {
    int b, u0, v0;
    origin(item, b, u0, v0);
    const size_t plane0 = (size_t)b * C_OUT + (item % DX_NC) * DX_CC;
    T* rd = staged(item);
    // rows (tensor, channel, lr) of the support
    if (vec) {
      for (int e = tid; e < DX_RAW / 4; e += NTHREADS) {
        const int f = e % (DX_RC / 4), row = e / (DX_RC / 4);
        const int lr = row % DX_DR, tc = row / DX_DR;  // tensor * 8 + chan
        const int oy = u0 - 1 + lr, ox = v0 - 4 + 4 * f;
        const T* src = (tc < DX_CC ? act : dn) +
                       (plane0 + tc % DX_CC) * Ho * Wo;
        const bool in = oy >= 0 && oy < Ho && ox >= 0 && ox < Wo;
        cp_async_vec4(rd + 4 * e, in ? src + (size_t)oy * Wo + ox : src, in);
      }
    } else {
      for (int e = tid; e < DX_RAW; e += NTHREADS) {
        const int col = e % DX_RC, row = e / DX_RC;
        const int lr = row % DX_DR, tc = row / DX_DR;
        const int oy = u0 - 1 + lr, ox = v0 - 4 + col;
        const T* src = (tc < DX_CC ? act : dn) +
                       (plane0 + tc % DX_CC) * Ho * Wo;
        const bool in = oy >= 0 && oy < Ho && ox >= 0 && ox < Wo;
        copy_elem(rd + e, in ? src + (size_t)oy * Wo + ox : src, in);
      }
    }
  };

  float acc[4][12], pacc[4][12];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int k = 0; k < 12; ++k) acc[q][k] = pacc[q][k] = 0.f;

  if (n_items > 0) issue(0);
  cp_async_commit();
  for (int item = 0; item < n_items; ++item) {
    cp_async_wait_all();
    __syncthreads();  // this chunk's copies landed; the last chunk's reads done
    if (item + 1 < n_items) issue(item + 1);
    cp_async_commit();

    int b, u0, v0;
    origin(item, b, u0, v0);
    const int chunk = item % DX_NC, o0 = chunk * DX_CC;
    float* da = raw + (item & 1) * DX_RAW;
    const T* sa = staged(item);
#pragma unroll
    for (int i = 0; i < cdiv(DX_CC * DX_PL / 4, NTHREADS); ++i) {
      const int e = tid + i * NTHREADS;
      if (e >= DX_CC * DX_PL / 4) break;
      const int f = e % (DX_RC / 4), row = e / (DX_RC / 4);
      const int lr = row % DX_DR, o = o0 + row / DX_DR;
      const int oy = u0 - 1 + lr, ox = v0 - 4 + 4 * f;
      const float4 a4 = widen4(reinterpret_cast<const Vec4<T>*>(sa)[e]);
      const float4 n4 =
          widen4(reinterpret_cast<const Vec4<T>*>(sa + DX_CC * DX_PL)[e]);
      const float g1 = cf[o], c1 = cf[C_OUT + o], c2 = cf[2 * C_OUT + o],
                  mu = cf[3 * C_OUT + o], inv = cf[4 * C_OUT + o];
      const float av[4] = {a4.x, a4.y, a4.z, a4.w};
      const float nv[4] = {n4.x, n4.y, n4.z, n4.w};
      const bool row_in = oy >= 0 && oy < Ho;
      float dv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dv[j] = row_in && ox + j >= 0 && ox + j < Wo
                    ? round_to<T>(bn_input_cotangent(av[j], nv[j], g1, c1,
                                                     c2, mu, inv))
                    : 0.f;
      reinterpret_cast<float4*>(da)[e] = make_float4(dv[0], dv[1], dv[2],
                                                     dv[3]);
    }
    __syncthreads();

    for (int oc = 0; oc < DX_CC; ++oc) {
      // local column of d_a for position v, tap sx: lane + 6 - sx
      const float* dch = da + oc * DX_PL + 4 * warp * DX_RC + lane + 6;
      const float4* wch =
          reinterpret_cast<const float4*>(ws) + (o0 + oc) * 48;
      float cacc[4][12];  // one channel's taps
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int k = 0; k < 12; ++k) cacc[q][k] = 0.f;
#pragma unroll
      for (int sx = 0; sx < 4; ++sx) {
        float d[7];
#pragma unroll
        for (int r = 0; r < 7; ++r) d[r] = dch[r * DX_RC - sx];
#pragma unroll
        for (int sy = 0; sy < 4; ++sy) {
          const float4 w0 = wch[(sy * 4 + sx) * 3 + 0];
          const float4 w1 = wch[(sy * 4 + sx) * 3 + 1];
          const float4 w2 = wch[(sy * 4 + sx) * 3 + 2];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float v = d[q - sy + 3];
            cacc[q][0] = fmaf(v, w0.x, cacc[q][0]);
            cacc[q][1] = fmaf(v, w0.y, cacc[q][1]);
            cacc[q][2] = fmaf(v, w0.z, cacc[q][2]);
            cacc[q][3] = fmaf(v, w0.w, cacc[q][3]);
            cacc[q][4] = fmaf(v, w1.x, cacc[q][4]);
            cacc[q][5] = fmaf(v, w1.y, cacc[q][5]);
            cacc[q][6] = fmaf(v, w1.z, cacc[q][6]);
            cacc[q][7] = fmaf(v, w1.w, cacc[q][7]);
            cacc[q][8] = fmaf(v, w2.x, cacc[q][8]);
            cacc[q][9] = fmaf(v, w2.y, cacc[q][9]);
            cacc[q][10] = fmaf(v, w2.z, cacc[q][10]);
            cacc[q][11] = fmaf(v, w2.w, cacc[q][11]);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int k = 0; k < 12; ++k) pacc[q][k] += cacc[q][k];
    }
    if (chunk % DX_PASS == DX_PASS - 1) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int k = 0; k < 12; ++k) {
          acc[q][k] += pacc[q][k];
          pacc[q][k] = 0.f;
        }
    }
    if (chunk == DX_NC - 1) {
      const int v = v0 + lane;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int u = u0 + 4 * warp + q;
        if (u < Ho && v < Wo) {
#pragma unroll
          for (int c = 0; c < C_IN; ++c)
#pragma unroll
            for (int py = 0; py < 2; ++py)
              *reinterpret_cast<float2*>(
                  dx + (((size_t)b * C_IN + c) * H + 2 * u + py) * W +
                  2 * v) = make_float2(acc[q][4 * c + 2 * py],
                                       acc[q][4 * c + 2 * py + 1]);
        }
#pragma unroll
        for (int k = 0; k < 12; ++k) acc[q][k] = 0.f;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 6. The bfloat16 forms of their own: dW (6a), d_x (6b) and the conv
// forward (6c) on tensor cores, replacing the <bf16> instances of
// sections 4, 5 and 1, and BN-pool as a strip walk (6d), replacing that of
// section 2. The convolutions contract bfloat16 operands (d_a with x or w,
// w with x) and sum in float32, which is what Hopper's bf16 tensor cores
// compute: mma.sync.m16n8k16 (bf16 operands, float32 accumulators), fed
// by ldmatrix from shared memory. (wgmma would need 64-row tiles of one
// operand in its canonical shared layout; the im2col operands of dW and
// of the conv forward are built per lane from words of the staged input,
// which mma.sync takes from registers, and at these sizes the tensor
// cores are not the limit.)
//
// dW and d_x are each bound by bytes (act and d_n, 4 bytes an element, 0.38 ms
// at B = 256, 256x256); the MMAs need about a fifth of that. What the
// design spends instead: forming d_a (about 10 float32 operations an
// element, rounded as the float32 kernels round) and shared-memory
// wavefronts, so operands are laid out for conflict-free ldmatrix and
// 32-bit loads, and each staged element is formed once, into one of two
// buffers while the other feeds the MMAs (one barrier a stage). Measured
// on an H100 at B = 256 (PERF.md), they run at 3 to 3.5 times that bound,
// latency-bound with one CTA of 8 or 16 warps per SM: taking out the BN
// arithmetic saves 0.06 ms, the MMAs 0.23, the adds that wait on the MMAs
// 0.27 in dW (tools/stem_bf16_variants.py).
//
// The tensor core truncates (section 6a), so MMA chains are bounded and
// added into float32 sums with plain adds in levels, as the float32
// kernels' FMA chains are (section 4, section 5): dW takes a fresh
// accumulator every k16 step (16 positions; chained over a stage's four,
// dW read 2.90 times the plain version's distance from float64 at B = 32
// on the ISP's outputs, whose products share a sign), d_x chains the four
// taps of a column (section 6b; tools/stem_bf16_variants.py). Partials
// per CTA in a fixed order and no atomics, so two launches are bitwise
// equal.

// Four 8x8 b16 matrices from shared memory: lanes 8q .. 8q + 7 give the
// row addresses (16 bytes each) of matrix q, which lands in register q.
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p))));
}

// d = a b: a 16x16 bf16 (row-major), b 16x8 bf16 (column-major), d 16x8
// float32, a fresh accumulator. Lane (g = lane / 4, t = lane % 4) holds
// a's rows g, g + 8 at columns 2t, 2t + 1 (registers 0, 1) and 2t + 8,
// 2t + 9 (2, 3); b's column g at rows 2t, 2t + 1 (b0) and 2t + 8, 2t + 9
// (b1); d's rows g (d[0], d[1]) and g + 8 (d[2], d[3]) at columns 2t,
// 2t + 1.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

// d = a b rounded to nearest: the tensor core truncates its sum toward
// zero (section 6a), so the same product is taken again with half an ulp
// of the first result, signed, as the accumulator. Where the sum cancels
// below the largest product by more than a binade, that half ulp falls
// under the alignment and the first result stands.
__device__ __forceinline__ void mma_bf16_nearest(float (&d)[4],
                                                 const unsigned (&a)[4],
                                                 unsigned b0, unsigned b1) {
  float t[4], h[4];
  mma_bf16(t, a, b0, b1);
#pragma unroll
  for (int q = 0; q < 4; ++q)  // sign and exponent of t, times 2^-24
    h[q] = __uint_as_float(__float_as_uint(t[q]) & 0xff800000u) * 0x1p-24f;
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(h[0]), "f"(h[1]), "f"(h[2]), "f"(h[3]));
}

// d += a b: the same product into a live accumulator (one rounding toward
// zero per step, section 6a).
__device__ __forceinline__ void mma_bf16_acc(float (&d)[4],
                                             const unsigned (&a)[4],
                                             unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// s += d, or s = d for the first term of a sum.
__device__ __forceinline__ void add4(float (&s)[4], const float (&d)[4],
                                     bool first) {
#pragma unroll
  for (int q = 0; q < 4; ++q) s[q] = first ? d[q] : s[q] + d[q];
}

// Two floats rounded to bfloat16 (to nearest even) in one word, lo first.
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// 6a. dW: dW[o, (c, ky, kx)] = sum over positions p of d_a[o, p] x[c, 2u +
// ky - 3, 2v + kx - 3], an MMA with the 64 channels as M (four 16-row
// tiles), the positions as K and the taps as N: one 8-wide tile per (c,
// ky), kx = 0..7 (kx = 7 is padding, computed and never written), 21 tiles.
// Tile: 16 x 32 positions, walked as in section 4 (persistent grid, one CTA
// per SM), staged two rows (64 positions, four k16 steps) at a time: act and
// d_n by 16-byte cp.async (where Wo is a multiple of 8) into a ring of
// DWM_NB stages, the tile's input with its halo, 3 x 37 x 72, by 4-byte
// cp.async with the tile's first stage. A: d_a formed once per element as
// [channel][position] bf16 rows of 144 bytes (ldmatrix rows 36 words apart:
// conflict-free). B: at the tile's first stage the input, rounded to
// bfloat16, becomes pair words P[c][row][s] = (x[s], x[s + 2]); the B
// fragment of tap tile (c, ky) at positions v0 .. v0 + 15 of output row u is
// then P[c][2u + ky][2 v0 + 4 t + g] and the word 16 further, one 32-bit
// load each, 20 consecutive words a warp: conflict-free, no im2col. Warp:
// 32 channels (warp % 2) x the tap tiles warp / 2 + 4 j (6 or 5 of them):
// 12 or 10 MMAs per k16 step from 2 ldmatrix and 12 or 10 32-bit loads.
// Software pipeline, one barrier a stage: each thread forms the next
// stage's d_a (and, at a tile's last stage, the next tile's pair words)
// into the other of two buffers before it runs this stage's MMAs, so that
// the formation's float32 work fills the MMAs' latency. Sums in two
// levels, plain float32 adds: the k16 steps of a stage, then the stages of
// the walk, written once per CTA.
//
// The tensor core truncates: a k16 step's products are aligned to the
// largest and cut 25 bits below it, and the sum is rounded toward zero
// (measured on an H100: 1 + 0.75 ulp gives 1, -1 - 0.75 ulp gives -1, 1 +
// 15 x 2^-26 gives 1). Over many steps of both signs that averages out
// below the float32 adds' error; in a dW of few positions (at most
// DWM_NEAREST, B = 1 at 4 x 8 has 8) each output is a handful of steps, and
// the truncation alone would put it twice as far from float64 as the
// plain version's rounded sums. There (kNearest) each step is rounded to
// nearest by a second MMA (mma_bf16_nearest).

constexpr int DWM_NB = 4;                    // stages in flight, >= 3
constexpr int DWM_RAW = 2 * C_OUT * DW_SP;   // act and d_n of a stage
constexpr int DWM_DS = DW_SP + 8;            // d_a row stride, 144 bytes
constexpr int DWM_DA = C_OUT * DWM_DS;       // d_a of a stage
constexpr int DWM_IC = 2 * DW_TW + 8;        // 72 staged input columns
constexpr int DWM_XS = C_IN * DW_IR * DWM_IC;
constexpr int DWM_PW = 2 * DW_TW + 4;        // 68 pair words per input row
constexpr int DWM_P = C_IN * DW_IR * DWM_PW;
constexpr int DWM_NT = C_IN * K;             // 21 tap tiles (c, ky)
constexpr int DWM_WNT = cdiv(DWM_NT, 4);     // at most 6 of them a warp
constexpr int DWM_NEAREST = 4096;            // positions of a short dW
constexpr size_t DWM_SMEM =
    (size_t)(DWM_NB * DWM_RAW + 2 * DWM_DA) * sizeof(bf16) +
    (size_t)(DWM_XS + 2 * DWM_P + 5 * C_OUT) * sizeof(float);

template <bool kNearest>
__global__ void __launch_bounds__(NTHREADS, 1)
stem_conv_dw_mma_kernel(const float* __restrict__ x,
                        const bf16* __restrict__ act,
                        const bf16* __restrict__ dn,
                        const float* __restrict__ coef,
                        float* __restrict__ partials, int B, int H, int W,
                        int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* raw = reinterpret_cast<bf16*>(smem);  // [NB][act, d_n][64][64]
  bf16* das = raw + DWM_NB * DWM_RAW;         // [2][64][DWM_DS]
  float* xs = reinterpret_cast<float*>(das + 2 * DWM_DA);  // [3][37][72]
  unsigned* pw = reinterpret_cast<unsigned*>(xs + DWM_XS);  // [2][3][37][68]
  float* cf = reinterpret_cast<float*>(pw + 2 * DWM_P);     // [5][64]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int mh = warp & 1, ng = warp >> 1;
  const int nnt = (DWM_NT - ng + 3) / 4;  // the warp's tap tiles
  const int Ho = H / 2, Wo = W / 2;
  const int ntx = cdiv(Wo, DW_TW), tiles = cdiv(Ho, DW_TH) * ntx;
  const int total = B * tiles;
  const int n_items =
      (total - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x * DW_NS;

  for (int i = tid; i < 5 * C_OUT; i += NTHREADS) cf[i] = coef[i];
  // this lane's word of tap tile j's first pair row
  int prow[DWM_WNT];
#pragma unroll
  for (int j = 0; j < DWM_WNT; ++j) {
    const int nt = ng + 4 * j;
    prow[j] = nt < DWM_NT
                  ? ((nt / K) * DW_IR + nt % K) * DWM_PW + 4 * t4 + g
                  : 0;
  }

  // item i: stage i % DW_NS of the CTA's tile i / DW_NS; oy0 is the
  // stage's first row
  auto origin = [&](int item, int& b, int& oy0, int& ox0) {
    const int gt = (int)blockIdx.x + (item / DW_NS) * (int)gridDim.x;
    b = gt / tiles;
    const int tile = gt % tiles;
    oy0 = (tile / ntx) * DW_TH + (item % DW_NS) * DW_SR;
    ox0 = (tile % ntx) * DW_TW;
  };
  // The input halo has one buffer: a tile's pair words are formed (with
  // its first stage's d_a) before the next tile's input is issued,
  // DW_NS - DWM_NB + 1 stages later.
  auto issue = [&](int item) {
    int b, oy0, ox0;
    origin(item, b, oy0, ox0);
    if (item % DW_NS == 0) {
      const float* xb = x + (size_t)b * C_IN * H * W;
      const int iy0 = 2 * oy0 - 3, ix0 = 2 * ox0 - 3;
      for (int i = tid; i < DWM_XS; i += NTHREADS) {
        const int c = i / (DW_IR * DWM_IC), rem = i % (DW_IR * DWM_IC);
        const int yy = iy0 + rem / DWM_IC, xx = ix0 + rem % DWM_IC;
        const bool in = yy >= 0 && yy < H && xx >= 0 && xx < W;
        cp_async_f32(xs + i, in ? xb + ((size_t)c * H + yy) * W + xx : xb,
                     in);
      }
    }
    bf16* rd = raw + (item % DWM_NB) * DWM_RAW;
    const bf16* ab = act + (size_t)b * C_OUT * Ho * Wo;
    const bf16* db = dn + (size_t)b * C_OUT * Ho * Wo;
    // rows (tensor, o, stage row) of 32 positions
    if (vec) {
      for (int e = tid; e < DWM_RAW / 8; e += NTHREADS) {
        const int f = e % (DW_TW / 8), row = e / (DW_TW / 8);
        const int sr = row % DW_SR, to = row / DW_SR;  // to = tensor * 64 + o
        const int oy = oy0 + sr, ox = ox0 + 8 * f;
        const bf16* src = (to < C_OUT ? ab : db) + (size_t)(to % C_OUT) *
                                                       Ho * Wo;
        const bool in = oy < Ho && ox < Wo;
        cp_async_n<16>(rd + 8 * e, in ? src + (size_t)oy * Wo + ox : src, in);
      }
    } else {
      for (int e = tid; e < DWM_RAW; e += NTHREADS) {
        const int p = e % DW_SP, to = e / DW_SP;
        const int oy = oy0 + p / DW_TW, ox = ox0 + p % DW_TW;
        const bf16* src = (to < C_OUT ? ab : db) + (size_t)(to % C_OUT) *
                                                       Ho * Wo;
        const bool in = oy < Ho && ox < Wo;
        copy_elem(rd + e, in ? src + (size_t)oy * Wo + ox : src, in);
      }
    }
  };
  // d_a of an item into das[item % 2]: thread = channel o x 8 positions
  // (lanes 8k .. 8k + 7 read and write 128 consecutive bytes); at a tile's
  // first stage also its pair words into pw[tile % 2]
  auto form = [&](int item) {
    int b, oy0, ox0;
    origin(item, b, oy0, ox0);
    const bf16* rb = raw + (item % DWM_NB) * DWM_RAW;
    bf16* dd = das + (item & 1) * DWM_DA;
#pragma unroll
    for (int k = 0; k < C_OUT * DW_SP / 8 / NTHREADS; ++k) {
      const int e = tid + k * NTHREADS;
      const int o = e / (DW_SP / 8), p0 = 8 * (e % (DW_SP / 8));
      const uint4 qa = *reinterpret_cast<const uint4*>(rb + o * DW_SP + p0);
      const uint4 qn =
          *reinterpret_cast<const uint4*>(rb + (C_OUT + o) * DW_SP + p0);
      const __nv_bfloat162* ha = reinterpret_cast<const __nv_bfloat162*>(&qa);
      const __nv_bfloat162* hn = reinterpret_cast<const __nv_bfloat162*>(&qn);
      const float g1 = cf[o], c1 = cf[C_OUT + o], c2 = cf[2 * C_OUT + o],
                  mu = cf[3 * C_OUT + o], inv = cf[4 * C_OUT + o];
      const int oy = oy0 + p0 / DW_TW, ox = ox0 + p0 % DW_TW;
      uint4 out;
      unsigned* po = reinterpret_cast<unsigned*>(&out);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 a2 = __bfloat1622float2(ha[j]);
        const float2 n2 = __bfloat1622float2(hn[j]);
        const bool in0 = oy < Ho && ox + 2 * j < Wo;
        const bool in1 = oy < Ho && ox + 2 * j + 1 < Wo;
        po[j] = pack_bf16(
            in0 ? bn_input_cotangent(a2.x, n2.x, g1, c1, c2, mu, inv) : 0.f,
            in1 ? bn_input_cotangent(a2.y, n2.y, g1, c1, c2, mu, inv) : 0.f);
      }
      *reinterpret_cast<uint4*>(dd + o * DWM_DS + p0) = out;
    }
    if (item % DW_NS == 0) {
      unsigned* pt = pw + ((item / DW_NS) & 1) * DWM_P;
      for (int i = tid; i < DWM_P; i += NTHREADS) {
        const float* xr = xs + (i / DWM_PW) * DWM_IC + i % DWM_PW;
        pt[i] = pack_bf16(xr[0], xr[2]);
      }
    }
  };

  float st[2][DWM_WNT][4], run[2][DWM_WNT][4];  // sums of a stage, the walk
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < DWM_WNT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) run[mi][j][q] = 0.f;

#pragma unroll
  for (int i = 0; i < DWM_NB - 1; ++i) {
    if (i < n_items) issue(i);
    cp_async_commit();
  }
  cp_async_wait<DWM_NB - 2>();
  __syncthreads();  // the first stage's copies landed
  if (n_items > 0) form(0);
  for (int item = 0; item < n_items; ++item) {
    // the next stage's copies landed; this stage's d_a and pair words
    // formed; the last stage's MMAs done with the buffers formed next
    cp_async_wait<DWM_NB - 3>();
    __syncthreads();
    if (item + DWM_NB - 1 < n_items) issue(item + DWM_NB - 1);
    cp_async_commit();
    if (item + 1 < n_items) form(item + 1);

    const int stage = item % DW_NS;
    const bf16* dd = das + (item & 1) * DWM_DA;
    const unsigned* pt = pw + ((item / DW_NS) & 1) * DWM_P;
#pragma unroll
    for (int ks = 0; ks < DW_SP / 16; ++ks) {
      const int sr = ks / (DW_TW / 16), v0 = 16 * (ks % (DW_TW / 16));
      unsigned a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldsm_x4(a[mi], dd + (32 * mh + 16 * mi + (lane & 15)) * DWM_DS +
                           16 * ks + 8 * (lane >> 4));
      // input row 2 u + ky of output row u = DW_SR stage + sr of the tile
      const unsigned* pk = pt + 2 * (DW_SR * stage + sr) * DWM_PW + 2 * v0;
#pragma unroll
      for (int j = 0; j < DWM_WNT; ++j)
        if (j < nnt) {
          const unsigned b0 = pk[prow[j]], b1 = pk[prow[j] + 16];
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            float d[4];
            if (kNearest)
              mma_bf16_nearest(d, a[mi], b0, b1);
            else
              mma_bf16(d, a[mi], b0, b1);
            add4(st[mi][j], d, ks == 0);
          }
        }
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int j = 0; j < DWM_WNT; ++j)
        if (j < nnt) add4(run[mi][j], st[mi][j], false);
  }
  float* out = partials + (size_t)blockIdx.x * C_OUT * TAPS;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < DWM_WNT; ++j) {
      if (j >= nnt) continue;
      const int nt = ng + 4 * j, t0 = (nt / K) * KK + (nt % K) * K;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int o = 32 * mh + 16 * mi + g + 8 * (q >> 1),
                  kx = 2 * t4 + (q & 1);
        if (kx < K) out[o * TAPS + t0 + kx] = run[mi][j][q];
      }
    }
}

// 6b. d_x, in the space-to-depth form of section 5: per output position
// (u, v) the 12 phase values (c, py, px) are sum over taps (sy, sx) and
// channels o of w8[o, c, 2 sy + py, 2 sx + px] d_a[o, u - sy + 2, v - sx +
// 2], an MMA with the positions as M, the 12 phases padded to 16 as N (two
// 8-wide tiles) and (tap, channel) as K = 16 x 64 (147 of the 192 tap
// slots real). Tile: 16 x 32 positions, walked as in section 5, in four
// chunks of 16 channels (one k16 step a tap): act and d_n on the tile's
// support (19 rows from u0 - 1, 48 columns from v0 - 8) by 16-byte cp.async
// (where Wo is a multiple of 8) into a double buffer; d_a formed once per
// element into a channel-last [row][column][16] bf16 block (36 columns from
// v0 - 2, zero outside the conv output), whose two 8-channel halves swap
// places every 4 columns: the 16 positions x 16 channels of a tap are one
// ldmatrix at a shifted row address (implicit GEMM), 8 consecutive columns
// on 8 distinct 16-byte slots. B: the padded weights, rounded to bfloat16,
// staged once per CTA as [tap][phase][64 channels] (32 KB), 8-channel
// blocks swizzled by phase: one ldmatrix gives both phase tiles. Warp: one
// tile row, two 16-position halves: per tap 3 ldmatrix feed 4 MMAs.
// Software pipeline as in section 6a: the next chunk's d_a is formed into
// the other of two blocks before this chunk's MMAs, one barrier a chunk.
// Sums: the four taps sy of a tap column sx chained in the tensor core (64
// products), then the 16 columns of the 4 chunks with plain float32 adds,
// written after the fourth chunk. Every d_x sums 64 k16 steps at any shape
// and its taps mix signs, so the truncation averages out: chained, d_x
// read at most 1.41 times the plain version's distance from float64 at
// the shapes of tools/stem_bf16_variants.py (1.35 with a fresh accumulator
// a step), and the chain saves the adds that wait on each MMA (0.13 ms at
// B = 256).

constexpr int DXM_THREADS = 512;                // 16 warps, a tile row each
constexpr int DXM_TU = 16, DXM_TV = 32;         // positions per tile
constexpr int DXM_CC = 16;                      // channels per chunk
constexpr int DXM_NC = C_OUT / DXM_CC;          // 4 chunks per tile
constexpr int DXM_DR = DXM_TU + 3;              // 19 rows, from u0 - 1
constexpr int DXM_DC = DXM_TV + 4;              // 36 columns, from v0 - 2
constexpr int DXM_RC = DXM_TV + 16;             // 48 staged, from v0 - 8
constexpr int DXM_PL = DXM_DR * DXM_RC;         // a staged channel
constexpr int DXM_RAW = 2 * DXM_CC * DXM_PL;    // act and d_n of a chunk
constexpr int DXM_D = DXM_DR * DXM_DC * DXM_CC;  // d_a of a chunk
constexpr int DXM_WS = 16 * 16 * C_OUT;         // [tap][phase][channel]
constexpr size_t DXM_SMEM =
    (size_t)(2 * DXM_RAW + 2 * DXM_D + DXM_WS) * sizeof(bf16) +
    (size_t)5 * C_OUT * sizeof(float);

__global__ void __launch_bounds__(DXM_THREADS, 1)
stem_conv_dx_mma_kernel(const bf16* __restrict__ act,
                        const bf16* __restrict__ dn,
                        const float* __restrict__ coef,
                        const float* __restrict__ w, float* __restrict__ dx,
                        int B, int H, int W, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* raw = reinterpret_cast<bf16*>(smem);  // [2][act, d_n][16][19][48]
  bf16* da = raw + 2 * DXM_RAW;               // [2][19][36][16]
  bf16* ws = da + 2 * DXM_D;                  // [16][16][64]
  float* cf = reinterpret_cast<float*>(ws + DXM_WS);  // [5][64]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int Ho = H / 2, Wo = W / 2;
  const int ntx = cdiv(Wo, DXM_TV), tiles = cdiv(Ho, DXM_TU) * ntx;
  const int total = B * tiles;
  const int n_items =
      (total - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x *
      DXM_NC;

  for (int i = tid; i < DXM_WS; i += DXM_THREADS) {
    const int tap = i / (16 * C_OUT), n = (i / C_OUT) % 16, o = i % C_OUT;
    const int c = n / 4, ky = 2 * (tap / 4) + (n / 2) % 2 - 1,
              kx = 2 * (tap % 4) + n % 2 - 1;
    const float v = c < C_IN && ky >= 0 && kx >= 0
                        ? w[o * TAPS + c * KK + ky * K + kx]
                        : 0.f;
    ws[(tap * 16 + n) * C_OUT + ((o / 8) ^ (n & 7)) * 8 + o % 8] =
        __float2bfloat16_rn(v);
  }
  for (int i = tid; i < 5 * C_OUT; i += DXM_THREADS) cf[i] = coef[i];

  // item i: channel chunk i % DXM_NC of the CTA's tile i / DXM_NC
  auto origin = [&](int item, int& b, int& u0, int& v0) {
    const int gt = (int)blockIdx.x + (item / DXM_NC) * (int)gridDim.x;
    b = gt / tiles;
    const int tile = gt % tiles;
    u0 = (tile / ntx) * DXM_TU;
    v0 = (tile % ntx) * DXM_TV;
  };
  auto issue = [&](int item) {
    int b, u0, v0;
    origin(item, b, u0, v0);
    const size_t plane0 = (size_t)b * C_OUT + (item % DXM_NC) * DXM_CC;
    bf16* rd = raw + (item & 1) * DXM_RAW;
    // rows (tensor, channel, lr) of the support
    if (vec) {
      for (int e = tid; e < DXM_RAW / 8; e += DXM_THREADS) {
        const int f = e % (DXM_RC / 8), row = e / (DXM_RC / 8);
        const int lr = row % DXM_DR, tc = row / DXM_DR;  // tensor * 16 + ch
        const int oy = u0 - 1 + lr, ox = v0 - 8 + 8 * f;
        const bf16* src = (tc < DXM_CC ? act : dn) +
                          (plane0 + tc % DXM_CC) * Ho * Wo;
        const bool in = oy >= 0 && oy < Ho && ox >= 0 && ox < Wo;
        cp_async_n<16>(rd + 8 * e, in ? src + (size_t)oy * Wo + ox : src,
                       in);
      }
    } else {
      for (int e = tid; e < DXM_RAW; e += DXM_THREADS) {
        const int col = e % DXM_RC, row = e / DXM_RC;
        const int lr = row % DXM_DR, tc = row / DXM_DR;
        const int oy = u0 - 1 + lr, ox = v0 - 8 + col;
        const bf16* src = (tc < DXM_CC ? act : dn) +
                          (plane0 + tc % DXM_CC) * Ho * Wo;
        const bool in = oy >= 0 && oy < Ho && ox >= 0 && ox < Wo;
        copy_elem(rd + e, in ? src + (size_t)oy * Wo + ox : src, in);
      }
    }
  };

  float run[2][2][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nh = 0; nh < 2; ++nh)
#pragma unroll
      for (int q = 0; q < 4; ++q) run[mi][nh][q] = 0.f;
  // this lane's ldmatrix rows: B phase bn, channels 8 kh .. of the chunk
  const int bn = (lane & 7) + 8 * (lane >> 4), kh = (lane >> 3) & 1;

  // d_a of a chunk into da[item % 2], channel-last: thread = 8 channels
  // (half j, fixed: the stride is even) x 2 columns; reads channel pairs
  // of act and d_n, writes two 16-byte rows of the block
  auto form = [&](int item) {
    int b, u0, v0;
    origin(item, b, u0, v0);
    const int o0 = (item % DXM_NC) * DXM_CC;
    const bf16* sa = raw + (item & 1) * DXM_RAW;
    bf16* dd = da + (item & 1) * DXM_D;
    const int j = tid & 1;
    float g1[8], c1[8], c2[8], mu[8], inv[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int o = o0 + 8 * j + q;
      g1[q] = cf[o];
      c1[q] = cf[C_OUT + o];
      c2[q] = cf[2 * C_OUT + o];
      mu[q] = cf[3 * C_OUT + o];
      inv[q] = cf[4 * C_OUT + o];
    }
    for (int e = tid; e < DXM_DR * DXM_DC; e += DXM_THREADS) {
      const int cp = (e >> 1) % (DXM_DC / 2), r = (e >> 1) / (DXM_DC / 2);
      const int col = 2 * cp;
      const int oy = u0 - 1 + r, ox = v0 - 2 + col;
      const bool row_in = oy >= 0 && oy < Ho;
      const bool in0 = row_in && ox >= 0 && ox < Wo;
      const bool in1 = row_in && ox + 1 >= 0 && ox + 1 < Wo;
      // staged column of ox: col + 6
      const bf16* pa = sa + (8 * j * DXM_DR + r) * DXM_RC + col + 6;
      unsigned w0[4], w1[4];
#pragma unroll
      for (int q = 0; q < 8; q += 2) {
        float d0[2], d1[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const bf16* pq = pa + (q + h) * DXM_PL;
          const float2 a2 =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(pq));
          const float2 n2 = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(pq + DXM_CC * DXM_PL));
          d0[h] = in0 ? bn_input_cotangent(a2.x, n2.x, g1[q + h], c1[q + h],
                                           c2[q + h], mu[q + h], inv[q + h])
                      : 0.f;
          d1[h] = in1 ? bn_input_cotangent(a2.y, n2.y, g1[q + h], c1[q + h],
                                           c2[q + h], mu[q + h], inv[q + h])
                      : 0.f;
        }
        w0[q / 2] = pack_bf16(d0[0], d0[1]);
        w1[q / 2] = pack_bf16(d1[0], d1[1]);
      }
      *reinterpret_cast<uint4*>(
          dd + (r * DXM_DC + col) * DXM_CC + 8 * (j ^ ((col >> 2) & 1))) =
          make_uint4(w0[0], w0[1], w0[2], w0[3]);
      *reinterpret_cast<uint4*>(
          dd + (r * DXM_DC + col + 1) * DXM_CC +
          8 * (j ^ (((col + 1) >> 2) & 1))) =
          make_uint4(w1[0], w1[1], w1[2], w1[3]);
    }
  };

  if (n_items > 0) issue(0);
  cp_async_commit();
  if (n_items > 1) issue(1);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();  // the first chunk's copies landed
  if (n_items > 0) form(0);
  for (int item = 0; item < n_items; ++item) {
    // the next chunk's copies landed; this chunk's d_a formed; the last
    // chunk's MMAs done with the buffer formed next
    cp_async_wait_all();
    __syncthreads();
    if (item + 2 < n_items) issue(item + 2);
    cp_async_commit();
    if (item + 1 < n_items) form(item + 1);

    int b, u0, v0;
    origin(item, b, u0, v0);
    const int chunk = item % DXM_NC;
    const bf16* dcur = da + (item & 1) * DXM_D;
    const bf16* wl = ws + bn * C_OUT + ((2 * chunk + kh) ^ (bn & 7)) * 8;
#pragma unroll
    for (int sx = 0; sx < 4; ++sx) {
      float acc[2][2][4];
#pragma unroll
      for (int sy = 0; sy < 4; ++sy) {
        unsigned bq[4];
        ldsm_x4(bq, wl + (sy * 4 + sx) * 16 * C_OUT);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          // tile row warp, positions 16 mi .. 16 mi + 15
          const int col = 16 * mi + (lane & 15) + 4 - sx;
          const int r = warp + 3 - sy;
          unsigned a[4];
          ldsm_x4(a, dcur + (r * DXM_DC + col) * DXM_CC +
                         8 * ((lane >> 4) ^ ((col >> 2) & 1)));
          if (sy == 0) {
            mma_bf16(acc[mi][0], a, bq[0], bq[1]);
            mma_bf16(acc[mi][1], a, bq[2], bq[3]);
          } else {
            mma_bf16_acc(acc[mi][0], a, bq[0], bq[1]);
            mma_bf16_acc(acc[mi][1], a, bq[2], bq[3]);
          }
        }
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int nh = 0; nh < 2; ++nh)
#pragma unroll
          for (int q = 0; q < 4; ++q) run[mi][nh][q] += acc[mi][nh][q];
    }
    if (chunk == DXM_NC - 1) {
      // phase n = 4 c + 2 py + px: lane's columns 2 t4, 2 t4 + 1 are (c,
      // py) = (t4 / 2, t4 % 2) in the first tile, (2, t4) in the second
      // (t4 < 2; the rest padding), px = 0, 1
      const int u = u0 + warp;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int v = v0 + 16 * mi + g + 8 * hh;
          if (u < Ho && v < Wo) {
            float* d0 = dx + (((size_t)b * C_IN + t4 / 2) * H + 2 * u +
                              t4 % 2) * W + 2 * v;
            *reinterpret_cast<float2*>(d0) =
                make_float2(run[mi][0][2 * hh], run[mi][0][2 * hh + 1]);
            if (t4 < 2) {
              float* d1 = dx + (((size_t)b * C_IN + 2) * H + 2 * u + t4) *
                                   W + 2 * v;
              *reinterpret_cast<float2*>(d1) =
                  make_float2(run[mi][1][2 * hh], run[mi][1][2 * hh + 1]);
            }
          }
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          run[mi][0][q] = 0.f;
          run[mi][1][q] = 0.f;
        }
      }
    }
  }
}

// 6c. The bfloat16 conv forward: act[o, p] = sum over taps k of w[o, k]
// patch[k, p], an MMA with the 64 channels as M (four 16-row tiles), the
// positions as N (8-wide tiles along an output row) and the taps as K in
// rows of 8 per (c, ky), kx = 0..7 (kx = 7 padding): 21 rows, 11 k16 steps,
// the last half zero (147 of the 176 slots real). Tile: 8 x 32 positions,
// walked as in section 1 by a persistent grid of CFM_CTAS CTAs per SM (at
// most 128 registers a thread: so that one CTA's epilogue and copies
// overlap the other's MMAs; two read 0.47 ms against one's 0.57 at B =
// 256, tools/stem_bf16_fwd_variants.py); warp w takes
// output row w of the tile, all 64 channels x 4 position tiles: 16 MMAs a
// k16 step from 4 ldmatrix (A, the weights) and 8 32-bit loads (B). A:
// the weights rounded to bfloat16, staged once per CTA as [channel][k]
// rows of 368 bytes (ldmatrix rows 92 words apart: conflict-free). B: the
// tile's input with its halo, 3 x 21 x 72 floats from column 2 ox0 - 4,
// comes by 16-byte cp.async (4-byte where x is not 16-byte aligned) into a
// double buffer, and is rounded into words (x[s], x[s + 1]) at odd
// offsets s = 2 ox0 - 3 + 2 m; lane (g, t)'s b0 of position tile n is taps
// kx = 2t, 2t + 1 of one (c, ky) at output column 8 n + g, input columns
// 2 (8 n + g + t) - 3 and the next: word 8 n + g + t of input row 2 u + ky,
// one 32-bit load, 11 distinct words a warp (conflict-free, no im2col).
// The hi half of t = 3's words (kx = 7) is masked, so that a non-finite
// input outside a tap's reach cannot reach act through a zero weight.
// Pipeline, one barrier a tile: the next tile's input is rounded into the
// other word buffer and the tile after it is issued before this tile's
// MMAs. Epilogue: the fragment holds channels g, g + 8 of each 16-row tile
// at positions 2t, 2t + 1: act rounded to bfloat16 into the warp's rows of
// shared memory, then written out as 16-byte chunks, 64 bytes of a
// channel's row a quad (one word a store straight from the fragment where
// Wo is not a multiple of 8; the word stores took 0.18 of 0.58 ms at B =
// 256, the variants tool's no_store); the statistics from
// the float32 accumulators over the warp's positions, summed across the
// quad by a fixed butterfly, lane t keeping row tile t's two channels in
// float64 over the walk; the CTA sums its 8 warps in order into
// partials[cta]. (wgmma would take the 64 channels as one M tile, but its
// B operand is an im2col tile in shared memory in the canonical layout:
// the taps of a position are not the words of any staged row.)
//
// Bound on an H100 by bytes (x read once, 48 bytes, and act written, 128
// bytes, per position: 0.22 ms at B = 256, 256x256); the MMAs, 94.5
// GFLOP with the padding, take about 0.1 ms at the bf16 tensor-core peak.
// A chain of 11 k16 steps per output: the tensor core's truncation (section
// 6a) moves act by at most about 11 ulps of float32 of the step's largest
// product toward zero, far below a bfloat16 ulp.

constexpr int CFM_TH = 8, CFM_TW = 32;          // positions per tile
constexpr int CFM_NT = CFM_TW / 8;              // position tiles a warp
constexpr int CFM_IR = 2 * CFM_TH + 5;          // 21 input rows
constexpr int CFM_RC = 2 * CFM_TW + 8;          // 72 staged columns
constexpr int CFM_RW = CFM_TW + 4;              // 36 words a row (35 used)
constexpr int CFM_RAW = C_IN * CFM_IR * CFM_RC;  // floats of a tile
constexpr int CFM_XB = C_IN * CFM_IR * CFM_RW;  // words of a tile
constexpr int CFM_PAIRS = C_IN * K;             // 21 (c, ky) rows of 8 taps
constexpr int CFM_KS = cdiv(CFM_PAIRS, 2);      // 11 k16 steps
constexpr int CFM_WS = 16 * CFM_KS + 8;         // 184 bf16 a weight row
constexpr int CFM_WARPS = NTHREADS / 32;
constexpr int CFM_CTAS = 2;                     // CTAs per SM
constexpr int CFM_SW = C_OUT * CFM_TW / 2;      // a warp's act words
constexpr size_t CFM_SMEM =
    (size_t)CFM_WARPS * CFM_SW * sizeof(unsigned) +
    (size_t)2 * CFM_RAW * sizeof(float) +
    (size_t)2 * CFM_XB * sizeof(unsigned) +
    (size_t)C_OUT * CFM_WS * sizeof(bf16);
static_assert(CFM_SW * sizeof(unsigned) >= 2 * C_OUT * sizeof(double),
              "the statistics' slots share a warp's act words");

// flags: 1 x is 16-byte aligned (16-byte copies); 2 act is 16-byte
// aligned and Wo a multiple of 8 (16-byte stores).
__global__ void __launch_bounds__(NTHREADS, CFM_CTAS)
stem_conv_fwd_mma_kernel(const float* __restrict__ x,
                         const float* __restrict__ w, bf16* __restrict__ act,
                         double* __restrict__ partials, int B, int H, int W,
                         int flags) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned* sa = reinterpret_cast<unsigned*>(smem);  // [warp][64][16]
  double* st = reinterpret_cast<double*>(smem);  // [warp][sum, sq][64], last
  float* raw = reinterpret_cast<float*>(sa + CFM_WARPS * CFM_SW);
  unsigned* xb = reinterpret_cast<unsigned*>(raw + 2 * CFM_RAW);
  bf16* ws = reinterpret_cast<bf16*>(xb + 2 * CFM_XB);  // [64][CFM_WS]
  const bool vec = flags & 1, vec_out = flags & 2;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int Ho = H / 2, Wo = W / 2;
  const int ntx = cdiv(Wo, CFM_TW), tiles = cdiv(Ho, CFM_TH) * ntx;
  const int total = B * tiles;
  const int n_items =
      (total - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const bool stats = partials != nullptr;
  const unsigned kmask = t4 == 3 ? 0x0000ffffu : 0xffffffffu;

  // w[o, c, ky, kx] at column 8 (7 c + ky) + kx of row o; the rest zero
  for (int i = tid; i < C_OUT * CFM_WS; i += NTHREADS) {
    const int o = i / CFM_WS, k = i % CFM_WS, p = k / 8, kx = k % 8;
    ws[i] = __float2bfloat16_rn(
        p < CFM_PAIRS && kx < K ? w[o * TAPS + p * K + kx] : 0.f);
  }

  auto origin = [&](int item, int& b, int& oy0, int& ox0) {
    const int gt = (int)blockIdx.x + item * (int)gridDim.x;
    b = gt / tiles;
    const int tile = gt % tiles;
    oy0 = (tile / ntx) * CFM_TH;
    ox0 = (tile % ntx) * CFM_TW;
  };
  // the tile's input rows 2 oy0 - 3 .., columns 2 ox0 - 4 .. (zero outside
  // the image) into raw[item % 2]
  auto fetch = [&](int item) {
    int b, oy0, ox0;
    origin(item, b, oy0, ox0);
    const int iy0 = 2 * oy0 - 3, ix0 = 2 * ox0 - 4;
    float* rd = raw + (item & 1) * CFM_RAW;
    const float* xb0 = x + (size_t)b * C_IN * H * W;
    if (vec) {  // W and ix0 are multiples of 4: a float4 is in or out
      for (int e = tid; e < CFM_RAW / 4; e += NTHREADS) {
        const int f = e % (CFM_RC / 4), row = e / (CFM_RC / 4);
        const int c = row / CFM_IR, yy = iy0 + row % CFM_IR;
        const int xx = ix0 + 4 * f;
        const bool in = yy >= 0 && yy < H && xx >= 0 && xx < W;
        cp_async_f32x4(rd + 4 * e,
                       in ? xb0 + ((size_t)c * H + yy) * W + xx : xb0, in);
      }
    } else {
      for (int e = tid; e < CFM_RAW; e += NTHREADS) {
        const int col = e % CFM_RC, row = e / CFM_RC;
        const int c = row / CFM_IR, yy = iy0 + row % CFM_IR;
        const int xx = ix0 + col;
        const bool in = yy >= 0 && yy < H && xx >= 0 && xx < W;
        cp_async_f32(rd + e, in ? xb0 + ((size_t)c * H + yy) * W + xx : xb0,
                     in);
      }
    }
  };
  // raw[item % 2] rounded into words: word m of a row is (x[s], x[s + 1])
  // at s = 2 ox0 - 3 + 2 m, staged columns 2 m + 1 and 2 m + 2
  auto convert = [&](int item) {
    const float* rs = raw + (item & 1) * CFM_RAW;
    unsigned* xd = xb + (item & 1) * CFM_XB;
    for (int e = tid; e < CFM_XB; e += NTHREADS) {
      const int m = e % CFM_RW;
      const float* r = rs + (e / CFM_RW) * CFM_RC + 2 * m + 1;
      xd[e] = m < CFM_RW - 1 ? pack_bf16(r[0], r[1]) : 0u;
    }
  };

  if (n_items > 0) fetch(0);
  cp_async_commit();
  if (n_items > 1) fetch(1);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();  // the first tile's input landed, the weights staged
  if (n_items > 0) convert(0);

  // float64 sums over the walk of channels 16 t4 + 8 h + g
  double run1[2] = {0.0, 0.0}, run2[2] = {0.0, 0.0};
  for (int item = 0; item < n_items; ++item) {
    // the next tile's input landed; this tile's words formed; the last
    // tile's MMAs done with the words formed next
    cp_async_wait_all();
    __syncthreads();
    if (item + 1 < n_items) convert(item + 1);
    if (item + 2 < n_items) fetch(item + 2);
    cp_async_commit();

    int b, oy0, ox0;
    origin(item, b, oy0, ox0);
    const int u = oy0 + warp;
    if (u >= Ho) continue;  // warp-uniform
    // this lane's word of input row 2 warp (ky = 0, c = 0)
    const unsigned* xt =
        xb + (item & 1) * CFM_XB + 2 * warp * CFM_RW + g + t4;
    float acc[4][CFM_NT][4];
#pragma unroll
    for (int s = 0; s < CFM_KS; ++s) {
      unsigned a[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldsm_x4(a[mt], ws + (16 * mt + (lane & 15)) * CFM_WS + 16 * s +
                           8 * (lane >> 4));
      const int p0 = 2 * s, p1 = 2 * s + 1;  // (c, ky) rows of the step
      const unsigned* r0 = xt + ((p0 / K) * CFM_IR + p0 % K) * CFM_RW;
      const unsigned* r1 = xt + ((p1 / K) * CFM_IR + p1 % K) * CFM_RW;
#pragma unroll
      for (int nt = 0; nt < CFM_NT; ++nt) {
        const unsigned b0 = r0[8 * nt] & kmask;
        const unsigned b1 = p1 < CFM_PAIRS ? r1[8 * nt] & kmask : 0u;
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          if (s == 0)
            mma_bf16(acc[mt][nt], a[mt], b0, b1);
          else
            mma_bf16_acc(acc[mt][nt], a[mt], b0, b1);
        }
      }
    }

    // act: channel c's words at positions 8 n + 2 t4 into the warp's rows
    // [c][16 words] (16-byte chunk n at n ^ (c / 2 % 4): a quad's 8
    // channels hit 8 distinct bank quads), then one 16-byte store per
    // chunk; without vec_out, a word per store straight from the
    // fragment
    unsigned* sw = sa + warp * CFM_SW;
    float s1[4][2], s2[4][2];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ch = 16 * mt + 8 * h + g;
        bf16* row = act + (((size_t)b * C_OUT + ch) * Ho + u) * Wo;
        float a1 = 0.f, a2 = 0.f;
#pragma unroll
        for (int nt = 0; nt < CFM_NT; ++nt) {
          const int v = ox0 + 8 * nt + 2 * t4;  // Wo is even: v + 1 too
          if (v >= Wo) continue;
          const float d0 = acc[mt][nt][2 * h], d1 = acc[mt][nt][2 * h + 1];
          const unsigned word = pack_bf16(d0, d1);
          if (vec_out)
            sw[16 * ch + 4 * (nt ^ ((ch >> 1) & 3)) + t4] = word;
          else
            *reinterpret_cast<unsigned*>(row + v) = word;
          a1 += d0;
          a1 += d1;
          a2 += d0 * d0;
          a2 += d1 * d1;
        }
        s1[mt][h] = a1;
        s2[mt][h] = a2;
      }
    if (vec_out) {
      __syncwarp();
#pragma unroll
      for (int i = 0; i < C_OUT / 8; ++i) {
        const int ch = 8 * i + (lane >> 2), n = lane & 3;
        const int v = ox0 + 8 * n;
        if (v < Wo)
          *reinterpret_cast<uint4*>(
              act + (((size_t)b * C_OUT + ch) * Ho + u) * Wo + v) =
              *reinterpret_cast<const uint4*>(
                  sw + 16 * ch + 4 * (n ^ ((ch >> 1) & 3)));
      }
    }
    if (!stats) continue;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int o = 1; o < 4; o <<= 1) {
          s1[mt][h] += __shfl_xor_sync(FULL, s1[mt][h], o);
          s2[mt][h] += __shfl_xor_sync(FULL, s2[mt][h], o);
        }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float a1 = s1[0][h], a2 = s2[0][h];
#pragma unroll
      for (int mt = 1; mt < 4; ++mt)
        if (t4 == mt) {
          a1 = s1[mt][h];
          a2 = s2[mt][h];
        }
      run1[h] += (double)a1;
      run2[h] += (double)a2;
    }
  }
  if (!stats) return;
  __syncthreads();  // every warp done with its act words
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int o = 16 * t4 + 8 * h + g;
    st[(2 * warp) * C_OUT + o] = run1[h];
    st[(2 * warp + 1) * C_OUT + o] = run2[h];
  }
  __syncthreads();
  if (tid < 2 * C_OUT) {
    // partials[cta][k][o]: channel o's 8 warps, in order
    const int k = tid / C_OUT, o = tid % C_OUT;
    double s = 0.0;
    for (int wv = 0; wv < CFM_WARPS; ++wv) s += st[(2 * wv + k) * C_OUT + o];
    partials[(size_t)blockIdx.x * 2 * C_OUT + k * C_OUT + o] = s;
  }
}

// 6d. The bfloat16 BN-pool as a strip walk (section 2's function; the
// float32 form stays one thread per pooled element). A warp walks down a
// strip of 128 pre-pool columns of one plane, one window row (two pre-pool
// rows) a step: lanes 0-15 read row 2k, lanes 16-31 row 2k + 1, 8 columns
// a lane in one 16-byte load, kept two steps ahead in registers. Each lane
// forms r = relu(act alpha + beta) once per element and the maximum of
// each of its 4 windows' three columns in its row; the column left of a
// lane comes from its neighbour by __shfl_up_sync (0 at the plane's edge,
// where the pad never wins over relu; a load at a strip's edge). Window
// row k is the maximum of rows 2k - 1, 2k and 2k + 1: row 2k + 1 comes from
// the upper half-warp by __shfl_xor_sync, and row 2k - 1 is its row of the
// last step; lanes 0-15 round it once and store 4 pooled bfloat16 as one
// 8-byte store. Work: units of BP_CH window rows of a strip, walked as the
// pool backward's (section 3): warp w takes a run of units and walks each
// plane's part of it top-down, reading one halo row above. No division per
// element. Rows whose width is not a multiple of 8 or misaligned tensors
// take 2-byte loads and stores (kVec false). fmaxf is exact, so pooled is
// bitwise the plain version's in any order. Bound by bytes (act read, 2
// bytes, and pooled written, half a byte, per act element: 0.20 ms at B =
// 256, 256x256).

constexpr int BP_SW = 128;                // pre-pool columns per strip
constexpr int BP_CH = 8;                  // window rows per unit
constexpr int BP_CTAS = 4;                // CTAs per SM
constexpr int BP_WARPS = NTHREADS / 32;

template <bool kVec>
__global__ void __launch_bounds__(NTHREADS, BP_CTAS)
stem_bnpool_strip_kernel(const bf16* __restrict__ act,
                         const float* __restrict__ coef,
                         bf16* __restrict__ out, int B, int Ho, int Wo) {
  const int tid = threadIdx.x, lane = tid & 31;
  const int col = lane & 15, hr = lane >> 4;  // column group, row parity
  const int Hq = Ho / 2, Wq = Wo / 2;
  const int nstrips = cdiv(Wo, BP_SW), nchunks = cdiv(Hq, BP_CH);
  const long long units = (long long)B * C_OUT * nstrips * nchunks;
  const long long nw = (long long)gridDim.x * BP_WARPS;
  const long long wid = (long long)blockIdx.x * BP_WARPS + (tid >> 5);
  const long long u_end = (wid + 1) * units / nw;

  for (long long un = wid * units / nw; un < u_end;) {
    // a segment: the run's units in one strip of one plane
    const long long ps = un / nchunks;  // plane * nstrips + strip
    const long long seg_end = min(u_end, (ps + 1) * nchunks);
    const int k_first = (int)(un - ps * nchunks) * BP_CH;
    const int k_last = min(Hq, (int)(seg_end - ps * nchunks) * BP_CH);
    const long long plane = ps / nstrips;
    const int strip = (int)(ps - plane * nstrips);
    const int c = (int)(plane % C_OUT);
    const float alpha = coef[c], beta = coef[C_OUT + c];
    const bf16* ap = act + (size_t)plane * Ho * Wo;
    bf16* op = out + (size_t)plane * Hq * Wq;
    const int x0 = strip * BP_SW + 8 * col;  // the lane's first column
    const bool edge = col == 0 && strip > 0;  // its left column is a load
    un = seg_end;

    auto relu_bn = [&](float a) {
      return fmaxf(bn_out(a, alpha, beta), 0.f);
    };
    // row y at the lane's 8 columns, raw (zero past the row's end)
    auto load = [&](int y) {
      uint4 q = make_uint4(0u, 0u, 0u, 0u);
      const bf16* src = ap + (size_t)y * Wo + x0;
      if (kVec) {
        if (x0 < Wo) q = __ldg(reinterpret_cast<const uint4*>(src));
      } else {
        const unsigned short* hs =
            reinterpret_cast<const unsigned short*>(src);
        unsigned wd[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (x0 + e < Wo)
            wd[e / 2] |= (unsigned)__ldg(hs + e) << (16 * (e & 1));
        q = make_uint4(wd[0], wd[1], wd[2], wd[3]);
      }
      return q;
    };
    // the maxima of r over the lane's 4 windows' columns in row y
    auto row_max = [&](int y, const uint4 q, float (&m)[4]) {
      const unsigned wd[4] = {q.x, q.y, q.z, q.w};
      float r[8];
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // bfloat16 widened: its bits on top
        r[2 * e] = x0 + 2 * e < Wo ? relu_bn(__uint_as_float(wd[e] << 16))
                                   : 0.f;
        r[2 * e + 1] = x0 + 2 * e + 1 < Wo
                           ? relu_bn(__uint_as_float(wd[e] & 0xffff0000u))
                           : 0.f;
      }
      const float up = __shfl_up_sync(FULL, r[7], 1);
      float left = col > 0 ? up : 0.f;
      if (edge) left = relu_bn(__bfloat162float(ap[(size_t)y * Wo + x0 - 1]));
      m[0] = fmaxf(fmaxf(left, r[0]), r[1]);
#pragma unroll
      for (int j = 1; j < 4; ++j)
        m[j] = fmaxf(fmaxf(r[2 * j - 1], r[2 * j]), r[2 * j + 1]);
    };

    // top: the upper half's row 2k - 1 of the last step (0 above the plane)
    float top[4] = {0.f, 0.f, 0.f, 0.f};
    if (k_first > 0) row_max(2 * k_first - 1, load(2 * k_first - 1), top);
    uint4 q0 = load(2 * k_first + hr);
    uint4 q1 = k_first + 1 < k_last ? load(2 * k_first + 2 + hr)
                                    : make_uint4(0u, 0u, 0u, 0u);
    for (int k = k_first; k < k_last; ++k) {
      const uint4 q = q0;
      q0 = q1;
      if (k + 2 < k_last) q1 = load(2 * k + 4 + hr);
      float m[4], pooled[4];
      row_max(2 * k + hr, q, m);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float below = __shfl_xor_sync(FULL, m[j], 16);
        const float above = __shfl_xor_sync(FULL, top[j], 16);
        pooled[j] = fmaxf(fmaxf(above, m[j]), below);
        top[j] = m[j];  // the upper half's row 2k + 1
      }
      if (hr == 0 && x0 < Wo) {
        bf16* dst = op + (size_t)k * Wq + x0 / 2;
        if (kVec) {
          uint2 o;
          o.x = pack_bf16(pooled[0], pooled[1]);
          o.y = pack_bf16(pooled[2], pooled[3]);
          *reinterpret_cast<uint2*>(dst) = o;
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (x0 / 2 + j < Wq) dst[j] = __float2bfloat16_rn(pooled[j]);
        }
      }
    }
  }
}

template <typename F>
int set_smem(F* kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// The launches of each kernel's form T: each returns the CUDA error of the
// launch (0 when it was accepted).

template <typename T>
int launch_conv_fwd(const float* x, const float* w, T* act, double* partials,
                    int B, int H, int W, int ctas, void* stream) {
  int err = set_smem(stem_conv_fwd_kernel<T>, CF_SMEM);
  if (err != 0) return err;
  stem_conv_fwd_kernel<T><<<ctas, NTHREADS, CF_SMEM, (cudaStream_t)stream>>>(
      x, w, act, partials, B, H, W);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bnpool(const T* act, const float* coef, T* out, int B, int Ho,
                  int Wo, void* stream) {
  const size_t n = (size_t)B * C_OUT * (Ho / 2) * (Wo / 2);
  size_t blocks = (n + NTHREADS - 1) / NTHREADS;
  if (blocks > 1048576) blocks = 1048576;
  stem_bnpool_kernel<T><<<(unsigned)blocks, NTHREADS, 0,
                          (cudaStream_t)stream>>>(act, coef, out, B, Ho, Wo);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_pool_bwd(const T* act, const T* dp, const float* coef, T* dn,
                    double* partials, int B, int Ho, int Wo, int ctas,
                    void* stream) {
  const bool vec = Wo % 4 == 0 &&
                   ((uintptr_t)act | (uintptr_t)dn) % (4 * sizeof(T)) == 0 &&
                   (uintptr_t)dp % (2 * sizeof(T)) == 0;
  auto kernel =
      vec ? stem_pool_bwd_kernel<true, T> : stem_pool_bwd_kernel<false, T>;
  const int err = set_smem(kernel, PB_SMEM);
  if (err != 0) return err;
  kernel<<<ctas, NTHREADS, PB_SMEM, (cudaStream_t)stream>>>(
      act, dp, coef, dn, partials, B, Ho, Wo);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_conv_dw(const float* x, const T* act, const T* dn,
                   const float* coef, float* partials, int B, int H, int W,
                   int ctas, void* stream) {
  int err = set_smem(stem_conv_dw_kernel<T>, DW_SMEM);
  if (err != 0) return err;
  stem_conv_dw_kernel<T><<<ctas, NTHREADS, DW_SMEM, (cudaStream_t)stream>>>(
      x, act, dn, coef, partials, B, H, W);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_conv_dx(const T* act, const T* dn, const float* coef,
                   const float* w, float* dx, int B, int H, int W, int ctas,
                   void* stream) {
  int err = set_smem(stem_conv_dx_kernel<T>, DX_SMEM);
  if (err != 0) return err;
  stem_conv_dx_kernel<T><<<ctas, NTHREADS, DX_SMEM, (cudaStream_t)stream>>>(
      act, dn, coef, w, dx, B, H, W);
  return (int)cudaGetLastError();
}

// The bfloat16 forms (section 6): 16-byte copies where the rows of act and
// d_n are a multiple of 8 elements and both tensors 16-byte aligned.
int mma_vec(const bf16* act, const bf16* dn, int W) {
  return (W / 2) % 8 == 0 && ((uintptr_t)act | (uintptr_t)dn) % 16 == 0;
}

int launch_conv_dw_mma(const float* x, const bf16* act, const bf16* dn,
                       const float* coef, float* partials, int B, int H,
                       int W, int ctas, void* stream) {
  auto kernel = (long long)B * (H / 2) * (W / 2) <= DWM_NEAREST
                    ? stem_conv_dw_mma_kernel<true>
                    : stem_conv_dw_mma_kernel<false>;
  int err = set_smem(kernel, DWM_SMEM);
  if (err != 0) return err;
  kernel<<<ctas, NTHREADS, DWM_SMEM, (cudaStream_t)stream>>>(
      x, act, dn, coef, partials, B, H, W, mma_vec(act, dn, W));
  return (int)cudaGetLastError();
}

int launch_conv_dx_mma(const bf16* act, const bf16* dn, const float* coef,
                       const float* w, float* dx, int B, int H, int W,
                       int ctas, void* stream) {
  int err = set_smem(stem_conv_dx_mma_kernel, DXM_SMEM);
  if (err != 0) return err;
  stem_conv_dx_mma_kernel<<<ctas, DXM_THREADS, DXM_SMEM,
                            (cudaStream_t)stream>>>(
      act, dn, coef, w, dx, B, H, W, mma_vec(act, dn, W));
  return (int)cudaGetLastError();
}

// 16-byte copies of x where it is 16-byte aligned (its rows, W a multiple
// of 4, then are too); 16-byte stores of act where it is 16-byte aligned
// and its rows a multiple of 8 elements.
int launch_conv_fwd_mma(const float* x, const float* w, bf16* act,
                        double* partials, int B, int H, int W, int ctas,
                        void* stream) {
  int err = set_smem(stem_conv_fwd_mma_kernel, CFM_SMEM);
  if (err != 0) return err;
  const int flags = ((uintptr_t)x % 16 == 0) |
                    ((uintptr_t)act % 16 == 0 && (W / 2) % 8 == 0) << 1;
  stem_conv_fwd_mma_kernel<<<ctas, NTHREADS, CFM_SMEM,
                             (cudaStream_t)stream>>>(
      x, w, act, partials, B, H, W, flags);
  return (int)cudaGetLastError();
}

// A grid of BP_CTAS CTAs per SM, at most one warp per unit (the results
// do not depend on the grid); 16-byte loads and 8-byte stores where the
// rows are a multiple of 8 elements and both tensors so aligned.
int launch_bnpool_strip(const bf16* act, const float* coef, bf16* out,
                        int B, int Ho, int Wo, void* stream) {
  int dev = 0, sms = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err == 0)
    err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev);
  if (err != 0) return err;
  const long long units = (long long)B * C_OUT * cdiv(Wo, BP_SW) *
                          cdiv(Ho / 2, BP_CH);
  const long long want = (units + BP_WARPS - 1) / BP_WARPS;
  const int ctas = want < (long long)sms * BP_CTAS ? (int)want
                                                   : sms * BP_CTAS;
  const bool vec = Wo % 8 == 0 && (uintptr_t)act % 16 == 0 &&
                   (uintptr_t)out % 8 == 0;
  auto kernel = vec ? stem_bnpool_strip_kernel<true>
                    : stem_bnpool_strip_kernel<false>;
  kernel<<<ctas, NTHREADS, 0, (cudaStream_t)stream>>>(act, coef, out, B, Ho,
                                                      Wo);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each launches on `stream` and returns the CUDA error of the launch (0
// when it was accepted). `ctas` is the grid of the conv forward, dW and
// d_x, which walk all B x tiles tiles with a stride of the grid, and of
// the pool backward, whose warps walk runs of its units (r2l_stem_ctas).
// The partials' layouts are given with each function.
// `coef` rows: see the kernels above.

// Tiles per image of a kernel on an input of H x W (the tile shapes live
// only in this file): kernel 0 conv forward, 1 pool backward (its units:
// PB_CH window rows of a 128-column strip, per plane), 2 dW (both forms),
// 3 d_x, 4 d_x's bfloat16 form, 5 the conv forward's bfloat16 form; -1 for
// another kernel.
int r2l_stem_tiles(int kernel, int H, int W) {
  const int Ho = H / 2, Wo = W / 2;
  switch (kernel) {
    case 0: return cdiv(Ho, CF_TH) * cdiv(Wo, CF_TW);
    case 1: return cdiv(Ho / 2, PB_CH) * cdiv(Wo, PB_SW);
    case 2: return cdiv(Ho, DW_TH) * cdiv(Wo, DW_TW);
    case 3: return cdiv(Ho, DX_TU) * cdiv(Wo, DX_TV);
    case 4: return cdiv(Ho, DXM_TU) * cdiv(Wo, DXM_TV);
    case 5: return cdiv(Ho, CFM_TH) * cdiv(Wo, CFM_TW);
  }
  return -1;
}

// Grid of a kernel on a card with `sms` SMs: for those that walk all B x
// tiles tiles with a stride of the grid (0 conv forward, 2 dW, 3 and 4
// d_x) one CTA per SM, CFM_CTAS per SM for the bfloat16 conv forward (5),
// at most one per tile; for the pool backward (1) PB_CTAS per SM, at most
// one warp per unit; -1 for another kernel. A function of the shape and
// the card only, so repeated launches are bitwise equal (the pool
// backward's results do not depend on its grid at all).
int r2l_stem_ctas(int kernel, int B, int H, int W, int sms) {
  if (kernel == 1) {
    const long long units =
        (long long)B * C_OUT * r2l_stem_tiles(kernel, H, W);
    const long long n = (units + PB_WARPS - 1) / PB_WARPS;
    return n < (long long)sms * PB_CTAS ? (int)n : sms * PB_CTAS;
  }
  if (kernel < 0 || kernel > 5) return -1;
  const int n = B * r2l_stem_tiles(kernel, H, W);
  const int m = kernel == 5 ? CFM_CTAS * sms : sms;
  return n < m ? n : m;
}

// `use_bf16` nonzero selects the bfloat16 form: act, pooled, d_n and the pooled
// cotangent are then __nv_bfloat16 (x, w, coef, dW and d_x stay float).

// partials: [ctas][2][64] float64 (sum, sum of squares), or null to skip
// the statistics (eval mode). `ctas` from r2l_stem_ctas(0, ...) for
// float32, (5, ...) for bfloat16.
int r2l_stem_conv_fwd(const float* x, const float* w, void* act,
                      double* partials, int B, int H, int W, int ctas,
                      int use_bf16, void* stream) {
  return use_bf16 ? launch_conv_fwd_mma(x, w, (bf16*)act, partials, B, H, W,
                                        ctas, stream)
              : launch_conv_fwd(x, w, (float*)act, partials, B, H, W, ctas,
                                stream);
}

int r2l_stem_bnpool(const void* act, const float* coef, void* out, int B,
                    int Ho, int Wo, int use_bf16, void* stream) {
  return use_bf16 ? launch_bnpool_strip((const bf16*)act, coef, (bf16*)out,
                                        B, Ho, Wo, stream)
              : launch_bnpool((const float*)act, coef, (float*)out, B, Ho,
                              Wo, stream);
}

// partials: [B * 64][r2l_stem_tiles(1, 2 Ho, 2 Wo)][2] float64 (sum of d_n,
// sum of d_n xhat), the units of a plane strip-major. Rows of a width that
// is a multiple of 4, in tensors aligned to four elements (two for the
// cotangent), take vector loads and stores.
int r2l_stem_pool_bwd(const void* act, const void* dp, const float* coef,
                      void* dn, double* partials, int B, int Ho, int Wo,
                      int ctas, int use_bf16, void* stream) {
  return use_bf16 ? launch_pool_bwd((const bf16*)act, (const bf16*)dp, coef,
                                (bf16*)dn, partials, B, Ho, Wo, ctas,
                                stream)
              : launch_pool_bwd((const float*)act, (const float*)dp, coef,
                                (float*)dn, partials, B, Ho, Wo, ctas,
                                stream);
}

// partials: [ctas * 2][64][147] (dW in OIHW order per CTA and half) for
// float32; [ctas][64][147] (per CTA) for the bfloat16 form.
int r2l_stem_conv_dw(const float* x, const void* act, const void* dn,
                     const float* coef, float* partials, int B, int H, int W,
                     int ctas, int use_bf16, void* stream) {
  return use_bf16 ? launch_conv_dw_mma(x, (const bf16*)act, (const bf16*)dn,
                                       coef, partials, B, H, W, ctas, stream)
              : launch_conv_dw(x, (const float*)act, (const float*)dn, coef,
                               partials, B, H, W, ctas, stream);
}

// `ctas` from r2l_stem_ctas(3, ...) for float32, (4, ...) for bfloat16.
int r2l_stem_conv_dx(const void* act, const void* dn, const float* coef,
                     const float* w, float* dx, int B, int H, int W,
                     int ctas, int use_bf16, void* stream) {
  return use_bf16 ? launch_conv_dx_mma((const bf16*)act, (const bf16*)dn,
                                       coef, w, dx, B, H, W, ctas, stream)
              : launch_conv_dx((const float*)act, (const float*)dn, coef, w,
                               dx, B, H, W, ctas, stream);
}

// Kernel `which` of this file (0 conv forward, 1 BN-pool, 2 pool
// backward, 3 dW, 4 d_x, 5 the pool backward's scalar form; 6-11 the same
// in their bfloat16 forms: 6, 9 and 10 the tensor-core kernels of section
// 6, dW's long-sum instance, and 7 the strip walk of section 6d; 12 that
// walk's scalar form): its name, registers per thread, CTAs per SM and
// shared bytes per CTA (kernel_info.cuh); null past the last or on an
// error.
const char* r2l_kernel_info(int which, int* regs, int* ctas_per_sm,
                            int* smem) {
  switch (which) {
    case 0: return r2l_occupancy((const void*)stem_conv_fwd_kernel<float>,
                                 "stem_conv_fwd_kernel", NTHREADS, CF_SMEM,
                                 regs, ctas_per_sm, smem);
    case 1: return r2l_occupancy((const void*)stem_bnpool_kernel<float>,
                                 "stem_bnpool_kernel", NTHREADS, 0, regs,
                                 ctas_per_sm, smem);
    case 2: return r2l_occupancy(
        (const void*)stem_pool_bwd_kernel<true, float>,
        "stem_pool_bwd_kernel<true>", NTHREADS, PB_SMEM, regs, ctas_per_sm,
        smem);
    case 3: return r2l_occupancy((const void*)stem_conv_dw_kernel<float>,
                                 "stem_conv_dw_kernel", NTHREADS, DW_SMEM,
                                 regs, ctas_per_sm, smem);
    case 4: return r2l_occupancy((const void*)stem_conv_dx_kernel<float>,
                                 "stem_conv_dx_kernel", NTHREADS, DX_SMEM,
                                 regs, ctas_per_sm, smem);
    case 5: return r2l_occupancy(
        (const void*)stem_pool_bwd_kernel<false, float>,
        "stem_pool_bwd_kernel<false>", NTHREADS, PB_SMEM, regs, ctas_per_sm,
        smem);
    case 6: return r2l_occupancy((const void*)stem_conv_fwd_mma_kernel,
                                 "stem_conv_fwd_mma_kernel", NTHREADS,
                                 CFM_SMEM, regs, ctas_per_sm, smem);
    case 7: return r2l_occupancy(
        (const void*)stem_bnpool_strip_kernel<true>,
        "stem_bnpool_strip_kernel<true>", NTHREADS, 0, regs, ctas_per_sm,
        smem);
    case 8: return r2l_occupancy(
        (const void*)stem_pool_bwd_kernel<true, bf16>,
        "stem_pool_bwd_kernel<true, bf16>", NTHREADS, PB_SMEM, regs,
        ctas_per_sm, smem);
    case 9: return r2l_occupancy(
        (const void*)stem_conv_dw_mma_kernel<false>,
        "stem_conv_dw_mma_kernel<false>", NTHREADS, DWM_SMEM, regs,
        ctas_per_sm, smem);
    case 10: return r2l_occupancy((const void*)stem_conv_dx_mma_kernel,
                                  "stem_conv_dx_mma_kernel", DXM_THREADS,
                                  DXM_SMEM, regs, ctas_per_sm, smem);
    case 11: return r2l_occupancy(
        (const void*)stem_pool_bwd_kernel<false, bf16>,
        "stem_pool_bwd_kernel<false, bf16>", NTHREADS, PB_SMEM, regs,
        ctas_per_sm, smem);
    case 12: return r2l_occupancy(
        (const void*)stem_bnpool_strip_kernel<false>,
        "stem_bnpool_strip_kernel<false>", NTHREADS, 0, regs, ctas_per_sm,
        smem);
  }
  return nullptr;
}

const char* r2l_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
