// Fused ResNet stem for Hopper (sm_90a), plain C interface: conv 7x7/2
// (3 -> 64, pad 3, no bias), train-mode batch norm, ReLU, maxpool 3x3/2
// (pad 1), forward and backward, in five kernels.
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
// multiples of 4 (the wrapper checks). All f32, planar, contiguous.
//
// The TPU kernels' space-to-depth phase planes and selector matrices are
// workarounds for Mosaic's lack of lane-strided loads; here the strided
// taps are plain shared-memory addresses. The backward starts from the
// closed train-mode form d_a = g1 (d_n - c1 - xhat c2) with xhat =
// (act - mu) inv, recomputed where dW and d_x read it (as the TPU kernels
// do), so d_a never goes to device memory.
//
// Bounds on an H100 at B = 256, 256x256 (act is 268 M elements): the two
// convolutions are bound by operations, 2 * 147 FMA operands per act
// element, 78.9 GFLOP each (1.18 ms at 67 TFLOP/s of non-tensor f32); the
// BN-pool pass and the pool backward by bytes (1.34 and 2.42 GB, 0.40 and
// 0.72 ms at 3.35 TB/s). Design, simple and right first: direct FMAs from
// shared memory, register blocking so that each shared load feeds several
// FMAs, the weights staged in shared memory once per CTA, and CTAs that
// walk a strip of tiles of one image (grid (strips, B)) so that the
// weights are read from L2 a few hundred times, not once per tile. No
// tensor cores, no TMA (later PRs).
//
// Cross-CTA reductions (the BN statistics, dW) are per-CTA partials in a
// fixed order, summed by the wrapper in float64: no atomics, so two
// launches are bitwise equal. Products that the plain version rounds
// twice (act a + b, xhat, d_a) are rounded as written (__fmul_rn,
// __fadd_rn), so that the ReLU mask and the pool's argmax are decided on
// the same values as in the plain version. No fast math.

#include <cuda_runtime.h>

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// 1. Conv forward and the statistics' partials.
//
// Tile: 8 x 32 output pixels. Thread tid: channel half h = tid / 128
// (channels 32h .. 32h + 31, warp-uniform, so the weight loads broadcast),
// output column tid % 32, rows r and r + 4 with r = (tid % 128) / 32: two
// pixels x 32 channels = 64 accumulators; per tap 2 input loads and 8
// float4 weight loads feed 64 FMAs. Shared memory: the weights as
// [tap][64] (37,632 B), the input tile with its halo, 3 x 21 x 69, zero
// outside the image (17,388 B), and per-warp statistics in float64
// (4,096 B): each tile's sums are float32 warp sums of 64 values, and
// their sum over the strip's tiles stays in float64.

constexpr int CF_TH = 8, CF_TW = 32;
constexpr int CF_IR = 2 * CF_TH + 5;   // 21 input rows
constexpr int CF_IC = 2 * CF_TW + 5;   // 69 input cols
constexpr int CF_XS = C_IN * CF_IR * CF_IC;
constexpr int CF_ST = (NTHREADS / 32) * 2 * 32;
constexpr size_t CF_SMEM =
    (size_t)CF_ST * sizeof(double) + (size_t)(TAPS * C_OUT + CF_XS) *
    sizeof(float);

__global__ void __launch_bounds__(NTHREADS)
stem_conv_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     float* __restrict__ act, double* __restrict__ partials,
                     int H, int W, int strips) {
  extern __shared__ __align__(16) double smd[];
  double* st = smd;                    // [warp][sum, sumsq][32]
  float* ws = reinterpret_cast<float*>(st + CF_ST);  // [TAPS][C_OUT]
  float* xs = ws + TAPS * C_OUT;       // [C_IN][CF_IR][CF_IC]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int chalf = tid >> 7, r = (tid & 127) >> 5, col = lane;
  const int b = blockIdx.y;
  const int Ho = H / 2, Wo = W / 2;
  const int nty = cdiv(Ho, CF_TH), ntx = cdiv(Wo, CF_TW);
  const float* xb = x + (size_t)b * C_IN * H * W;

  for (int i = tid; i < TAPS * C_OUT; i += NTHREADS) {
    const int t = i / C_OUT, o = i % C_OUT;
    ws[i] = w[o * TAPS + t];
  }
  for (int i = tid; i < CF_ST; i += NTHREADS) st[i] = 0.0;

  for (int tile = blockIdx.x; tile < nty * ntx; tile += strips) {
    const int oy0 = (tile / ntx) * CF_TH, ox0 = (tile % ntx) * CF_TW;
    const int iy0 = 2 * oy0 - 3, ix0 = 2 * ox0 - 3;
    __syncthreads();  // the previous tile's reads of xs are done
    for (int i = tid; i < CF_XS; i += NTHREADS) {
      const int c = i / (CF_IR * CF_IC), rem = i % (CF_IR * CF_IC);
      const int yy = iy0 + rem / CF_IC, xx = ix0 + rem % CF_IC;
      xs[i] = (yy >= 0 && yy < H && xx >= 0 && xx < W)
                  ? xb[((size_t)c * H + yy) * W + xx] : 0.f;
    }
    __syncthreads();

    float acc0[32], acc1[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) acc0[j] = acc1[j] = 0.f;
    for (int c = 0; c < C_IN; ++c) {
      for (int ky = 0; ky < K; ++ky) {
        const float* x0 = xs + (c * CF_IR + 2 * r + ky) * CF_IC + 2 * col;
        const float* x1 = x0 + 8 * CF_IC;  // row r + 4: input rows + 8
        const float4* wrow = reinterpret_cast<const float4*>(
            ws + (c * KK + ky * K) * C_OUT + 32 * chalf);
#pragma unroll
        for (int kx = 0; kx < K; ++kx) {
          const float v0 = x0[kx], v1 = x1[kx];
          const float4* wp = wrow + kx * (C_OUT / 4);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float4 wv = wp[j];
            acc0[4 * j + 0] = fmaf(v0, wv.x, acc0[4 * j + 0]);
            acc0[4 * j + 1] = fmaf(v0, wv.y, acc0[4 * j + 1]);
            acc0[4 * j + 2] = fmaf(v0, wv.z, acc0[4 * j + 2]);
            acc0[4 * j + 3] = fmaf(v0, wv.w, acc0[4 * j + 3]);
            acc1[4 * j + 0] = fmaf(v1, wv.x, acc1[4 * j + 0]);
            acc1[4 * j + 1] = fmaf(v1, wv.y, acc1[4 * j + 1]);
            acc1[4 * j + 2] = fmaf(v1, wv.z, acc1[4 * j + 2]);
            acc1[4 * j + 3] = fmaf(v1, wv.w, acc1[4 * j + 3]);
          }
        }
      }
    }

    const int oy_a = oy0 + r, oy_b = oy0 + r + 4, ox = ox0 + col;
    const bool in_a = oy_a < Ho && ox < Wo, in_b = oy_b < Ho && ox < Wo;
    float* ab = act + ((size_t)b * C_OUT + 32 * chalf) * Ho * Wo;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      float* plane = ab + (size_t)j * Ho * Wo;
      if (in_a) plane[(size_t)oy_a * Wo + ox] = acc0[j];
      if (in_b) plane[(size_t)oy_b * Wo + ox] = acc1[j];
    }
    if (partials != nullptr) {
      // Each warp adds its tile's sums into its own slots, in tile order.
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const float a0 = in_a ? acc0[j] : 0.f, a1 = in_b ? acc1[j] : 0.f;
        const float s1 = warp_sum(a0 + a1);
        const float s2 = warp_sum(a0 * a0 + a1 * a1);
        if (lane == 0) {
          st[(warp * 2 + 0) * 32 + j] += s1;
          st[(warp * 2 + 1) * 32 + j] += s2;
        }
      }
    }
  }
  if (partials == nullptr) return;
  __syncthreads();
  if (tid < 2 * C_OUT) {
    // partials[cta][k][o]: the four warps of channel o's half, in order
    const int k = tid / C_OUT, o = tid % C_OUT, h = o / 32;
    double s = 0.0;
    for (int q = 0; q < 4; ++q) s += st[((4 * h + q) * 2 + k) * 32 + o % 32];
    partials[((size_t)b * strips + blockIdx.x) * 2 * C_OUT + k * C_OUT + o] =
        s;
  }
}

// ---------------------------------------------------------------------------
// 2. BN (folded alpha, beta), ReLU and maxpool 3x3/2 pad 1: one thread per
// pooled element; the pad never wins (ReLU output >= 0, and the window's
// centre is always inside the image). Bytes-bound; the 9 taps overlap
// between neighbouring threads and come from L1.

__global__ void __launch_bounds__(NTHREADS)
stem_bnpool_kernel(const float* __restrict__ act,
                   const float* __restrict__ coef, float* __restrict__ out,
                   int B, int Ho, int Wo) {
  const int Hq = Ho / 2, Wq = Wo / 2;
  const size_t n = (size_t)B * C_OUT * Hq * Wq;
  for (size_t idx = (size_t)blockIdx.x * NTHREADS + threadIdx.x; idx < n;
       idx += (size_t)gridDim.x * NTHREADS) {
    const int j = (int)(idx % Wq), i = (int)((idx / Wq) % Hq);
    const size_t plane = idx / ((size_t)Wq * Hq);
    const int c = (int)(plane % C_OUT);
    const float alpha = coef[c], beta = coef[C_OUT + c];
    const float* ap = act + plane * Ho * Wo;
    float m = 0.f;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const int y = 2 * i + dy - 1;
      if (y < 0 || y >= Ho) continue;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const int xx = 2 * j + dx - 1;
        if (xx < 0 || xx >= Wo) continue;
        m = fmaxf(m, bn_out(__ldg(ap + (size_t)y * Wo + xx), alpha, beta));
      }
    }
    out[idx] = m;
  }
}

// ---------------------------------------------------------------------------
// 3. Pool, ReLU and BN backward. CTA: one (image, channel) plane, a tile of
// 8 x 32 pooling windows, whose pre-pool rows and columns (16 x 64) it
// owns. (a) r = relu(act alpha + beta) on the windows' support, 19 x 67,
// -1 outside the image; (b) each of the 9 x 33 windows that touch the tile
// takes its first maximum in tap order (dy, dx) row-major, as
// _argmax_first, and its cotangent (0 for a window outside the image);
// (c) each pre-pool position sums, in tap order, the cotangents of the
// windows whose first maximum it is, keeps them where n > 0, writes d_n,
// and adds d_n and d_n xhat to the CTA's partials (fixed order).

constexpr int PB_TH = 8, PB_TW = 32;          // windows per tile
constexpr int PB_RR = 2 * PB_TH + 3;          // 19 rows of r
constexpr int PB_RC = 2 * PB_TW + 3;          // 67 cols of r
constexpr int PB_WR = PB_TH + 1, PB_WC = PB_TW + 1;  // 9 x 33 windows

__global__ void __launch_bounds__(NTHREADS)
stem_pool_bwd_kernel(const float* __restrict__ act,
                     const float* __restrict__ dp,
                     const float* __restrict__ coef, float* __restrict__ dn,
                     float* __restrict__ partials, int Ho, int Wo) {
  __shared__ float rs[PB_RR * PB_RC];
  __shared__ float dps[PB_WR * PB_WC];
  __shared__ int ids[PB_WR * PB_WC];
  __shared__ float red[2][NTHREADS / 32];

  const int tid = threadIdx.x;
  const int Hq = Ho / 2, Wq = Wo / 2;
  const size_t plane = blockIdx.z;  // b * 64 + c
  const int c = (int)(plane % C_OUT);
  const float alpha = coef[c], beta = coef[C_OUT + c];
  const float mu = coef[2 * C_OUT + c], inv = coef[3 * C_OUT + c];
  const int i0 = blockIdx.y * PB_TH, j0 = blockIdx.x * PB_TW;
  const int y0 = 2 * i0 - 1, x0 = 2 * j0 - 1;  // r's origin
  const float* ap = act + plane * Ho * Wo;
  const float* dpp = dp + plane * Hq * Wq;

  for (int k = tid; k < PB_RR * PB_RC; k += NTHREADS) {
    const int y = y0 + k / PB_RC, xx = x0 + k % PB_RC;
    rs[k] = (y >= 0 && y < Ho && xx >= 0 && xx < Wo)
                ? fmaxf(bn_out(ap[(size_t)y * Wo + xx], alpha, beta), 0.f)
                : -1.f;
  }
  __syncthreads();
  for (int k = tid; k < PB_WR * PB_WC; k += NTHREADS) {
    const int wi = k / PB_WC, wj = k % PB_WC;
    float best = -2.f;
    int id = 0;
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      const float v = rs[(2 * wi + t / 3) * PB_RC + 2 * wj + t % 3];
      if (v > best) { best = v; id = t; }
    }
    const int i = i0 + wi, j = j0 + wj;
    ids[k] = id;
    dps[k] = (i < Hq && j < Wq) ? dpp[(size_t)i * Wq + j] : 0.f;
  }
  __syncthreads();

  float s1 = 0.f, s2 = 0.f;
  for (int k = tid; k < 2 * PB_TH * 2 * PB_TW; k += NTHREADS) {
    const int py = k / (2 * PB_TW), px = k % (2 * PB_TW);
    const int y = 2 * i0 + py, xx = 2 * j0 + px;
    if (y >= Ho || xx >= Wo) continue;
    float d = 0.f;
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      const int wy2 = py + 1 - t / 3, wx2 = px + 1 - t % 3;
      if ((wy2 & 1) || (wx2 & 1) || wy2 < 0 || wx2 < 0) continue;
      const int kw = (wy2 >> 1) * PB_WC + (wx2 >> 1);
      if (ids[kw] == t) d += dps[kw];
    }
    const float v = rs[(py + 1) * PB_RC + px + 1] > 0.f ? d : 0.f;
    const size_t at = (size_t)y * Wo + xx;
    dn[plane * Ho * Wo + at] = v;
    const float xhat = __fmul_rn(__fsub_rn(ap[at], mu), inv);
    s1 += v;
    s2 = fmaf(v, xhat, s2);
  }
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  if ((tid & 31) == 0) {
    red[0][tid >> 5] = s1;
    red[1][tid >> 5] = s2;
  }
  __syncthreads();
  if (tid < 2) {
    float s = 0.f;
    for (int q = 0; q < NTHREADS / 32; ++q) s += red[tid][q];
    partials[((plane * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x) * 2 +
             tid] = s;
  }
}

// ---------------------------------------------------------------------------
// 4. dW partials: dW[o, t] = sum over positions p of d_a[o, p] * patch[p, t].
// Tile: 4 x 32 output positions. Shared: the input tile with its halo,
// 3 x 13 x 69 (zero outside the image), and d_a as [position][o] with a
// row stride of 68 floats (16-byte rows, and the transposing stores spread
// over the banks). Thread: 4 channels (tid % 16) x 10 taps (tid / 16; taps
// 147..159 are padding, never written): 40 accumulators over the CTA's
// strip; per position one float4 of d_a and 10 input loads feed 40 FMAs.

constexpr int DW_TH = 4, DW_TW = 32, DW_TP = DW_TH * DW_TW;  // 128 positions
constexpr int DW_IR = 2 * DW_TH + 5;   // 13
constexpr int DW_IC = 2 * DW_TW + 5;   // 69
constexpr int DW_XS = C_IN * DW_IR * DW_IC;
constexpr int DW_DS = 68;              // d_a row stride
constexpr int DW_TB = 10;              // taps per thread
constexpr size_t DW_SMEM =
    (size_t)(DW_XS + DW_TP * DW_DS + 5 * C_OUT) * sizeof(float);

__global__ void __launch_bounds__(NTHREADS)
stem_conv_dw_kernel(const float* __restrict__ x, const float* __restrict__ act,
                    const float* __restrict__ dn,
                    const float* __restrict__ coef,
                    float* __restrict__ partials, int H, int W, int strips) {
  extern __shared__ __align__(16) float sm[];
  float* das = sm;                      // [DW_TP][DW_DS]
  float* xs = das + DW_TP * DW_DS;      // [C_IN][DW_IR][DW_IC]
  float* cf = xs + DW_XS;               // [5][C_OUT]

  const int tid = threadIdx.x;
  const int ob = tid & 15, tb = tid >> 4;
  const int b = blockIdx.y;
  const int Ho = H / 2, Wo = W / 2;
  const int nty = cdiv(Ho, DW_TH), ntx = cdiv(Wo, DW_TW);
  const float* xb = x + (size_t)b * C_IN * H * W;
  const float* ab = act + (size_t)b * C_OUT * Ho * Wo;
  const float* db = dn + (size_t)b * C_OUT * Ho * Wo;

  for (int i = tid; i < 5 * C_OUT; i += NTHREADS) cf[i] = coef[i];
  int off[DW_TB];
#pragma unroll
  for (int k = 0; k < DW_TB; ++k) {
    const int t = DW_TB * tb + k;
    off[k] = t < TAPS ? ((t / KK) * DW_IR + (t % KK) / K) * DW_IC + t % K : 0;
  }
  float acc[4][DW_TB];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int k = 0; k < DW_TB; ++k) acc[j][k] = 0.f;

  for (int tile = blockIdx.x; tile < nty * ntx; tile += strips) {
    const int oy0 = (tile / ntx) * DW_TH, ox0 = (tile % ntx) * DW_TW;
    const int iy0 = 2 * oy0 - 3, ix0 = 2 * ox0 - 3;
    __syncthreads();  // the previous tile's reads are done (and cf is set)
    for (int i = tid; i < DW_XS; i += NTHREADS) {
      const int c = i / (DW_IR * DW_IC), rem = i % (DW_IR * DW_IC);
      const int yy = iy0 + rem / DW_IC, xx = ix0 + rem % DW_IC;
      xs[i] = (yy >= 0 && yy < H && xx >= 0 && xx < W)
                  ? xb[((size_t)c * H + yy) * W + xx] : 0.f;
    }
    for (int i = tid; i < DW_TP * C_OUT; i += NTHREADS) {
      const int p = i % DW_TP, o = i / DW_TP;
      const int oy = oy0 + p / DW_TW, ox = ox0 + p % DW_TW;
      float v = 0.f;
      if (oy < Ho && ox < Wo) {
        const size_t at = ((size_t)o * Ho + oy) * Wo + ox;
        v = bn_input_cotangent(ab[at], db[at], cf[o], cf[C_OUT + o],
                               cf[2 * C_OUT + o], cf[3 * C_OUT + o],
                               cf[4 * C_OUT + o]);
      }
      das[p * DW_DS + o] = v;
    }
    __syncthreads();
    for (int p = 0; p < DW_TP; ++p) {
      const float* xp = xs + 2 * (p / DW_TW) * DW_IC + 2 * (p % DW_TW);
      const float4 a4 = *reinterpret_cast<const float4*>(das + p * DW_DS +
                                                         4 * ob);
#pragma unroll
      for (int k = 0; k < DW_TB; ++k) {
        const float v = xp[off[k]];
        acc[0][k] = fmaf(a4.x, v, acc[0][k]);
        acc[1][k] = fmaf(a4.y, v, acc[1][k]);
        acc[2][k] = fmaf(a4.z, v, acc[2][k]);
        acc[3][k] = fmaf(a4.w, v, acc[3][k]);
      }
    }
  }
  float* out = partials + ((size_t)b * strips + blockIdx.x) * C_OUT * TAPS;
#pragma unroll
  for (int k = 0; k < DW_TB; ++k) {
    const int t = DW_TB * tb + k;
    if (t >= TAPS) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) out[(4 * ob + j) * TAPS + t] = acc[j][k];
  }
}

// ---------------------------------------------------------------------------
// 5. d_x by the transposed conv in gather form: d_x[c, y, x] = sum over o
// and the taps (ky, kx) with y + 3 - ky and x + 3 - kx even of
// d_a[o, (y + 3 - ky) / 2, (x + 3 - kx) / 2] w[o, c, ky, kx]. Tile: 16 x 64
// input pixels; each CTA writes only its own pixels. Warp w takes one row
// parity (w & 1) and one column parity ((w >> 1) & 1), so its taps are
// warp-uniform and the weight loads broadcast; lane l takes column
// 2 l + parity and four rows of that parity: 12 accumulators, and per tap
// one float4 weight load (c = 0, 1, 2, 0) and 4 d_a loads feed 12 FMAs.
// Each pixel's sum of 64 channels x 9 to 16 taps is summed in three levels
// (a channel's taps, a pass's 16 channels, the 4 passes), whose float32
// chains are at most 16 long: one chain of up to 1,024 terms put d_x
// several times further from float64 than the plain version's cuDNN call.
// Shared: the weights as [o][tap] float4 (50,176 B) and d_a for 16
// channels at a time on the tile's support, 11 x 35, zero outside the
// conv output (24,640 B).

constexpr int DX_TH = 16, DX_TW = 64;
constexpr int DX_OC = 16;               // channels of d_a per pass
constexpr int DX_DR = DX_TH / 2 + 3;    // 11 rows of d_a
constexpr int DX_DC = DX_TW / 2 + 3;    // 35 cols of d_a
constexpr int DX_DP = DX_DR * DX_DC;    // 385
constexpr size_t DX_SMEM =
    (size_t)C_OUT * KK * sizeof(float4) +
    (size_t)(DX_OC * DX_DP + 5 * C_OUT) * sizeof(float);

__global__ void __launch_bounds__(NTHREADS)
stem_conv_dx_kernel(const float* __restrict__ act,
                    const float* __restrict__ dn,
                    const float* __restrict__ coef,
                    const float* __restrict__ w, float* __restrict__ dx,
                    int H, int W, int strips) {
  extern __shared__ __align__(16) float sm[];
  float4* ws = reinterpret_cast<float4*>(sm);              // [C_OUT][KK]
  float* das = sm + 4 * C_OUT * KK;                        // [DX_OC][DX_DP]
  float* cf = das + DX_OC * DX_DP;                         // [5][C_OUT]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rp = warp & 1, cp = (warp >> 1) & 1, rg = warp >> 2;
  const int b = blockIdx.y;
  const int Ho = H / 2, Wo = W / 2;
  const int nty = cdiv(H, DX_TH), ntx = cdiv(W, DX_TW);
  const float* ab = act + (size_t)b * C_OUT * Ho * Wo;
  const float* db = dn + (size_t)b * C_OUT * Ho * Wo;

  for (int i = tid; i < C_OUT * KK; i += NTHREADS) {
    const int o = i / KK, k = i % KK;
    const float* wo = w + (size_t)o * TAPS + k;
    ws[i] = make_float4(wo[0], wo[KK], wo[2 * KK], 0.f);
  }
  for (int i = tid; i < 5 * C_OUT; i += NTHREADS) cf[i] = coef[i];

  for (int tile = blockIdx.x; tile < nty * ntx; tile += strips) {
    const int y0 = (tile / ntx) * DX_TH, x0 = (tile % ntx) * DX_TW;
    const int oy_org = y0 / 2 - 1, ox_org = x0 / 2 - 1;
    float acc[4][3];
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[q][0] = acc[q][1] = acc[q][2] = 0.f;
    for (int o0 = 0; o0 < C_OUT; o0 += DX_OC) {
      float pacc[4][3];  // this pass's channels
#pragma unroll
      for (int q = 0; q < 4; ++q) pacc[q][0] = pacc[q][1] = pacc[q][2] = 0.f;
      __syncthreads();  // the previous pass's reads of das are done
      for (int i = tid; i < DX_OC * DX_DP; i += NTHREADS) {
        const int oc = i / DX_DP, rem = i % DX_DP, o = o0 + oc;
        const int oy = oy_org + rem / DX_DC, ox = ox_org + rem % DX_DC;
        float v = 0.f;
        if (oy >= 0 && oy < Ho && ox >= 0 && ox < Wo) {
          const size_t at = ((size_t)o * Ho + oy) * Wo + ox;
          v = bn_input_cotangent(ab[at], db[at], cf[o], cf[C_OUT + o],
                                 cf[2 * C_OUT + o], cf[3 * C_OUT + o],
                                 cf[4 * C_OUT + o]);
        }
        das[i] = v;
      }
      __syncthreads();
      for (int oc = 0; oc < DX_OC; ++oc) {
        const float4* wo = ws + (o0 + oc) * KK;
        float cacc[4][3];  // one channel's taps
#pragma unroll
        for (int q = 0; q < 4; ++q) cacc[q][0] = cacc[q][1] = cacc[q][2] = 0.f;
        for (int ky = 1 - rp; ky < K; ky += 2) {
          // local d_a row of pixel q: (rp + 3 - ky) / 2 + 4 rg + q + 1
          const float* drow =
              das + oc * DX_DP + ((rp + 3 - ky) / 2 + 4 * rg + 1) * DX_DC;
          for (int kx = 1 - cp; kx < K; kx += 2) {
            const float4 wv = wo[ky * K + kx];
            const float* d = drow + lane + (cp + 3 - kx) / 2 + 1;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const float v = d[q * DX_DC];
              cacc[q][0] = fmaf(v, wv.x, cacc[q][0]);
              cacc[q][1] = fmaf(v, wv.y, cacc[q][1]);
              cacc[q][2] = fmaf(v, wv.z, cacc[q][2]);
            }
          }
        }
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int c = 0; c < C_IN; ++c) pacc[q][c] += cacc[q][c];
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int c = 0; c < C_IN; ++c) acc[q][c] += pacc[q][c];
    }
    const int xx = x0 + 2 * lane + cp;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int y = y0 + rp + 2 * (4 * rg + q);
      if (y >= H || xx >= W) continue;
#pragma unroll
      for (int c = 0; c < C_IN; ++c)
        dx[(((size_t)b * C_IN + c) * H + y) * W + xx] = acc[q][c];
    }
  }
}

template <typename F>
int set_smem(F* kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

extern "C" {

// Each launches on `stream` and returns the CUDA error of the launch (0
// when it was accepted). `strips` is the number of CTAs per image of the
// strip-walking kernels (grid (strips, B)), at most r2l_stem_tiles of that
// kernel; the partials' layouts are given with each function. `coef` rows:
// see the kernels above.

// Tiles per image of a kernel on an input of H x W (the tile shapes live
// only in this file): kernel 0 conv forward, 1 pool backward, 2 dW, 3 d_x;
// -1 for another kernel.
int r2l_stem_tiles(int kernel, int H, int W) {
  const int Ho = H / 2, Wo = W / 2;
  switch (kernel) {
    case 0: return cdiv(Ho, CF_TH) * cdiv(Wo, CF_TW);
    case 1: return cdiv(Ho / 2, PB_TH) * cdiv(Wo / 2, PB_TW);
    case 2: return cdiv(Ho, DW_TH) * cdiv(Wo, DW_TW);
    case 3: return cdiv(H, DX_TH) * cdiv(W, DX_TW);
  }
  return -1;
}

// partials: [B * strips][2][64] float64 (sum, sum of squares), or null to
// skip the statistics (eval mode).
int r2l_stem_conv_fwd(const float* x, const float* w, float* act,
                      double* partials, int B, int H, int W, int strips,
                      void* stream) {
  int err = set_smem(stem_conv_fwd_kernel, CF_SMEM);
  if (err != 0) return err;
  stem_conv_fwd_kernel<<<dim3(strips, B), NTHREADS, CF_SMEM,
                         (cudaStream_t)stream>>>(x, w, act, partials, H, W,
                                                 strips);
  return (int)cudaGetLastError();
}

int r2l_stem_bnpool(const float* act, const float* coef, float* out, int B,
                    int Ho, int Wo, void* stream) {
  const size_t n = (size_t)B * C_OUT * (Ho / 2) * (Wo / 2);
  size_t blocks = (n + NTHREADS - 1) / NTHREADS;
  if (blocks > 1048576) blocks = 1048576;
  stem_bnpool_kernel<<<(unsigned)blocks, NTHREADS, 0,
                       (cudaStream_t)stream>>>(act, coef, out, B, Ho, Wo);
  return (int)cudaGetLastError();
}

// partials: [B * 64][r2l_stem_tiles(1, 2 Ho, 2 Wo)][2] (sum of d_n, sum of
// d_n xhat), the tiles row-major.
int r2l_stem_pool_bwd(const float* act, const float* dp, const float* coef,
                      float* dn, float* partials, int B, int Ho, int Wo,
                      void* stream) {
  const int Hq = Ho / 2, Wq = Wo / 2;
  const dim3 grid(cdiv(Wq, PB_TW), cdiv(Hq, PB_TH), B * C_OUT);
  stem_pool_bwd_kernel<<<grid, NTHREADS, 0, (cudaStream_t)stream>>>(
      act, dp, coef, dn, partials, Ho, Wo);
  return (int)cudaGetLastError();
}

// partials: [B * strips][64][147] (dW in OIHW order per CTA).
int r2l_stem_conv_dw(const float* x, const float* act, const float* dn,
                     const float* coef, float* partials, int B, int H, int W,
                     int strips, void* stream) {
  int err = set_smem(stem_conv_dw_kernel, DW_SMEM);
  if (err != 0) return err;
  stem_conv_dw_kernel<<<dim3(strips, B), NTHREADS, DW_SMEM,
                        (cudaStream_t)stream>>>(x, act, dn, coef, partials,
                                                H, W, strips);
  return (int)cudaGetLastError();
}

int r2l_stem_conv_dx(const float* act, const float* dn, const float* coef,
                     const float* w, float* dx, int B, int H, int W,
                     int strips, void* stream) {
  int err = set_smem(stem_conv_dx_kernel, DX_SMEM);
  if (err != 0) return err;
  stem_conv_dx_kernel<<<dim3(strips, B), NTHREADS, DX_SMEM,
                        (cudaStream_t)stream>>>(act, dn, coef, w, dx, H, W,
                                                strips);
  return (int)cudaGetLastError();
}

const char* r2l_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
