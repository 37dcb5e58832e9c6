// Fused raw->RGB ISP forward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernels raw2logit_tpu/pallas/fused_isp.py::_isp_kernel
// (serving, r2l_fused_isp_fwd) and ::_isp_kernel_train (training,
// r2l_fused_isp_fwd_train: the same kernel, which also stores the residual
// planes the backward kernel reads). Per image, in f32:
//   x   = raw - black_level[RGGB site]
//   deb = 3x3 debayer correlation of the scattered mosaic, torch-'reflect'
//         padded (row/col -1 -> 1, n -> n-2), kernel K[tap][ci*3+co]
//   yuv = A . deb with A = M_RGB2YUV . CCM . diag(WB) (packed on the host)
//   s   = 3x3 sharpen of Y, ZERO padded (Y outside the image is 0)
//   t   = 5x5 blur of s, REFLECT padded (s[-1] = s[1], s[-2] = s[2])
//   out = exp(log(clip(M_YUV2RGB . (t, U, V), 1e-5, 1)) * (1 / gamma))
// Input raw (B, H, W) f32; output planar RGB (B, 3, H, W) f32 and, for
// training, res (B, 5, H, W) = [deb0, deb1, deb2, s, t].
//
// Bound on an H100: memory. Serving reads 4 B and writes 12 B per pixel
// (16 B; 268 MB at B = 256, 256x256, ~80 us at 3.35 TB/s); training also
// writes 20 B of residuals (36 B, ~180 us). Both do about 174 f32
// operations and 6 transcendentals per pixel, well under the card's
// non-tensor f32 rate for that time.
//
// The first port (a CTA per 32x32 tile, 16,384 CTAs at B = 256) was held
// by instructions, not bytes: every FMA took its weight from shared memory
// (the debayer's at an index that depends on the site's RGGB parity), so
// about 230 shared loads per pixel against about 100 FFMA; the debayer ran
// a second time at every pixel for U and V (about 2.4 times per pixel in
// all); the mosaic was staged on tile+-4 (1.56x the tile) by scalar loads
// through the reflect, Y computed on tile+-3 (1.41x) and s on tile+-2
// (1.27x). It read 0.455 ms serving and 0.520 ms training at B = 256.
//
// Design:
// - Weights in the constant bank (c_p, 138 floats), copied device to
//   device by cudaMemcpyToSymbolAsync on the launch's stream just before
//   each launch, so that the copy is ordered after the last launch that
//   read it and before this one. Every launch of the port is on the
//   caller's current stream behind its own copy, so the copy cannot race a
//   launch with other parameters. A weight whose index is known at
//   compile time is an operand of the FFMA itself: no load.
// - Each thread computes a 2x2 quad of sites in every stage, so that every
//   site's RGGB parity, and with it every debayer weight's index, is fixed
//   at compile time; a staged 4x4 (debayer, sharpen) or 6x6 (blur) block
//   of loads (8-byte shared loads) feeds the four sites' taps.
// - The debayer runs once per site: the pass that makes Y on tile+-3 also
//   makes U and V (and, for training, stores deb) on the tile's own sites.
// - Tiles of 32 x 64 pixels (Y on 1.30x the tile, s on 1.20x, the mosaic
//   on 1.41x); a persistent grid of FWD_CTAS CTAs per SM, CTA k taking the
//   run of tiles [k n / grid, (k + 1) n / grid) over (b, tile row, tile
//   col) in order. Each tile's mosaic is staged by cp.async into a double
//   buffer, 16-byte copies where rows are 16-byte aligned (W % 4 == 0),
//   while the CTA computes the tile before it; the reflect pad is copied
//   in shared memory afterwards, and only on tiles at the image border.
//   The blur reads its 6x6 block directly where it lies inside the image,
//   and reflected indices only at the border.
// Every stage pads at the IMAGE border, not the tile border: Y is 0
// outside the image, and the blur reads s at reflected in-image positions,
// which always fall inside the tile+-2 region.
//
// Every sum is the fmaf chain of fused_isp_common.cuh (debayer_at,
// mix_row, sharpen_at, blur_at) in the same order, so deb, Y, s and t are
// bitwise those of the backward kernel's recompute. No fast math:
// expf/logf, and 1/gamma kept as a multiply as on the TPU.

#include <cstdint>

#include "fused_isp_common.cuh"
#include "kernel_info.cuh"

namespace {

using namespace r2l;

__constant__ float c_p[P_COUNT];

constexpr int TH = 32, TW = 64;          // output tile
constexpr int XR = TH + 8, XC = TW + 8;  // mosaic (raw) on tile+-4
constexpr int YR = TH + 6, YC = TW + 6;  // luma Y on tile+-3
constexpr int SR = TH + 4, SC = TW + 4;  // sharpened luma s on tile+-2
constexpr int FWD_CTAS = 3;              // CTAs per SM
constexpr size_t FWD_SMEM =
    (size_t)(2 * XR * XC + YR * YC + SR * SC + 2 * TH * TW) * sizeof(float);

__host__ __device__ constexpr int cdiv(int a, int b) {
  return (a + b - 1) / b;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// mix_row of the constant bank's 3x3 matrix row at OFF.
template <int OFF>
__device__ __forceinline__ float mixc(float a, float b, float c) {
  return fmaf(c_p[OFF + 2], c, fmaf(c_p[OFF + 1], b, c_p[OFF] * a));
}

// Row i of a 4-wide block at `src` (8-byte aligned) into v.
__device__ __forceinline__ void load4(const float* src, float (&v)[4]) {
  const float2 a = *reinterpret_cast<const float2*>(src);
  const float2 b = *reinterpret_cast<const float2*>(src + 2);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}

template <bool kRes, bool kVec>
__global__ void __launch_bounds__(NTHREADS, FWD_CTAS)
fused_isp_fwd_kernel(const float* __restrict__ raw, float* __restrict__ out,
                     float* __restrict__ res, int B, int H, int W) {
  extern __shared__ __align__(16) float sm[];
  float* const xbuf = sm;               // [2][XR][XC], origin (r0-4, c0-4)
  float* const ys = sm + 2 * XR * XC;   // [YR][YC], origin (r0-3, c0-3)
  float* const ss = ys + YR * YC;       // [SR][SC], origin (r0-2, c0-2)
  float* const us = ss + SR * SC;       // [TH][TW], origin (r0, c0)
  float* const vs = us + TH * TW;

  const int tid = threadIdx.x;
  const int ntc = cdiv(W, TW), per_image = cdiv(H, TH) * ntc;
  const long long n = (long long)B * per_image;
  const long long t_begin = blockIdx.x * n / gridDim.x;
  const long long t_end = (blockIdx.x + 1) * n / gridDim.x;
  const size_t plane = (size_t)H * W;
  const float inv_g = 1.0f / c_p[P_GAMMA];

  auto origin = [&](long long t, int& b, int& r0, int& c0) {
    b = (int)(t / per_image);
    const int tile = (int)(t - (long long)b * per_image);
    r0 = (tile / ntc) * TH;
    c0 = (tile % ntc) * TW;
  };
  // The raw mosaic on tile+-4, 0 outside the image.
  auto fetch = [&](long long t, float* xs) {
    int b, r0, c0;
    origin(t, b, r0, c0);
    const float* img = raw + (size_t)b * plane;
    if (kVec) {
      for (int i = tid; i < XR * (XC / 4); i += NTHREADS) {
        const int rr = i / (XC / 4), cq = i - rr * (XC / 4);
        const int r = r0 - 4 + rr, c = c0 - 4 + 4 * cq;
        const bool in = r >= 0 && r < H && c >= 0 && c < W;
        cp_async16(xs + rr * XC + 4 * cq, in ? img + (size_t)r * W + c : img,
                   in);
      }
    } else {
      for (int i = tid; i < XR * XC; i += NTHREADS) {
        const int rr = i / XC, cc = i - rr * XC;
        const int r = r0 - 4 + rr, c = c0 - 4 + cc;
        const bool in = r >= 0 && r < H && c >= 0 && c < W;
        cp_async4(xs + i, in ? img + (size_t)r * W + c : img, in);
      }
    }
  };

  if (t_begin < t_end) fetch(t_begin, xbuf);
  cp_async_commit();
  for (long long t = t_begin; t < t_end; ++t) {
    float* const xs = xbuf + ((t - t_begin) & 1) * XR * XC;
    cp_async_wait_all();
    __syncthreads();  // this tile's mosaic landed; the last tile is done
    if (t + 1 < t_end) fetch(t + 1, xbuf + ((t + 1 - t_begin) & 1) * XR * XC);
    cp_async_commit();
    int b, r0, c0;
    origin(t, b, r0, c0);
    float* const rb = res + (size_t)b * 5 * plane;

    // 0. At the image border: rows and columns -1 and H (W) take the
    //    debayer's reflect pad (mosaic_at), copied from inside the image.
    if (r0 == 0 || c0 == 0 || r0 + TH + 4 > H || c0 + TW + 4 > W) {
      for (int i = tid; i < 2 * (XR + XC); i += NTHREADS) {
        int r, c;
        if (i < 2 * XC) {
          r = i < XC ? -1 : H;
          c = c0 - 4 + i % XC;
        } else {
          c = i < 2 * XC + XR ? -1 : W;
          r = r0 - 4 + (i - 2 * XC) % XR;
        }
        const int rr = r - (r0 - 4), cc = c - (c0 - 4);
        if (rr < 0 || rr >= XR || cc < 0 || cc >= XC || r < -1 || r > H ||
            c < -1 || c > W)
          continue;
        xs[rr * XC + cc] = xs[(reflect(r, H) - (r0 - 4)) * XC +
                              reflect(c, W) - (c0 - 4)];
      }
      __syncthreads();
    }

    // 1. Debayer on tile+-3 in quads from (r0-3, c0-3): Y there (0 outside
    //    the image), U and V (and deb) on the tile's own sites. A quad's
    //    4x4 block of x starts at an even image row and column, so the
    //    parity of every tap is static.
    for (int q = tid; q < (YR / 2) * (YC / 2); q += NTHREADS) {
      const int qr = q / (YC / 2), qc = q - qr * (YC / 2);
      float x[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        load4(xs + (2 * qr + i) * XC + 2 * qc, x[i]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          x[i][j] = x[i][j] - c_p[P_BL + (i & 1) * 2 + (j & 1)];
      }
#pragma unroll
      for (int di = 0; di < 2; ++di) {
        float yv[2];
#pragma unroll
        for (int dj = 0; dj < 2; ++dj) {
          // debayer_at: taps (i, j) row-major from 0
          float d0 = 0.f, d1 = 0.f, d2 = 0.f;
#pragma unroll
          for (int i = 0; i < 3; ++i) {
#pragma unroll
            for (int j = 0; j < 3; ++j) {
              const float xv = x[di + i][dj + j];
              const int k = P_KDEB + (i * 3 + j) * 9 +
                            (((di + i) & 1) + ((dj + j) & 1)) * 3;
              d0 = fmaf(c_p[k], xv, d0);
              d1 = fmaf(c_p[k + 1], xv, d1);
              d2 = fmaf(c_p[k + 2], xv, d2);
            }
          }
          const int r = r0 - 3 + 2 * qr + di, c = c0 - 3 + 2 * qc + dj;
          const bool in = r >= 0 && r < H && c >= 0 && c < W;
          yv[dj] = in ? mixc<P_A>(d0, d1, d2) : 0.f;
          const int tr = r - r0, tc = c - c0;
          if (in && tr >= 0 && tr < TH && tc >= 0 && tc < TW) {
            us[tr * TW + tc] = mixc<P_A + 3>(d0, d1, d2);
            vs[tr * TW + tc] = mixc<P_A + 6>(d0, d1, d2);
            if (kRes) {
              float* p = rb + (size_t)r * W + c;
              p[0] = d0;
              p[plane] = d1;
              p[2 * plane] = d2;
            }
          }
        }
        *reinterpret_cast<float2*>(ys + (2 * qr + di) * YC + 2 * qc) =
            make_float2(yv[0], yv[1]);
      }
    }
    __syncthreads();

    // 2. Sharpen on tile+-2 in quads from (r0-2, c0-2) (sharpen_at).
    for (int q = tid; q < (SR / 2) * (SC / 2); q += NTHREADS) {
      const int qr = q / (SC / 2), qc = q - qr * (SC / 2);
      float y[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) load4(ys + (2 * qr + i) * YC + 2 * qc, y[i]);
#pragma unroll
      for (int di = 0; di < 2; ++di) {
        float sv[2];
#pragma unroll
        for (int dj = 0; dj < 2; ++dj) {
          float s = 0.f;
#pragma unroll
          for (int a = 0; a < 3; ++a)
#pragma unroll
            for (int bb = 0; bb < 3; ++bb)
              s = fmaf(c_p[P_KSHARP + a * 3 + bb], y[di + a][dj + bb], s);
          sv[dj] = s;
          const int r = r0 - 2 + 2 * qr + di, c = c0 - 2 + 2 * qc + dj;
          if (kRes && r >= r0 && r < r0 + TH && r < H && c >= c0 &&
              c < c0 + TW && c < W)
            rb[3 * plane + (size_t)r * W + c] = s;
        }
        *reinterpret_cast<float2*>(ss + (2 * qr + di) * SC + 2 * qc) =
            make_float2(sv[0], sv[1]);
      }
    }
    __syncthreads();

    // 3. Blur (blur_at), chroma, YUV->RGB, clip and gamma on the tile, in
    //    quads from (r0, c0).
    for (int q = tid; q < (TH / 2) * (TW / 2); q += NTHREADS) {
      const int qr = q / (TW / 2), qc = q - qr * (TW / 2);
      const int r = r0 + 2 * qr, c = c0 + 2 * qc;  // the quad's first site
      if (r >= H || c >= W) continue;
      float tv[2][2];
      if (r >= 2 && r + 3 < H && c >= 2 && c + 3 < W) {
        float sb[6][6];
#pragma unroll
        for (int i = 0; i < 6; ++i) {
          const float* src = ss + (2 * qr + i) * SC + 2 * qc;
#pragma unroll
          for (int j = 0; j < 6; j += 2) {
            const float2 v = *reinterpret_cast<const float2*>(src + j);
            sb[i][j] = v.x;
            sb[i][j + 1] = v.y;
          }
        }
#pragma unroll
        for (int di = 0; di < 2; ++di)
#pragma unroll
          for (int dj = 0; dj < 2; ++dj) {
            float tt = 0.f;
#pragma unroll
            for (int a = 0; a < 5; ++a)
#pragma unroll
              for (int bb = 0; bb < 5; ++bb)
                tt = fmaf(c_p[P_KBLUR + a * 5 + bb], sb[di + a][dj + bb], tt);
            tv[di][dj] = tt;
          }
      } else {
#pragma unroll
        for (int di = 0; di < 2; ++di)
#pragma unroll
          for (int dj = 0; dj < 2; ++dj) {
            int rows[5], cols[5];
#pragma unroll
            for (int k = 0; k < 5; ++k) {
              rows[k] = reflect(min(r + di, H - 1) + k - 2, H) - (r0 - 2);
              cols[k] = reflect(min(c + dj, W - 1) + k - 2, W) - (c0 - 2);
            }
            float tt = 0.f;
#pragma unroll
            for (int a = 0; a < 5; ++a)
#pragma unroll
              for (int bb = 0; bb < 5; ++bb)
                tt = fmaf(c_p[P_KBLUR + a * 5 + bb],
                          ss[rows[a] * SC + cols[bb]], tt);
            tv[di][dj] = tt;
          }
      }
#pragma unroll
      for (int di = 0; di < 2; ++di) {
        if (r + di >= H) break;
        const int tr = 2 * qr + di;
        const float2 u2 =
            *reinterpret_cast<const float2*>(us + tr * TW + 2 * qc);
        const float2 v2 =
            *reinterpret_cast<const float2*>(vs + tr * TW + 2 * qc);
        const float uu[2] = {u2.x, u2.y}, vv[2] = {v2.x, v2.y};
        float o[3][2];
#pragma unroll
        for (int dj = 0; dj < 2; ++dj) {
          const float pre[3] = {
              mixc<P_MINV>(tv[di][dj], uu[dj], vv[dj]),
              mixc<P_MINV + 3>(tv[di][dj], uu[dj], vv[dj]),
              mixc<P_MINV + 6>(tv[di][dj], uu[dj], vv[dj])};
#pragma unroll
          for (int ch = 0; ch < 3; ++ch)
            o[ch][dj] = expf(logf(clip(pre[ch])) * inv_g);
        }
        const size_t at = (size_t)(r + di) * W + c;
        float* const ob = out + (size_t)b * 3 * plane + at;
        if (kVec) {
#pragma unroll
          for (int ch = 0; ch < 3; ++ch)
            *reinterpret_cast<float2*>(ob + ch * plane) =
                make_float2(o[ch][0], o[ch][1]);
          if (kRes)
            *reinterpret_cast<float2*>(rb + 4 * plane + at) =
                make_float2(tv[di][0], tv[di][1]);
        } else {
#pragma unroll
          for (int dj = 0; dj < 2; ++dj) {
            if (c + dj >= W) break;
#pragma unroll
            for (int ch = 0; ch < 3; ++ch) ob[ch * plane + dj] = o[ch][dj];
            if (kRes) rb[4 * plane + at + dj] = tv[di][dj];
          }
        }
      }
    }
  }
}

// Grid: FWD_CTAS CTAs per SM of the current device, at most one per tile.
int grid_for(int B, int H, int W) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  const long long tiles = (long long)B * cdiv(H, TH) * cdiv(W, TW);
  const long long most = (long long)FWD_CTAS * sms;
  return (int)(tiles < most ? tiles : most);
}

template <bool kRes>
int launch(const float* raw, const float* params, float* out, float* res,
           int B, int H, int W, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  int err = (int)cudaMemcpyToSymbolAsync(c_p, params, P_COUNT * sizeof(float),
                                         0, cudaMemcpyDeviceToDevice, st);
  if (err != 0) return err;
  const bool vec = W % 4 == 0 && (uintptr_t)raw % 16 == 0 &&
                   ((uintptr_t)out | (uintptr_t)res) % 8 == 0;
  auto kernel = vec ? fused_isp_fwd_kernel<kRes, true>
                    : fused_isp_fwd_kernel<kRes, false>;
  err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)FWD_SMEM);
  if (err != 0) return err;
  const int grid = grid_for(B, H, W);
  if (grid == 0) return (int)cudaGetLastError();
  kernel<<<grid, NTHREADS, FWD_SMEM, st>>>(raw, out, res, B, H, W);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Both launch on `stream` (the parameters' copy into the constant bank
// first) and return the CUDA error of the copy or the launch.
int r2l_fused_isp_fwd(const float* raw, const float* params, float* out,
                      int B, int H, int W, void* stream) {
  return launch<false>(raw, params, out, nullptr, B, H, W, stream);
}

int r2l_fused_isp_fwd_train(const float* raw, const float* params,
                            float* out, float* res, int B, int H, int W,
                            void* stream) {
  return launch<true>(raw, params, out, res, B, H, W, stream);
}

// Kernel `which` of this file (0 serving, 1 training, 2 and 3 their forms
// for rows that are not 16-byte aligned): its name, registers per thread,
// CTAs per SM and shared bytes per CTA (kernel_info.cuh); null past the
// last or on an error.
const char* r2l_kernel_info(int which, int* regs, int* ctas_per_sm,
                            int* smem) {
  switch (which) {
    case 0: return r2l_occupancy(
        (const void*)fused_isp_fwd_kernel<false, true>,
        "fused_isp_fwd_kernel<false>", NTHREADS, FWD_SMEM, regs,
        ctas_per_sm, smem);
    case 1: return r2l_occupancy(
        (const void*)fused_isp_fwd_kernel<true, true>,
        "fused_isp_fwd_kernel<true>", NTHREADS, FWD_SMEM, regs, ctas_per_sm,
        smem);
    case 2: return r2l_occupancy(
        (const void*)fused_isp_fwd_kernel<false, false>,
        "fused_isp_fwd_kernel<false, false>", NTHREADS, FWD_SMEM, regs,
        ctas_per_sm, smem);
    case 3: return r2l_occupancy(
        (const void*)fused_isp_fwd_kernel<true, false>,
        "fused_isp_fwd_kernel<true, false>", NTHREADS, FWD_SMEM, regs,
        ctas_per_sm, smem);
  }
  return nullptr;
}

const char* r2l_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
