// Fused ISP backward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernels raw2logit_tpu/pallas/fused_isp_bwd.py::
// _bwd_kernel_res (the forward's intermediates read from the residual
// planes that r2l_fused_isp_fwd_train stored) and ::_bwd_kernel (the same
// backward with the forward recomputed from the raw mosaic): one template,
// kRes. Given the planar RGB cotangent g (B, 3, H, W), it writes d_raw
// (B, H, W) and, per CTA, the partial sums of the 129 parameter-gradient
// scalars in the layout of fused_isp_bwd.py:188-194: dK_blur 25,
// dK_sharp 9, dA 9 (k*3+c), dK_debayer 81 (tap*9+ci*3+co),
// d_black_level 4, d_gamma 1. The wrapper sums them over CTAs and chains
// dA into the white balance and CCM.
//
// Adjoint chain, per pixel (forward math in fused_isp_common.cuh):
//   dv   = g * out / (gamma * clip(v)), zero where v is outside
//          [1e-5, 1] (inclusive at both bounds, as torch.clamp)
//   dt, dU, dV = M_YUV2RGB^T . dv
//   ds   = reflect-2 adjoint of the blur: sum of K_blur[a,b] dt[p] over
//          the (p, a, b) with reflect(p + (a,b) - 2) == r
//   dY   = zero-pad adjoint of the sharpen (full correlation, cropped)
//   ddeb = A^T . (dY, dU, dV)
//   d_raw = reflect-1 adjoint of the debayer; the source site's RGGB
//          channel is known, so 9 taps x 3 channels per pixel
// Every adjoint is a GATHER (each pixel collects what it fed), so each CTA
// writes only its own pixels and nothing is accumulated across CTAs.
// Reflect adjoints gather from the image positions m that read a pixel q:
// q itself, -q (q <= pad) and 2n-2-q (q >= n-1-pad); every contributing
// in-image p lies within q +- pad.
//
// Halos, for one CTA of 256 threads per 32x32 tile: dt (hence g, deb and
// t) on tile+-4, ds on tile+-2, dY and ddeb on tile+-1, d_raw on the tile.
// With residuals: deb and t on tile+-4 and s on tile+-2 are loaded; the
// mosaic on tile+-1 (for dK_debayer). Recompute: the forward runs again
// on mosaic tile+-8 -> Y tile+-7 -> s tile+-6 -> deb, t tile+-4, with the
// forward kernel's own device functions, so both variants see bitwise
// the same intermediates. Planes are in dynamic shared memory (82 KB with
// residuals, 97 KB without), above the 48 KB of static shared memory.
//
// Parameter partials: each thread sums its own 4 pixels (rows warp + 8k,
// column lane), so all its pixels share one RGGB site class. A group of
// sums is reduced by warp shuffles over lanes of one column parity, then
// across warps in shared memory, in a fixed order: run-to-run identical.
// dK_debayer needs only the 27 products of the thread's class.
//
// Bound on an H100. The residual variant must read raw 4, g 12, res 20 B and
// write d_raw 4 B per pixel (40 B; 671 MB at B = 256, 256x256, ~0.20 ms
// at 3.35 TB/s); the recompute variant reads no res (20 B). It does 386
// f32 operations per pixel with residuals and 515 with the recompute
// (counted in chip_smoke.py), so the recompute variant is bound by
// operations at the card's non-tensor f32 rate, the residual one by bytes.
//
// No fast math: expf/logf as in the forward.

#include "fused_isp_common.cuh"
#include "kernel_info.cuh"

namespace {

using namespace r2l;

constexpr int Q_DKBLUR = 0;
constexpr int Q_DKSHARP = 25;
constexpr int Q_DA = 34;
constexpr int Q_DKDEB = 43;
constexpr int Q_DBL = 124;
constexpr int Q_DGAMMA = 128;
constexpr int N_PARTIALS = 129;

__host__ __device__ constexpr int area(int halo) {
  return (TILE + 2 * halo) * (TILE + 2 * halo);
}

// Float offsets of the planes in dynamic shared memory.
template <bool kRes>
struct Layout {
  static constexpr int HX = kRes ? 1 : 8;  // mosaic
  static constexpr int HY = 7;             // luma Y (recompute only)
  static constexpr int HS = kRes ? 2 : 6;  // sharpened luma s
  static constexpr int P = 0;
  static constexpr int XS = P + 144;
  static constexpr int YS = XS + area(HX);
  static constexpr int SS = YS + (kRes ? 0 : area(HY));
  static constexpr int DEB = SS + area(HS);  // 3 planes, tile+-4
  static constexpr int T = DEB + 3 * area(4);
  static constexpr int DT = T + area(4);
  static constexpr int DU = DT + area(4);  // tile+-1
  static constexpr int DV = DU + area(1);
  static constexpr int DS = DV + area(1);  // tile+-2
  static constexpr int DY = DS + area(2);  // tile+-1
  static constexpr int Y1 = DY + area(1);
  static constexpr int DDEB = Y1 + area(1);  // 3 planes, tile+-1
  static constexpr int RED = DDEB + 3 * area(1);
  static constexpr int TOTAL = RED + 16 * 28;
  static constexpr size_t BYTES = TOTAL * sizeof(float);
};

__device__ __forceinline__ bool in_image(int r, int c, int H, int W) {
  return r >= 0 && r < H && c >= 0 && c < W;
}

// Mirror e (0, 1, 2) of image index q under a torch-'reflect' pad of
// width `pad`: the padded index that reads q, if there is one.
__device__ __forceinline__ bool mirror(int q, int e, int n, int pad, int& m) {
  if (e == 0) {
    m = q;
    return true;
  }
  if (e == 1) {
    m = -q;
    return q >= 1 && q <= pad;
  }
  m = 2 * n - 2 - q;
  return q <= n - 2 && q >= n - 1 - pad;
}

// Each thread's G sums, added over the lanes of one column parity of its
// warp: red[(warp*2 + parity)*G + j]. The caller synchronises.
template <int G>
__device__ __forceinline__ void reduce_pairs(const float (&v)[G],
                                             float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < G; ++j) {
    float x = v[j];
    x += __shfl_xor_sync(0xffffffffu, x, 16);
    x += __shfl_xor_sync(0xffffffffu, x, 8);
    x += __shfl_xor_sync(0xffffffffu, x, 4);
    x += __shfl_xor_sync(0xffffffffu, x, 2);
    if (lane < 2) red[(warp * 2 + lane) * G + j] = x;
  }
}

template <bool kRes>
__global__ void __launch_bounds__(NTHREADS)
fused_isp_bwd_kernel(const float* __restrict__ raw,
                     const float* __restrict__ g,
                     const float* __restrict__ res,
                     const float* __restrict__ params,
                     float* __restrict__ d_raw,
                     float* __restrict__ partials, int H, int W) {
  using L = Layout<kRes>;
  extern __shared__ float sm[];
  float* p = sm + L::P;
  float* red = sm + L::RED;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = blockIdx.y * TILE;
  const int c0 = blockIdx.x * TILE;
  const size_t plane = (size_t)H * W;
  const float* img = raw + blockIdx.z * plane;
  const float* gi = g + blockIdx.z * 3 * plane;
  const Plane xs = make_plane(sm + L::XS, r0, c0, L::HX);
  const Plane ss = make_plane(sm + L::SS, r0, c0, L::HS);
  const Plane deb[3] = {make_plane(sm + L::DEB, r0, c0, 4),
                        make_plane(sm + L::DEB + area(4), r0, c0, 4),
                        make_plane(sm + L::DEB + 2 * area(4), r0, c0, 4)};
  const Plane tt = make_plane(sm + L::T, r0, c0, 4);
  const Plane dt = make_plane(sm + L::DT, r0, c0, 4);
  const Plane du = make_plane(sm + L::DU, r0, c0, 1);
  const Plane dv = make_plane(sm + L::DV, r0, c0, 1);
  const Plane ds = make_plane(sm + L::DS, r0, c0, 2);
  const Plane dy = make_plane(sm + L::DY, r0, c0, 1);
  const Plane y1 = make_plane(sm + L::Y1, r0, c0, 1);
  const Plane ddeb[3] = {make_plane(sm + L::DDEB, r0, c0, 1),
                         make_plane(sm + L::DDEB + area(1), r0, c0, 1),
                         make_plane(sm + L::DDEB + 2 * area(1), r0, c0, 1)};

  for (int i = tid; i < P_COUNT; i += NTHREADS) p[i] = params[i];
  __syncthreads();

  // 1. The forward's intermediates: mosaic, then deb and t on tile+-4 and
  //    s on tile+-HS (zero outside the image).
  for (int i = tid; i < area(L::HX); i += NTHREADS) {
    const int r = xs.r0 + i / xs.size, c = xs.c0 + i % xs.size;
    xs.at(r, c) = mosaic_at(img, p, r, c, H, W);
  }
  if constexpr (kRes) {
    const float* ri = res + blockIdx.z * 5 * plane;
    for (int i = tid; i < area(4); i += NTHREADS) {
      const int r = tt.r0 + i / tt.size, c = tt.c0 + i % tt.size;
      const bool in = in_image(r, c, H, W);
      const size_t at = in ? (size_t)r * W + c : 0;
#pragma unroll
      for (int k = 0; k < 3; ++k) deb[k].at(r, c) = in ? ri[k * plane + at] : 0.f;
      tt.at(r, c) = in ? ri[4 * plane + at] : 0.f;
    }
    for (int i = tid; i < area(L::HS); i += NTHREADS) {
      const int r = ss.r0 + i / ss.size, c = ss.c0 + i % ss.size;
      ss.at(r, c) = in_image(r, c, H, W) ? ri[3 * plane + (size_t)r * W + c]
                                         : 0.f;
    }
    __syncthreads();
  } else {
    __syncthreads();
    const Plane ys = make_plane(sm + L::YS, r0, c0, L::HY);
    for (int i = tid; i < area(L::HY); i += NTHREADS) {
      const int r = ys.r0 + i / ys.size, c = ys.c0 + i % ys.size;
      float y = 0.f;
      if (in_image(r, c, H, W)) {
        float d0, d1, d2;
        debayer_at(xs, r, c, p, d0, d1, d2);
        y = mix_row(p + P_A, d0, d1, d2);
      }
      ys.at(r, c) = y;
    }
    __syncthreads();
    for (int i = tid; i < area(L::HS); i += NTHREADS) {
      const int r = ss.r0 + i / ss.size, c = ss.c0 + i % ss.size;
      ss.at(r, c) = in_image(r, c, H, W) ? sharpen_at(ys, r, c, p) : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < area(4); i += NTHREADS) {
      const int r = tt.r0 + i / tt.size, c = tt.c0 + i % tt.size;
      float d0 = 0.f, d1 = 0.f, d2 = 0.f, t = 0.f;
      if (in_image(r, c, H, W)) {
        debayer_at(xs, r, c, p, d0, d1, d2);
        t = blur_at(ss, r, c, H, W, p);
      }
      deb[0].at(r, c) = d0;
      deb[1].at(r, c) = d1;
      deb[2].at(r, c) = d2;
      tt.at(r, c) = t;
    }
    __syncthreads();
  }

  // 2. dv on tile+-4 -> dt there, dU and dV on tile+-1; d_gamma over the
  //    tile's own pixels.
  const float inv_g = 1.0f / p[P_GAMMA];
  float dgamma = 0.f;
  for (int i = tid; i < area(4); i += NTHREADS) {
    const int r = dt.r0 + i / dt.size, c = dt.c0 + i % dt.size;
    float dtv = 0.f, duv = 0.f, dvv = 0.f;
    if (in_image(r, c, H, W)) {
      const float d0 = deb[0].at(r, c), d1 = deb[1].at(r, c),
                  d2 = deb[2].at(r, c);
      const float t = tt.at(r, c);
      const float u = mix_row(p + P_A + 3, d0, d1, d2);
      const float v = mix_row(p + P_A + 6, d0, d1, d2);
      const bool own = r >= r0 && r < r0 + TILE && c >= c0 && c < c0 + TILE;
      const size_t at = (size_t)r * W + c;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        const float pre = pre_clip(p, ch, t, u, v);
        const float cl = clip(pre);
        const float lg = logf(cl);
        const float o = expf(lg * inv_g);
        const float gg = gi[ch * plane + at];
        const float dvc =
            (pre >= 1e-5f && pre <= 1.0f) ? gg * (o * inv_g / cl) : 0.f;
        if (own) dgamma += gg * o * (-lg) * inv_g * inv_g;
        dtv = fmaf(p[P_MINV + ch * 3 + 0], dvc, dtv);
        duv = fmaf(p[P_MINV + ch * 3 + 1], dvc, duv);
        dvv = fmaf(p[P_MINV + ch * 3 + 2], dvc, dvv);
      }
    }
    dt.at(r, c) = dtv;
    if (r >= r0 - 1 && r <= r0 + TILE && c >= c0 - 1 && c <= c0 + TILE) {
      du.at(r, c) = duv;
      dv.at(r, c) = dvv;
    }
  }
  __syncthreads();

  // 3. ds on tile+-2: the blur's reflect-2 adjoint, gathered.
  for (int i = tid; i < area(2); i += NTHREADS) {
    const int r = ds.r0 + i / ds.size, c = ds.c0 + i % ds.size;
    float acc = 0.f;
    if (in_image(r, c, H, W)) {
      for (int er = 0; er < 3; ++er) {
        int mr;
        if (!mirror(r, er, H, 2, mr)) continue;
        for (int ec = 0; ec < 3; ++ec) {
          int mc;
          if (!mirror(c, ec, W, 2, mc)) continue;
#pragma unroll
          for (int a = 0; a < 5; ++a) {
            const int pr = mr - a + 2;
            if (pr < 0 || pr >= H) continue;
#pragma unroll
            for (int b = 0; b < 5; ++b) {
              const int pc = mc - b + 2;
              if (pc < 0 || pc >= W) continue;
              acc = fmaf(p[P_KBLUR + a * 5 + b], dt.at(pr, pc), acc);
            }
          }
        }
      }
    }
    ds.at(r, c) = acc;
  }
  __syncthreads();

  // 4. On tile+-1: dY (the sharpen's zero-pad adjoint), Y, and
  //    ddeb = A^T . (dY, dU, dV).
  for (int i = tid; i < area(1); i += NTHREADS) {
    const int r = dy.r0 + i / dy.size, c = dy.c0 + i % dy.size;
    float dyv = 0.f, yv = 0.f, dd[3] = {0.f, 0.f, 0.f};
    if (in_image(r, c, H, W)) {
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const int pr = r - a + 1;
        if (pr < 0 || pr >= H) continue;
#pragma unroll
        for (int b = 0; b < 3; ++b) {
          const int pc = c - b + 1;
          if (pc < 0 || pc >= W) continue;
          dyv = fmaf(p[P_KSHARP + a * 3 + b], ds.at(pr, pc), dyv);
        }
      }
      yv = mix_row(p + P_A, deb[0].at(r, c), deb[1].at(r, c),
                   deb[2].at(r, c));
      const float duv = du.at(r, c), dvv = dv.at(r, c);
#pragma unroll
      for (int co = 0; co < 3; ++co)
        dd[co] = fmaf(p[P_A + 6 + co], dvv,
                      fmaf(p[P_A + 3 + co], duv, p[P_A + co] * dyv));
    }
    dy.at(r, c) = dyv;
    y1.at(r, c) = yv;
#pragma unroll
    for (int co = 0; co < 3; ++co) ddeb[co].at(r, c) = dd[co];
  }
  __syncthreads();

  float* part = partials + ((size_t)(blockIdx.z * gridDim.y + blockIdx.y) *
                                gridDim.x + blockIdx.x) * N_PARTIALS;

  // 5. Own pixels: d_raw (the debayer's reflect-1 adjoint), d_black_level
  //    and dK_debayer.
  {
    float acc[28];
#pragma unroll
    for (int j = 0; j < 28; ++j) acc[j] = 0.f;
    for (int k = 0; k < TILE * TILE / NTHREADS; ++k) {
      const int r = r0 + warp + 8 * k, c = c0 + lane;
      if (r >= H || c >= W) continue;
      const int ch = site_channel(r, c);
      float dx = 0.f;
      for (int er = 0; er < 3; ++er) {
        int mr;
        if (!mirror(r, er, H, 1, mr)) continue;
        for (int ec = 0; ec < 3; ++ec) {
          int mc;
          if (!mirror(c, ec, W, 1, mc)) continue;
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            const int pr = mr - i + 1;
            if (pr < 0 || pr >= H) continue;
#pragma unroll
            for (int j = 0; j < 3; ++j) {
              const int pc = mc - j + 1;
              if (pc < 0 || pc >= W) continue;
              const float* kd = p + P_KDEB + (i * 3 + j) * 9 + ch * 3;
              dx = fmaf(kd[0], ddeb[0].at(pr, pc), dx);
              dx = fmaf(kd[1], ddeb[1].at(pr, pc), dx);
              dx = fmaf(kd[2], ddeb[2].at(pr, pc), dx);
            }
          }
        }
      }
      d_raw[blockIdx.z * plane + (size_t)r * W + c] = dx;
      acc[27] -= dx;
      const float dd0 = ddeb[0].at(r, c), dd1 = ddeb[1].at(r, c),
                  dd2 = ddeb[2].at(r, c);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const float x = xs.at(r + i - 1, c + j - 1);
          const int t = (i * 3 + j) * 3;
          acc[t] = fmaf(dd0, x, acc[t]);
          acc[t + 1] = fmaf(dd1, x, acc[t + 1]);
          acc[t + 2] = fmaf(dd2, x, acc[t + 2]);
        }
      }
    }
    reduce_pairs<28>(acc, red);
    __syncthreads();
    // entry e = warp*2 + column parity holds pixels of row parity warp&1
    for (int t = tid; t < 85; t += NTHREADS) {
      float s = 0.f;
      if (t < 81) {
        const int tap = t / 9, ci = (t % 9) / 3, co = t % 3;
        const int i = tap / 3, j = tap % 3;
        for (int e = 0; e < 16; ++e)
          if ((((e >> 1) + i - 1) & 1) + (((e & 1) + j - 1) & 1) == ci)
            s += red[e * 28 + tap * 3 + co];
        part[Q_DKDEB + t] = s;
      } else {
        const int cls = t - 81;
        for (int e = 0; e < 16; ++e)
          if (((e >> 1) & 1) * 2 + (e & 1) == cls) s += red[e * 28 + 27];
        part[Q_DBL + cls] = s;
      }
    }
    __syncthreads();
  }

  // 6. dK_blur: dt times s at the blur's reflected positions.
  {
    float acc[25];
#pragma unroll
    for (int j = 0; j < 25; ++j) acc[j] = 0.f;
    for (int k = 0; k < TILE * TILE / NTHREADS; ++k) {
      const int r = r0 + warp + 8 * k, c = c0 + lane;
      if (r >= H || c >= W) continue;
      const float dtv = dt.at(r, c);
#pragma unroll
      for (int a = 0; a < 5; ++a) {
        const int rr = reflect(r + a - 2, H);
#pragma unroll
        for (int b = 0; b < 5; ++b)
          acc[a * 5 + b] =
              fmaf(dtv, ss.at(rr, reflect(c + b - 2, W)), acc[a * 5 + b]);
      }
    }
    reduce_pairs<25>(acc, red);
    __syncthreads();
    for (int t = tid; t < 25; t += NTHREADS) {
      float s = 0.f;
      for (int e = 0; e < 16; ++e) s += red[e * 25 + t];
      part[Q_DKBLUR + t] = s;
    }
    __syncthreads();
  }

  // 7. dK_sharp (ds times zero-padded Y), dA and d_gamma.
  {
    float acc[19];
#pragma unroll
    for (int j = 0; j < 18; ++j) acc[j] = 0.f;
    acc[18] = dgamma;
    for (int k = 0; k < TILE * TILE / NTHREADS; ++k) {
      const int r = r0 + warp + 8 * k, c = c0 + lane;
      if (r >= H || c >= W) continue;
      const float dsv = ds.at(r, c);
#pragma unroll
      for (int a = 0; a < 3; ++a) {
#pragma unroll
        for (int b = 0; b < 3; ++b)
          acc[a * 3 + b] =
              fmaf(dsv, y1.at(r + a - 1, c + b - 1), acc[a * 3 + b]);
      }
      const float dyuv[3] = {dy.at(r, c), du.at(r, c), dv.at(r, c)};
#pragma unroll
      for (int kk = 0; kk < 3; ++kk) {
#pragma unroll
        for (int cc = 0; cc < 3; ++cc)
          acc[9 + kk * 3 + cc] =
              fmaf(dyuv[kk], deb[cc].at(r, c), acc[9 + kk * 3 + cc]);
      }
    }
    reduce_pairs<19>(acc, red);
    __syncthreads();
    for (int t = tid; t < 19; t += NTHREADS) {
      float s = 0.f;
      for (int e = 0; e < 16; ++e) s += red[e * 19 + t];
      part[t < 9 ? Q_DKSHARP + t : (t < 18 ? Q_DA + t - 9 : Q_DGAMMA)] = s;
    }
  }
}

template <bool kRes>
int launch(const float* raw, const float* g, const float* res,
           const float* params, float* d_raw, float* partials, int B, int H,
           int W, void* stream) {
  const size_t bytes = Layout<kRes>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      fused_isp_bwd_kernel<kRes>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + TILE - 1) / TILE, (H + TILE - 1) / TILE, B);
  fused_isp_bwd_kernel<kRes><<<grid, NTHREADS, bytes, (cudaStream_t)stream>>>(
      raw, g, res, params, d_raw, partials, H, W);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() after the launch.
// `res` null selects the recompute variant. `partials` holds
// 129 floats for each CTA of the (ceil(W/32), ceil(H/32), B) grid.
int r2l_fused_isp_bwd(const float* raw, const float* g, const float* res,
                      const float* params, float* d_raw, float* partials,
                      int B, int H, int W, void* stream) {
  if (res != nullptr)
    return launch<true>(raw, g, res, params, d_raw, partials, B, H, W,
                        stream);
  return launch<false>(raw, g, nullptr, params, d_raw, partials, B, H, W,
                       stream);
}

// Kernel `which` of this file (0 residual, 1 recompute): its name,
// registers per thread, CTAs per SM and shared bytes per CTA
// (kernel_info.cuh); null past the last or on an error.
const char* r2l_kernel_info(int which, int* regs, int* ctas_per_sm,
                            int* smem) {
  switch (which) {
    case 0: return r2l_occupancy((const void*)fused_isp_bwd_kernel<true>,
                                 "fused_isp_bwd_kernel<true>", NTHREADS,
                                 Layout<true>::BYTES, regs, ctas_per_sm,
                                 smem);
    case 1: return r2l_occupancy((const void*)fused_isp_bwd_kernel<false>,
                                 "fused_isp_bwd_kernel<false>", NTHREADS,
                                 Layout<false>::BYTES, regs, ctas_per_sm,
                                 smem);
  }
  return nullptr;
}

const char* r2l_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
