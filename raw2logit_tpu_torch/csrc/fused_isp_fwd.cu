// Fused raw->RGB ISP forward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernels raw2logit_tpu/pallas/fused_isp.py::_isp_kernel
// (serving, r2l_fused_isp_fwd) and ::_isp_kernel_train (training,
// r2l_fused_isp_fwd_train: the same kernel, which also stores the residual
// planes the backward kernel reads). Math in fused_isp_common.cuh; per
// image, in f32:
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
// Design: one CTA of 256 threads per 32x32 output tile of one image. The
// tile's mosaic is staged in shared memory with a 4-px halo (1 for the
// debayer, 1 for the sharpen, 2 for the blur); Y is computed on tile+-3,
// s on tile+-2 and t on the tile, each stage in shared memory. Every
// stage pads at the IMAGE border, not the tile border: Y is 0 outside
// the image, and the blur reads s at reflected in-image positions, which
// always fall inside the tile+-2 region. U and V need only the debayer
// at the pixel itself. The residuals are stores of values each output
// pixel already holds. A later change makes it fast (TMA tile loads, a
// persistent grid, several tiles per CTA to amortise the halo).
//
// No fast math: expf/logf, and 1/gamma kept as a multiply as on the TPU.

#include "fused_isp_common.cuh"
#include "kernel_info.cuh"

namespace {

using namespace r2l;

constexpr int HALO = 4;
constexpr int XS = TILE + 2 * HALO;  // mosaic minus black level, tile+-4
constexpr int YS = TILE + 6;         // luma Y, tile+-3
constexpr int SS = TILE + 4;         // sharpened luma s, tile+-2

template <bool kRes>
__global__ void __launch_bounds__(NTHREADS)
fused_isp_fwd_kernel(const float* __restrict__ raw,
                     const float* __restrict__ params,
                     float* __restrict__ out, float* __restrict__ res, int H,
                     int W) {
  __shared__ float p[P_COUNT];
  __shared__ float xs_data[XS * XS];
  __shared__ float ys_data[YS * YS];
  __shared__ float ss_data[SS * SS];

  const int tid = threadIdx.x;
  const int r0 = blockIdx.y * TILE;
  const int c0 = blockIdx.x * TILE;
  const size_t plane = (size_t)H * W;
  const float* img = raw + blockIdx.z * plane;
  const Plane xs = make_plane(xs_data, r0, c0, HALO);
  const Plane ys = make_plane(ys_data, r0, c0, 3);
  const Plane ss = make_plane(ss_data, r0, c0, 2);

  for (int i = tid; i < P_COUNT; i += NTHREADS) p[i] = params[i];
  __syncthreads();

  // 1. Mosaic minus black level on tile+-4.
  for (int i = tid; i < XS * XS; i += NTHREADS) {
    const int r = xs.r0 + i / XS, c = xs.c0 + i % XS;
    xs.at(r, c) = mosaic_at(img, p, r, c, H, W);
  }
  __syncthreads();

  // 2. Luma Y = A[0] . deb on tile+-3, zero outside the image (the
  //    sharpen's zero pad).
  for (int i = tid; i < YS * YS; i += NTHREADS) {
    const int r = ys.r0 + i / YS, c = ys.c0 + i % YS;
    float y = 0.f;
    if (r >= 0 && r < H && c >= 0 && c < W) {
      float d0, d1, d2;
      debayer_at(xs, r, c, p, d0, d1, d2);
      y = mix_row(p + P_A, d0, d1, d2);
    }
    ys.at(r, c) = y;
  }
  __syncthreads();

  // 3. Sharpened luma s on tile+-2. Entries outside the image are never
  //    read: the blur reflects into the image.
  for (int i = tid; i < SS * SS; i += NTHREADS) {
    const int r = ss.r0 + i / SS, c = ss.c0 + i % SS;
    ss.at(r, c) = sharpen_at(ys, r, c, p);
  }
  __syncthreads();

  // 4. Blur s with image-border reflection, chroma at the pixel,
  //    YUV->RGB, clip, gamma; one coalesced row of 32 per warp.
  const float inv_g = 1.0f / p[P_GAMMA];
  for (int i = tid; i < TILE * TILE; i += NTHREADS) {
    const int r = r0 + i / TILE, c = c0 + i % TILE;
    if (r >= H || c >= W) continue;
    const float t = blur_at(ss, r, c, H, W, p);
    float d0, d1, d2;
    debayer_at(xs, r, c, p, d0, d1, d2);
    const float u = mix_row(p + P_A + 3, d0, d1, d2);
    const float v = mix_row(p + P_A + 6, d0, d1, d2);
    const size_t at = (size_t)r * W + c;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const float val = clip(pre_clip(p, ch, t, u, v));
      out[(blockIdx.z * 3 + ch) * plane + at] = expf(logf(val) * inv_g);
    }
    if (kRes) {
      float* rs = res + blockIdx.z * 5 * plane + at;
      rs[0] = d0;
      rs[plane] = d1;
      rs[2 * plane] = d2;
      rs[3 * plane] = ss.at(r, c);
      rs[4 * plane] = t;
    }
  }
}

template <bool kRes>
int launch(const float* raw, const float* params, float* out, float* res,
           int B, int H, int W, void* stream) {
  const dim3 grid((W + TILE - 1) / TILE, (H + TILE - 1) / TILE, B);
  fused_isp_fwd_kernel<kRes><<<grid, NTHREADS, 0, (cudaStream_t)stream>>>(
      raw, params, out, res, H, W);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Both launch on `stream` and return cudaGetLastError() after the launch.
int r2l_fused_isp_fwd(const float* raw, const float* params, float* out,
                      int B, int H, int W, void* stream) {
  return launch<false>(raw, params, out, nullptr, B, H, W, stream);
}

int r2l_fused_isp_fwd_train(const float* raw, const float* params,
                            float* out, float* res, int B, int H, int W,
                            void* stream) {
  return launch<true>(raw, params, out, res, B, H, W, stream);
}

// Kernel `which` of this file (0 serving, 1 training): its name,
// registers per thread, CTAs per SM and shared bytes per CTA
// (kernel_info.cuh); null past the last or on an error.
const char* r2l_kernel_info(int which, int* regs, int* ctas_per_sm,
                            int* smem) {
  switch (which) {
    case 0: return r2l_occupancy((const void*)fused_isp_fwd_kernel<false>,
                                 "fused_isp_fwd_kernel<false>", NTHREADS, 0,
                                 regs, ctas_per_sm, smem);
    case 1: return r2l_occupancy((const void*)fused_isp_fwd_kernel<true>,
                                 "fused_isp_fwd_kernel<true>", NTHREADS, 0,
                                 regs, ctas_per_sm, smem);
  }
  return nullptr;
}

const char* r2l_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
