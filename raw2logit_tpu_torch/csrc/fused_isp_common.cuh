// Shared math of the fused ISP kernels (fused_isp_fwd.cu, fused_isp_bwd.cu).
//
// Every sum is written as an explicit fmaf chain, so that the forward
// kernels and the backward kernel's recompute of the forward produce
// bitwise identical intermediates (deb, Y, s, t) whatever nvcc would
// contract on its own. The forward writes the same chains, in the same
// order, out per 2x2 quad of sites with its weights in the constant bank;
// the backward calls the functions below. Planes live in shared memory as
// row-major regions of a tile with a halo; a plane is addressed by its
// image position.

#pragma once

#include <cuda_runtime.h>

namespace r2l {

constexpr int TILE = 32;
constexpr int NTHREADS = 256;

// Offsets into the packed parameter buffer (kernels/fused_isp.py
// pack_params writes this layout).
constexpr int P_BL = 0;        // 4: black level per RGGB site
constexpr int P_KDEB = 4;      // 81: debayer [tap = kh*3+kw][ci*3+co]
constexpr int P_A = 85;        // 9: M_RGB2YUV . CCM . diag(WB), row-major
constexpr int P_MINV = 94;     // 9: M_YUV2RGB, row-major
constexpr int P_KSHARP = 103;  // 9: sharpen [kh][kw]
constexpr int P_KBLUR = 112;   // 25: blur [kh][kw]
constexpr int P_GAMMA = 137;   // 1
constexpr int P_COUNT = 138;

// torch 'reflect' for an index at most one period outside [0, n).
__device__ __forceinline__ int reflect(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

// RGGB channel of site (r, c): 0 = R, 1 = G, 2 = B. Valid for negative
// indices too (two's complement & 1 gives the parity).
__device__ __forceinline__ int site_channel(int r, int c) {
  return (r & 1) + (c & 1);
}

// A plane over the image rows/cols [r0 - halo, r0 + TILE + halo).
struct Plane {
  float* data;
  int r0, c0, size;  // origin (image coordinates) and side length
  __device__ __forceinline__ float& at(int r, int c) const {
    return data[(r - r0) * size + (c - c0)];
  }
};

__device__ __forceinline__ Plane make_plane(float* data, int tile_r0,
                                            int tile_c0, int halo) {
  return Plane{data, tile_r0 - halo, tile_c0 - halo, TILE + 2 * halo};
}

// Mosaic minus black level at image position (r, c): rows/cols -1 and n
// hold the debayer's reflect pad, positions further out hold 0.
__device__ __forceinline__ float mosaic_at(const float* img, const float* p,
                                           int r, int c, int H, int W) {
  if (r < -1 || r > H || c < -1 || c > W) return 0.f;
  const int rr = reflect(r, H), cc = reflect(c, W);
  return img[(size_t)rr * W + cc] - p[P_BL + (rr & 1) * 2 + (cc & 1)];
}

// Debayer at image site (r, c) from the mosaic plane xs (holding r-1..r+1,
// c-1..c+1). Each tap's source site has one known RGGB channel
// (reflection keeps parity): 9 taps x 3 outputs.
__device__ __forceinline__ void debayer_at(const Plane& xs, int r, int c,
                                           const float* p, float& d0,
                                           float& d1, float& d2) {
  d0 = d1 = d2 = 0.f;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float x = xs.at(r + i - 1, c + j - 1);
      const float* k =
          p + P_KDEB + (i * 3 + j) * 9 + site_channel(r + i - 1, c + j - 1) * 3;
      d0 = fmaf(k[0], x, d0);
      d1 = fmaf(k[1], x, d1);
      d2 = fmaf(k[2], x, d2);
    }
  }
}

// Row k of a 3x3 matrix m times (a, b, c).
__device__ __forceinline__ float mix_row(const float* m, float a, float b,
                                         float c) {
  return fmaf(m[2], c, fmaf(m[1], b, m[0] * a));
}

// Sharpened luma at (r, c): 3x3 correlation of Y (zero outside the image,
// as the plane holds it) around (r, c).
__device__ __forceinline__ float sharpen_at(const Plane& ys, int r, int c,
                                            const float* p) {
  float s = 0.f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int b = 0; b < 3; ++b)
      s = fmaf(p[P_KSHARP + a * 3 + b], ys.at(r + a - 1, c + b - 1), s);
  }
  return s;
}

// Blurred luma at in-image (r, c): 5x5 correlation of s read at
// image-border reflected positions.
__device__ __forceinline__ float blur_at(const Plane& ss, int r, int c,
                                         int H, int W, const float* p) {
  int rows[5], cols[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    rows[k] = reflect(r + k - 2, H);
    cols[k] = reflect(c + k - 2, W);
  }
  float t = 0.f;
#pragma unroll
  for (int a = 0; a < 5; ++a) {
#pragma unroll
    for (int b = 0; b < 5; ++b)
      t = fmaf(p[P_KBLUR + a * 5 + b], ss.at(rows[a], cols[b]), t);
  }
  return t;
}

// Pre-clip value of output channel ch from (t, U, V).
__device__ __forceinline__ float pre_clip(const float* p, int ch, float t,
                                          float u, float v) {
  return mix_row(p + P_MINV + ch * 3, t, u, v);
}

__device__ __forceinline__ float clip(float v) {
  return fminf(fmaxf(v, 1e-5f), 1.0f);
}

}  // namespace r2l
