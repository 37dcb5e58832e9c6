// SSIM aux value and gradient for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel raw2logit_tpu/pallas/ssim_aux.py::
// _ssim_aux_fused_kernel (r2l_ssim_aux). For a planar reference x and an
// adversarial image y, both (B, 3, H, W) f32, and s = weight / (B*3*H*W):
//   mu1 = blur(x), mu2 = blur(y), B11 = blur(x^2), B22 = blur(y^2),
//   B12 = blur(xy), blur = separable 11-tap gaussian (sigma 1.5), zero
//   'same' padding;
//   A1 = 2 mu1 mu2 + C1            D1 = mu1^2 + mu2^2 + C1
//   A2 = 2 (B12 - mu1 mu2) + C2    D2 = (B11 - mu1^2) + (B22 - mu2^2) + C2
//   m  = A1 A2 / (D1 D2)           value = weight * mean(m)
//   d value / dy = s [blur(dm/dmu2) + 2 y blur(dm/dB22) + x blur(dm/dB12)]
//   dm/dmu2 = (2 mu1 (A2 - A1) - m 2 mu2 (D2 - D1)) / (D1 D2)
//   dm/dB22 = -m / D2,  dm/dB12 = 2 A1 / (D1 D2).
// The zero-padded blur is its own adjoint, so the three derived fields
// are ZERO outside the image before they are blurred again.
//
// Bound on an H100: operations. It reads x and y and writes d/dy, 12 B per
// element (604 MB at B = 256, 256x256: 0.18 ms at 3.35 TB/s), and does
// about 396 f32 operations per element (five fields of two 11-tap passes,
// the map and its three derivatives, three adjoint blurs of two passes:
// 20 GFLOP, 0.30 ms at 67 TFLOP/s).
//
// Design: one launch, one CTA of 256 threads per 32x32 output tile of one
// (image, channel) plane, with nothing written to device memory between
// the value and the gradient (the TPU kernel's point). In shared memory:
// x and y on tile+-10 (zero outside the image); the five products' vertical
// 11-tap sums on rows tile+-5, cols tile+-10; their horizontal sums, the
// five fields, on tile+-5; the three derived fields on tile+-5 (over the
// vertical sums); their vertical adjoint sums on the tile's rows, cols
// tile+-5 (over the fields); then the horizontal adjoint sums, combined
// with x and y at the pixel, go to d/dy. Each CTA sums m over its own
// in-image pixels in a fixed order (per thread, then warp shuffles, then
// the 8 warps in order) into partials[cta]; the wrapper sums the partials
// in float64. No atomics: two launches are bitwise equal. 100,624 B of
// dynamic shared memory, so two CTAs per SM. A later change makes it fast
// (register-blocked passes, a persistent grid, several planes per CTA).
//
// All f32; no fast math.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 32;
constexpr int NTHREADS = 256;
constexpr int WIN = 11;
constexpr int R = WIN / 2;         // 5
constexpr int IN = TILE + 4 * R;   // 52: x and y on tile+-10
constexpr int FLD = TILE + 2 * R;  // 42: fields on tile+-5
constexpr float C1 = 0.0001f;      // 0.01^2
constexpr float C2 = 0.0009f;      // 0.03^2

constexpr int IN_SZ = IN * IN;          // one input plane
constexpr int V_SZ = FLD * IN;          // one vertical sum
constexpr int F_SZ = FLD * FLD;         // one field
constexpr int A_SZ = TILE * FLD;        // one vertical adjoint sum
constexpr int SMEM_FLOATS = 2 * IN_SZ + 5 * V_SZ + 5 * F_SZ + NTHREADS / 32;
constexpr size_t SMEM_BYTES = SMEM_FLOATS * sizeof(float);
static_assert(3 * F_SZ <= 5 * V_SZ, "derived fields fit over the sums");
static_assert(3 * A_SZ <= 5 * F_SZ, "adjoint sums fit over the fields");

__global__ void __launch_bounds__(NTHREADS)
ssim_aux_kernel(const float* __restrict__ x, const float* __restrict__ y,
                const float* __restrict__ taps, float scale,
                float* __restrict__ dy, float* __restrict__ partials, int H,
                int W) {
  extern __shared__ float sm[];
  float* xs = sm;
  float* ys = xs + IN_SZ;
  float* vs = ys + IN_SZ;      // vertical sums; later the derived fields
  float* fs = vs + 5 * V_SZ;   // fields; later the vertical adjoint sums
  float* red = fs + 5 * F_SZ;  // one partial per warp
  __shared__ float g[WIN];

  const int tid = threadIdx.x;
  const int r0 = blockIdx.y * TILE;
  const int c0 = blockIdx.x * TILE;
  const size_t off = (size_t)blockIdx.z * H * W;  // plane (image, channel)
  if (tid < WIN) g[tid] = taps[tid];

  // 1. x and y on tile+-10, zero outside the image.
  for (int i = tid; i < IN_SZ; i += NTHREADS) {
    const int r = r0 - 2 * R + i / IN, c = c0 - 2 * R + i % IN;
    const bool in = r >= 0 && r < H && c >= 0 && c < W;
    const size_t at = off + (size_t)r * W + c;
    xs[i] = in ? x[at] : 0.f;
    ys[i] = in ? y[at] : 0.f;
  }
  __syncthreads();

  // 2. Vertical 11-tap sums of x, y, x^2, y^2, xy: local row rr is image
  //    row r0 - 5 + rr and reads input rows rr .. rr + 10.
  for (int i = tid; i < V_SZ; i += NTHREADS) {
    const int rr = i / IN, cc = i % IN;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f, a4 = 0.f;
#pragma unroll
    for (int k = 0; k < WIN; ++k) {
      const float xv = xs[(rr + k) * IN + cc], yv = ys[(rr + k) * IN + cc];
      const float gk = g[k];
      a0 = fmaf(gk, xv, a0);
      a1 = fmaf(gk, yv, a1);
      a2 = fmaf(gk, xv * xv, a2);
      a3 = fmaf(gk, yv * yv, a3);
      a4 = fmaf(gk, xv * yv, a4);
    }
    vs[i] = a0;
    vs[V_SZ + i] = a1;
    vs[2 * V_SZ + i] = a2;
    vs[3 * V_SZ + i] = a3;
    vs[4 * V_SZ + i] = a4;
  }
  __syncthreads();

  // 3. Horizontal sums: the fields mu1, mu2, B11, B22, B12 on tile+-5.
  for (int i = tid; i < F_SZ; i += NTHREADS) {
    const int rr = i / FLD, cc = i % FLD;
#pragma unroll
    for (int q = 0; q < 5; ++q) {
      const float* v = vs + q * V_SZ + rr * IN + cc;
      float a = 0.f;
#pragma unroll
      for (int k = 0; k < WIN; ++k) a = fmaf(g[k], v[k], a);
      fs[q * F_SZ + i] = a;
    }
  }
  __syncthreads();

  // 4. The map and its three derivatives on tile+-5, zero outside the
  //    image; m summed over the tile's own in-image pixels.
  float msum = 0.f;
  for (int i = tid; i < F_SZ; i += NTHREADS) {
    const int rr = i / FLD, cc = i % FLD;
    const int r = r0 - R + rr, c = c0 - R + cc;
    float e0 = 0.f, e1 = 0.f, e2 = 0.f;
    if (r >= 0 && r < H && c >= 0 && c < W) {
      const float mu1 = fs[i], mu2 = fs[F_SZ + i];
      const float b11 = fs[2 * F_SZ + i], b22 = fs[3 * F_SZ + i];
      const float b12 = fs[4 * F_SZ + i];
      // Rounded as written (no fused multiply-adds): in flat regions
      // B11 - mu1^2 cancels to rounding noise against C2, and an exact
      // product there would subtract the rounding of x^2 that B11 carries
      // from every pixel alike, biasing the mean.
      const float mu1mu2 = __fmul_rn(mu1, mu2);
      const float mu1sq = __fmul_rn(mu1, mu1), mu2sq = __fmul_rn(mu2, mu2);
      const float a1 = __fadd_rn(__fmul_rn(2.f, mu1mu2), C1);
      const float a2 = __fadd_rn(__fmul_rn(2.f, __fsub_rn(b12, mu1mu2)), C2);
      const float d1 = __fadd_rn(__fadd_rn(mu1sq, mu2sq), C1);
      const float d2 = __fadd_rn(
          __fadd_rn(__fsub_rn(b11, mu1sq), __fsub_rn(b22, mu2sq)), C2);
      const float den = __fmul_rn(d1, d2);
      const float m = __fdiv_rn(__fmul_rn(a1, a2), den);
      e0 = __fdiv_rn(__fsub_rn(__fmul_rn(__fmul_rn(2.f, mu1),
                                         __fsub_rn(a2, a1)),
                               __fmul_rn(__fmul_rn(m, 2.f * mu2),
                                         __fsub_rn(d2, d1))),
                     den);
      e1 = -__fdiv_rn(m, d2);
      e2 = __fdiv_rn(__fmul_rn(2.f, a1), den);
      if (rr >= R && rr < R + TILE && cc >= R && cc < R + TILE) msum += m;
    }
    vs[i] = e0;
    vs[F_SZ + i] = e1;
    vs[2 * F_SZ + i] = e2;
  }
  __syncthreads();

  // 5. Vertical adjoint sums on the tile's rows, cols tile+-5: local row
  //    rr is image row r0 + rr and reads derived rows rr .. rr + 10.
  for (int i = tid; i < A_SZ; i += NTHREADS) {
    const int rr = i / FLD, cc = i % FLD;
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const float* e = vs + q * F_SZ + rr * FLD + cc;
      float a = 0.f;
#pragma unroll
      for (int k = 0; k < WIN; ++k) a = fmaf(g[k], e[k * FLD], a);
      fs[q * A_SZ + i] = a;
    }
  }
  __syncthreads();

  // 6. Horizontal adjoint sums onto the tile, combined at the pixel.
  for (int i = tid; i < TILE * TILE; i += NTHREADS) {
    const int rr = i / TILE, cc = i % TILE;
    const int r = r0 + rr, c = c0 + cc;
    if (r >= H || c >= W) continue;
    float b[3];
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const float* a = fs + q * A_SZ + rr * FLD + cc;
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < WIN; ++k) s = fmaf(g[k], a[k], s);
      b[q] = s;
    }
    const int at = (rr + 2 * R) * IN + cc + 2 * R;
    float d = scale * b[0];
    d += (2.f * scale) * ys[at] * b[1];
    d += scale * xs[at] * b[2];
    dy[off + (size_t)r * W + c] = d;
  }

  // 7. The tile's sum of m, in a fixed order.
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    msum += __shfl_xor_sync(0xffffffffu, msum, o);
  if ((tid & 31) == 0) red[tid >> 5] = msum;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int w = 0; w < NTHREADS / 32; ++w) s += red[w];
    partials[((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x +
             blockIdx.x] = s;
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the CUDA error of the launch (0 when
// it was accepted). `partials` holds one float for each CTA of the
// (ceil(W/32), ceil(H/32), B*3) grid; `taps` the 11 gaussian taps on the
// device.
int r2l_ssim_aux(const float* x, const float* y, const float* taps,
                 float scale, float* dy, float* partials, int B, int H,
                 int W, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      ssim_aux_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + TILE - 1) / TILE, (H + TILE - 1) / TILE, B * 3);
  ssim_aux_kernel<<<grid, NTHREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      x, y, taps, scale, dy, partials, H, W);
  return (int)cudaGetLastError();
}

const char* r2l_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
