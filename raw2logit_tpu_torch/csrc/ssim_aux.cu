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
// Design: one launch, nothing written to device memory between the value
// and the gradient (the TPU kernel's point). A CTA of 4 warps owns a strip
// of at most SW_MAX output columns of one (image, channel) plane and walks
// down it two rows per step, so no vertical halo is recomputed. Step s
// (rows s and s + 1 in):
//   1. one thread per input column: x and y of rows s, s + 1 and their
//      products (formed once) are scattered into the vertical 11-tap sums
//      of rows s-5 .. s+6, held as rings of 11 registers; rows s - 5 and
//      s - 4 are then complete and go to shared memory. In the same phase,
//      the horizontal adjoint sums of rows s - 12 and s - 11, two adjacent
//      outputs per thread from float2 loads, combined with x and y at the
//      pixel into d/dy;
//   2. the horizontal sums of rows s - 5 and s - 4, two adjacent field
//      columns per thread from float2 loads: the five fields, the map and
//      its three derived fields (zero outside the image);
//   3. one thread per field column: the derived fields of rows s - 5 and
//      s - 4 are scattered into the vertical adjoint sums of rows s-10 ..
//      s+1 (rings of 11 registers); rows s - 10 and s - 9 are then
//      complete and go to shared memory for step s + 2's horizontal
//      adjoint pass.
// The rings are indexed by s mod 11 through a switch, so that every index
// is a constant; the taps sit in constant memory, so that the FMAs take
// them as operands and the rings fit in 128 registers (four CTAs per SM).
// The passes run in the plain version's order (vertical, then
// horizontal), each sum in tap order: where B11 - mu1^2 cancels, the
// fields' rounding then follows the plain version's (horizontal first
// moved the gradient 1.3e-5 of its scale from the float32 plain version).
// x and y rows arrive by cp.async one step ahead into a ring of 16 rows
// (step 1 reads them 12 rows later again). Three barriers per step.
// Shared loads per output pixel: about 49 (the first port's 32x32 tiles
// with recomputed halos took about 228).
//
// Each thread sums m over its own in-image pixels in float64; the CTA's
// sum (warp shuffles, then the warps in order) goes to partials[cta]; the
// wrapper sums the partials in float64. No atomics: two launches are
// bitwise equal.
//
// All f32 (the mean's sums in f64); no fast math.

#include <cuda_runtime.h>

#include "kernel_info.cuh"

namespace {

constexpr int WIN = 11;
constexpr int R = WIN / 2;              // 5
constexpr int NT = 128;                 // threads: one per input column
constexpr int SW_MAX = NT - 4 * R;      // 108 output columns per strip
constexpr int IWS = NT + 2;             // row stride of x, y, their sums
constexpr int FWS = SW_MAX + 2 * R + 2;  // 120: row stride of the fields
constexpr int RING = 16;                // x and y rows held
constexpr int LAG = 2 * R + 2;          // d/dy trails the input by 12 rows
constexpr float C1 = 0.0001f;           // 0.01^2
constexpr float C2 = 0.0009f;           // 0.03^2

__host__ __device__ constexpr int cdiv(int a, int b) {
  return (a + b - 1) / b;
}

// Strips per plane, and the columns each owns (all strips alike; the last
// may reach past the image).
__host__ __device__ inline int n_strips(int W) { return cdiv(W, SW_MAX); }
__host__ __device__ inline int strip_width(int W) {
  return cdiv(W, n_strips(W));
}

__device__ constexpr int mod11(int v) { return ((v % WIN) + WIN) % WIN; }

__device__ __forceinline__ void cp_async_f32(float* dst, const float* src,
                                             bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float pick(const float2* p, int i) {
  const float2 v = p[i >> 1];
  return (i & 1) ? v.y : v.x;
}

// The map and its three derivatives at one pixel from the five fields
// f = (mu1, mu2, B11, B22, B12). Rounded as written (no fused
// multiply-adds): in flat regions B11 - mu1^2 cancels to rounding noise
// against C2, and an exact product there would subtract the rounding of
// x^2 that B11 carries from every pixel alike, biasing the mean.
__device__ __forceinline__ float ssim_map(const float* f, float* e) {
  const float mu1 = f[0], mu2 = f[1], b11 = f[2], b22 = f[3], b12 = f[4];
  const float mu1mu2 = __fmul_rn(mu1, mu2);
  const float mu1sq = __fmul_rn(mu1, mu1), mu2sq = __fmul_rn(mu2, mu2);
  const float a1 = __fadd_rn(__fmul_rn(2.f, mu1mu2), C1);
  const float a2 = __fadd_rn(__fmul_rn(2.f, __fsub_rn(b12, mu1mu2)), C2);
  const float d1 = __fadd_rn(__fadd_rn(mu1sq, mu2sq), C1);
  const float d2 = __fadd_rn(
      __fadd_rn(__fsub_rn(b11, mu1sq), __fsub_rn(b22, mu2sq)), C2);
  const float den = __fmul_rn(d1, d2);
  // one correctly rounded reciprocal of D1 D2 in place of four divisions
  // (m / D2 = m D1 / (D1 D2)); the SSIM_* gates hold either way
  const float rden = __frcp_rn(den);
  const float m = __fmul_rn(__fmul_rn(a1, a2), rden);
  e[0] = __fmul_rn(__fsub_rn(__fmul_rn(__fmul_rn(2.f, mu1),
                                       __fsub_rn(a2, a1)),
                             __fmul_rn(__fmul_rn(m, 2.f * mu2),
                                       __fsub_rn(d2, d1))),
                   rden);
  e[1] = -__fmul_rn(__fmul_rn(m, d1), rden);
  e[2] = __fmul_rn(__fmul_rn(2.f, a1), rden);
  return m;
}

// The 11 gaussian taps, copied from the caller's device array before each
// launch: the FMAs take them as constant operands, in no register.
__constant__ float c_taps[WIN];

// The vertical pass of the five products at input column j for rows s and
// s + 1 (U = s mod 11): row s + i is scattered into the sums of rows
// s+i-5 .. s+i+5, after which row s+i-5 is complete and goes to vs[i].
template <int U>
__device__ __forceinline__ void vertical_products(
    float (&facc)[5][WIN], const float* const (&xr)[2],
    const float* const (&yr)[2], float (*vs)[5][IWS], int j, int s, int H) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (s + i < H) {
      const float xv = xr[i][j], yv = yr[i][j];
      const float v[5] = {xv, yv, xv * xv, yv * yv, xv * yv};
#pragma unroll
      for (int d = -R; d <= R; ++d)
#pragma unroll
        for (int f = 0; f < 5; ++f)
          facc[f][mod11(U + i + d)] =
              fmaf(c_taps[R - d], v[f], facc[f][mod11(U + i + d)]);
    }
    const int done = mod11(U + i - R);  // a constant once unrolled
#pragma unroll
    for (int f = 0; f < 5; ++f) {
      vs[i][f][j] = facc[f][done];
      facc[f][done] = 0.f;
    }
  }
}

// The vertical adjoint pass at field column j for the derived rows s - 5
// and s - 4 (U = s mod 11): derived row r is scattered into the sums of
// rows r-5 .. r+5, after which row r - 5 is complete and goes to va.
template <int U>
__device__ __forceinline__ void vertical_adjoint(
    float (&aacc)[3][WIN], const float (*es)[3][FWS], float (*va)[3][FWS],
    int j, int s, int H) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = s - R + i;
    if (r >= 0 && r < H) {
      float e[3];
#pragma unroll
      for (int f = 0; f < 3; ++f) e[f] = es[i][f][j];
#pragma unroll
      for (int d = -R; d <= R; ++d)
#pragma unroll
        for (int f = 0; f < 3; ++f)
          aacc[f][mod11(U + i - R + d)] =
              fmaf(c_taps[R - d], e[f], aacc[f][mod11(U + i - R + d)]);
    }
    const int done = mod11(U + i - 2 * R);
#pragma unroll
    for (int f = 0; f < 3; ++f) {
      va[i][f][j] = aacc[f][done];
      aacc[f][done] = 0.f;
    }
  }
}

#define R2L_RING_SWITCH(u, call) \
  switch (u) {                   \
    case 0: call(0); break;      \
    case 1: call(1); break;      \
    case 2: call(2); break;      \
    case 3: call(3); break;      \
    case 4: call(4); break;      \
    case 5: call(5); break;      \
    case 6: call(6); break;      \
    case 7: call(7); break;      \
    case 8: call(8); break;      \
    case 9: call(9); break;      \
    case 10: call(10); break;    \
  }

__global__ void __launch_bounds__(NT, 4)
ssim_aux_kernel(const float* __restrict__ x, const float* __restrict__ y,
                float scale, float* __restrict__ dy,
                double* __restrict__ partials, int H, int W) {
  __shared__ __align__(16) float xs[RING][IWS];
  __shared__ __align__(16) float ys[RING][IWS];
  __shared__ __align__(16) float vs[2][5][IWS];  // vertical sums
  __shared__ __align__(16) float es[2][3][FWS];  // derived fields
  __shared__ __align__(16) float va[2][3][FWS];  // vertical adjoint sums
  __shared__ double red[NT / 32];

  const int tid = threadIdx.x;
  const int sw = strip_width(W), fw = sw + 2 * R, iw = sw + 4 * R;
  const int c0 = blockIdx.x * sw;  // first output column of the strip
  const size_t off = (size_t)blockIdx.y * H * W;  // plane (image, channel)
  const float* xp = x + off;
  const float* yp = y + off;

  // padding columns are read (for outputs that are dropped) but never
  // written
  for (int i = tid; i < 2 * 5 * IWS; i += NT) (&vs[0][0][0])[i] = 0.f;
  for (int i = tid; i < 2 * 3 * FWS; i += NT) {
    (&es[0][0][0])[i] = 0.f;
    (&va[0][0][0])[i] = 0.f;
  }

  // x and y of image row `row`, columns c0 - 10 .. c0 + sw + 10, zero
  // outside the image
  auto fetch = [&](int row) {
    if (row < H && tid < iw) {
      const int c = c0 - 2 * R + tid;
      const bool in = c >= 0 && c < W;
      const size_t at = in ? (size_t)row * W + c : 0;
      cp_async_f32(xs[row & (RING - 1)] + tid, xp + at, in);
      cp_async_f32(ys[row & (RING - 1)] + tid, yp + at, in);
    }
  };

  float facc[5][WIN], aacc[3][WIN];
#pragma unroll
  for (int k = 0; k < WIN; ++k) {
#pragma unroll
    for (int f = 0; f < 5; ++f) facc[f][k] = 0.f;
#pragma unroll
    for (int f = 0; f < 3; ++f) aacc[f][k] = 0.f;
  }
  double msum = 0.0;
  const int n_fld = (fw + 1) / 2;  // threads of the horizontal passes
  const int n_adj = (sw + 1) / 2;

  fetch(0);
  fetch(1);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  // two rows per step; the last step's adjoint rows end at H - 1
  for (int s = 0; s - LAG < H; s += 2) {
    fetch(s + 2);
    fetch(s + 3);
    cp_async_commit();
    const int u = s % WIN;

    // 1. vertical sums of the products (rows s, s + 1 in; s - 5, s - 4
    //    out); and the horizontal adjoint sums of rows s - 12 and s - 11
    //    into d/dy
    if (tid < iw) {
      const float* const xr[2] = {xs[s & (RING - 1)],
                                  xs[(s + 1) & (RING - 1)]};
      const float* const yr[2] = {ys[s & (RING - 1)],
                                  ys[(s + 1) & (RING - 1)]};
#define R2L_CALL(U) vertical_products<U>(facc, xr, yr, vs, tid, s, H)
      R2L_RING_SWITCH(u, R2L_CALL)
#undef R2L_CALL
    }
    if (tid < 2 * n_adj) {
      // thread: row s - 12 + i, output columns 2a, 2a + 1
      const int i = tid >= n_adj, a = tid - i * n_adj;
      const int q = s - LAG + i;
      if (q >= 0 && q < H) {
        float b[3][2];
#pragma unroll
        for (int f = 0; f < 3; ++f) {
          b[f][0] = b[f][1] = 0.f;
          const float2* vr = reinterpret_cast<const float2*>(va[i][f]) + a;
#pragma unroll
          for (int k2 = 0; k2 < WIN + 1; ++k2) {
            const float v = pick(vr, k2);
#pragma unroll
            for (int o = 0; o < 2; ++o) {
              const int k = k2 - o;
              if (k >= 0 && k < WIN) b[f][o] = fmaf(c_taps[k], v, b[f][o]);
            }
          }
        }
        const float2 xq =
            reinterpret_cast<const float2*>(xs[q & (RING - 1)])[a + R];
        const float2 yq =
            reinterpret_cast<const float2*>(ys[q & (RING - 1)])[a + R];
        const float xv[2] = {xq.x, xq.y}, yv[2] = {yq.x, yq.y};
        float* dq = dy + off + (size_t)q * W;
#pragma unroll
        for (int o = 0; o < 2; ++o) {
          const int c = 2 * a + o;
          if (c >= sw || c0 + c >= W) continue;
          float d = scale * b[0][o];
          d += (2.f * scale) * yv[o] * b[1][o];
          d += scale * xv[o] * b[2][o];
          dq[c0 + c] = d;
        }
      }
    }
    __syncthreads();

    // 2. horizontal sums of rows s - 5 and s - 4: the fields, the map and
    //    the derived fields (zero outside the image), two columns a thread
    if (tid < 2 * n_fld) {
      // thread: row s - 5 + i, field columns 2p, 2p + 1
      const int i = tid >= n_fld, p = tid - i * n_fld;
      const int r = s - R + i;
      if (r >= 0 && r < H) {
        float fld[2][5];
#pragma unroll
        for (int f = 0; f < 5; ++f) {
          fld[0][f] = fld[1][f] = 0.f;
          const float2* vr = reinterpret_cast<const float2*>(vs[i][f]) + p;
#pragma unroll
          for (int k2 = 0; k2 < WIN + 1; ++k2) {
            const float v = pick(vr, k2);
#pragma unroll
            for (int o = 0; o < 2; ++o) {
              const int k = k2 - o;
              if (k >= 0 && k < WIN)
                fld[o][f] = fmaf(c_taps[k], v, fld[o][f]);
            }
          }
        }
        float e[2][3];
#pragma unroll
        for (int o = 0; o < 2; ++o) {
          const int jf = 2 * p + o, c = c0 - R + jf;
          e[o][0] = e[o][1] = e[o][2] = 0.f;
          if (jf < fw && c >= 0 && c < W) {
            const float m = ssim_map(fld[o], e[o]);
            if (jf >= R && jf < R + sw) msum += (double)m;
          }
        }
#pragma unroll
        for (int f = 0; f < 3; ++f)
          reinterpret_cast<float2*>(es[i][f])[p] =
              make_float2(e[0][f], e[1][f]);
      }
    }
    __syncthreads();

    // 3. vertical adjoint sums (derived rows s - 5, s - 4 in; s - 10,
    //    s - 9 out)
    if (tid < fw) {
#define R2L_CALL(U) vertical_adjoint<U>(aacc, es, va, tid, s, H)
      R2L_RING_SWITCH(u, R2L_CALL)
#undef R2L_CALL
    }
    cp_async_wait<0>();  // rows s + 2, s + 3 landed
    __syncthreads();
  }

  // The CTA's sum of m, in a fixed order.
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    msum += __shfl_xor_sync(0xffffffffu, msum, o);
  if ((tid & 31) == 0) red[tid >> 5] = msum;
  __syncthreads();
  if (tid == 0) {
    double t = 0.0;
    for (int w = 0; w < NT / 32; ++w) t += red[w];
    partials[(size_t)blockIdx.y * gridDim.x + blockIdx.x] = t;
  }
}

#undef R2L_RING_SWITCH

}  // namespace

extern "C" {

// The number of float64 partials (CTAs) of r2l_ssim_aux on (B, 3, H, W).
int r2l_ssim_aux_partials(int B, int H, int W) {
  return n_strips(W) * B * 3;
}

// Launches on `stream` and returns the CUDA error of the launch (0 when
// it was accepted). `partials` holds r2l_ssim_aux_partials(B, H, W)
// doubles; `taps` the 11 gaussian taps on the device.
int r2l_ssim_aux(const float* x, const float* y, const float* taps,
                 float scale, float* dy, double* partials, int B, int H,
                 int W, void* stream) {
  cudaError_t err = cudaMemcpyToSymbolAsync(
      c_taps, taps, WIN * sizeof(float), 0, cudaMemcpyDeviceToDevice,
      (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_strips(W), B * 3);
  ssim_aux_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      x, y, scale, dy, partials, H, W);
  return (int)cudaGetLastError();
}

// Kernel `which` of this file (0 only): its name, registers per thread,
// CTAs per SM and shared bytes per CTA (kernel_info.cuh); null past the
// last or on an error.
const char* r2l_kernel_info(int which, int* regs, int* ctas_per_sm,
                            int* smem) {
  if (which != 0) return nullptr;
  return r2l_occupancy((const void*)ssim_aux_kernel, "ssim_aux_kernel", NT,
                       0, regs, ctas_per_sm, smem);
}

const char* r2l_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
