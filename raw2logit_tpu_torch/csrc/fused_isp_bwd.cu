// Fused ISP backward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernels raw2logit_tpu/pallas/fused_isp_bwd.py::
// _bwd_kernel_res (the forward's intermediates read from the residual
// planes that r2l_fused_isp_fwd_train stored) and ::_bwd_kernel (the same
// backward with the forward recomputed from the raw mosaic): one template,
// kRes. Given the planar RGB cotangent g (B, 3, H, W), it writes d_raw
// (B, H, W) and, per CTA, float64 partial sums of the 129 parameter-gradient
// scalars in the layout of fused_isp_bwd.py:188-194: dK_blur 25,
// dK_sharp 9, dA 9 (k*3+c), dK_debayer 81 (tap*9+ci*3+co),
// d_black_level 4, d_gamma 1. The wrapper sums them over CTAs in float64
// and chains dA into the white balance and CCM.
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
// Every adjoint is a GATHER (each pixel collects what it fed), so each
// tile writes only its own pixels and nothing is accumulated across CTAs.
// Reflect adjoints gather from the image positions m that read a pixel q:
// q itself, -q (q <= pad) and 2n-2-q (q >= n-1-pad); every contributing
// in-image p lies within q +- pad.
//
// Bound on an H100. The residual variant must read raw 4, g 12, res 20 B and
// write d_raw 4 B per pixel (40 B; 671 MB at B = 256, 256x256, ~0.20 ms
// at 3.35 TB/s); the recompute variant reads no res (20 B). It does 386
// f32 operations per pixel with residuals and 515 with the recompute
// (counted in chip_smoke.py), so the recompute variant is bound by
// operations at the card's non-tensor f32 rate, the residual one by bytes.
//
// Design: the adjoint chain per pixel is short, so what a tile spends on
// reducing its parameter sums, on border logic and on index arithmetic
// weighs as much as the chain; each is taken out of the per-tile path:
// - Persistent CTAs: the grid is at most CTAS_PER_SM per SM
//   (r2l_fused_isp_bwd_ctas); CTA k walks the run of tiles [k n / grid,
//   (k + 1) n / grid) over (b, tile row, tile col), so that every walk
//   holds edge and interior tiles alike (a stride of the grid puts every
//   tile of a CTA in one tile column, and on an H100 at B = 256 the edge
//   columns' CTAs run 1.46 times as long as the median one, measured by
//   kernels/isp_bwd_probe.py).
//   The order is static: two launches are bitwise equal.
// - Parameter sums: dK_debayer's 27 products of the thread's site class,
//   d_black_level, dA and d_gamma stay in registers across tiles and are
//   flushed every FLUSH tiles (float32 chains of at most 4 * FLUSH own
//   pixels per thread, whatever B) into the CTA's float64 sums in shared
//   memory, written once per CTA. dK_blur and dK_sharp, which would take
//   34 more registers there, are summed per tile by warps that walk down
//   the tile's columns (a window of 5 or 3 rows in registers), their
//   lanes met in a fixed butterfly and added to the float64 sums.
// - Inputs by cp.async (16-byte copies of 16-byte-aligned rows where the
//   tile's box lies inside the image, 4-byte zero-filling copies
//   elsewhere), each into its plane as soon as the current tile has read
//   that plane for the last time: g and t after stage 2, s after stage 3,
//   deb after stage 4, the mosaic after stage 5. So the next tile's loads
//   run under the current tile's stencils; stage 2 reads g from shared
//   memory.
// - Border positions: the reflect adjoints gather from each mirror of a
//   position with no bounds check, from dt and ddeb boxes whose rings
//   beyond what is written stay zero (a mirror's tap that falls outside
//   the written box lies outside the image). Positions whose taps all lie
//   inside the image skip the mirrors; a warp that holds any border
//   position takes the mirrors for all its lanes, which gives an interior
//   position the same value.
// - Register blocking: the blur's adjoint gives each thread six outputs
//   down a column (10 dt values per column tap feed them), and each
//   thread holds the 27 debayer taps of its site class.
// - Compile-time geometry: every plane's side is a constant (Box<HALO>),
//   so index division compiles to multiplies.
// Stages per tile (a barrier after each): 1 the forward's intermediates
// (mosaic minus black level; the recompute variant's Y, s, deb and t);
// 2 dv on tile+-4 -> dt there, dU and dV on tile+-1, d_gamma and the dU,
// dV rows of dA; 3 ds on tile+-2 and dK_blur; 4 dY, Y and ddeb on
// tile+-1 and the dY row of dA; 5 d_raw, d_black_level and dK_debayer;
// 6 dK_sharp. The two variants differ only in stage 1 and in which
// planes are loaded, and see bitwise the same intermediates (the
// recompute runs the forward kernel's own device functions), so they
// give bitwise the same d_raw and sums.
// Two CTAs per SM: 106.6 KB of shared memory each with residuals, 110.8
// KB without; __launch_bounds__ holds registers to 128.
//
// No fast math: expf/logf as in the forward.

#include <stdint.h>

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
constexpr int CTAS_PER_SM = 2;
constexpr int FLUSH = 8;  // tiles between flushes of the float32 sums
constexpr int DS_ROWS = 6;  // ds outputs per thread, down a column

__host__ __device__ constexpr int side(int halo) { return TILE + 2 * halo; }
__host__ __device__ constexpr int area(int halo) {
  return side(halo) * side(halo);
}
static_assert(side(2) % DS_ROWS == 0, "ds strips tile the box");

// A plane over the image rows/cols [r0 - HALO, r0 + TILE + HALO) of the
// tile at (r0, c0), row-major with the constant side S.
template <int HALO>
struct Box {
  static constexpr int S = side(HALO);
  float* d;
  int r0, c0;
  __device__ __forceinline__ float& at(int r, int c) const {
    return d[(r - r0 + HALO) * S + (c - c0 + HALO)];
  }
  __device__ __forceinline__ Plane plane() const {
    return make_plane(d, r0, c0, HALO);
  }
};

// Float offsets in dynamic shared memory. Inputs: g (3 planes), the
// mosaic (tile+-HX), and with residuals deb (3), t and s, all on tile+-4
// (16-byte-aligned rows); the recompute variant computes deb and t on
// tile+-4, s on tile+-6 and Y on tile+-7 (Y shares its space with ds and
// Y1, which stages 3 and 4 write after Y's last use). dt lives in a
// tile+-8 box and ddeb in tile+-3 boxes; only tile+-4 and tile+-1 of them
// are written, and the rings beyond stay zero: the border gathers read
// the rings, unchecked, only at positions outside the image.
template <bool kRes>
struct Layout {
  static constexpr int HX = kRes ? 4 : 8;  // mosaic
  static constexpr int HS = kRes ? 4 : 6;  // sharpened luma s
  static constexpr int HY = 7;             // luma Y (recompute only)
  static constexpr int ACC = 0;            // 129 doubles (CTA sums)
  static constexpr int P = ACC + 2 * 130;
  static constexpr int G = P + 144;        // 3 planes, tile+-4
  static constexpr int XS = G + 3 * area(4);
  static constexpr int SS = XS + area(HX);
  static constexpr int DEB = SS + area(HS);  // 3 planes, tile+-4
  static constexpr int T = DEB + 3 * area(4);
  static constexpr int DT = T + area(4);   // box +-8, written on +-4
  static constexpr int DU = DT + area(8);  // tile+-1
  static constexpr int DV = DU + area(1);
  static constexpr int DS = DV + area(1);  // tile+-2
  static constexpr int Y1 = DS + area(2);  // tile+-1
  static constexpr int YS = DS;            // recompute only, tile+-7
  static constexpr int DDEB = Y1 + area(1);  // 3 boxes +-3, written on +-1
  static constexpr int RED = DDEB + 3 * area(3);
  static constexpr int TOTAL = RED + 16 * 28;
  static constexpr size_t BYTES = TOTAL * sizeof(float);
  static_assert(kRes || area(HY) <= DDEB - DS, "Y fits over ds and Y1");
  static_assert(G % 4 == 0 && XS % 4 == 0 && SS % 4 == 0 && DEB % 4 == 0 &&
                    T % 4 == 0,
                "16-byte-aligned input planes");
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

// Whether every lane of the warp that runs with this one takes the fast
// path: a border position anywhere in the warp sends all of it down the
// general gather, which gives an interior position bitwise the same value.
__device__ __forceinline__ bool warp_all(bool fast) {
  return __all_sync(__activemask(), fast);
}

// q and every index within +-k of it inside [0, n)
__device__ __forceinline__ bool inside(int q, int k, int n) {
  return q >= k && q < n - k;
}

__device__ __forceinline__ void cp_async_f32(float* dst, const float* src,
                                             bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_f32x4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The tile `t` of the CTA's walk: image b and the tile's origin.
struct Tile {
  int b, r0, c0;
};

__device__ __forceinline__ Tile tile_at(int t, int tiles_w, int per_img) {
  const int b = t / per_img, k = t - b * per_img;
  const int tr = k / tiles_w;
  return Tile{b, tr * TILE, (k - tr * tiles_w) * TILE};
}

// Starts copying the image plane `src` (H x W) on the tile's box +-HALO
// into `dst` (side S), zero outside the image. `vec`: the box lies inside
// the image and its rows are 16-byte aligned.
template <int HALO>
__device__ __forceinline__ void load_box(float* dst, const float* src,
                                         const Tile& tl, int H, int W,
                                         bool vec) {
  constexpr int S = side(HALO);
  const int rb = tl.r0 - HALO, cb = tl.c0 - HALO;
  if (vec) {
    constexpr int Q = S / 4;
    for (int i = threadIdx.x; i < S * Q; i += NTHREADS) {
      const int row = i / Q, q = i - row * Q;
      cp_async_f32x4(dst + row * S + 4 * q,
                     src + (size_t)(rb + row) * W + cb + 4 * q);
    }
  } else {
    for (int i = threadIdx.x; i < S * S; i += NTHREADS) {
      const int row = i / S, col = i - row * S;
      const int r = rb + row, c = cb + col;
      const bool in = in_image(r, c, H, W);
      cp_async_f32(dst + i, in ? src + (size_t)r * W + c : src, in);
    }
  }
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
__global__ void __launch_bounds__(NTHREADS, CTAS_PER_SM)
fused_isp_bwd_kernel(const float* __restrict__ raw,
                     const float* __restrict__ g,
                     const float* __restrict__ res,
                     const float* __restrict__ params,
                     float* __restrict__ d_raw,
                     double* __restrict__ partials, int B, int H, int W,
                     int vec_ok) {
  using L = Layout<kRes>;
  extern __shared__ __align__(16) float sm[];
  double* acc64 = reinterpret_cast<double*>(sm + L::ACC);
  float* p = sm + L::P;
  float* red = sm + L::RED;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t plane = (size_t)H * W;
  const int tiles_w = (W + TILE - 1) / TILE;
  const int per_img = tiles_w * ((H + TILE - 1) / TILE);
  const int n_tiles = B * per_img;

  for (int i = tid; i < P_COUNT; i += NTHREADS) p[i] = params[i];
  for (int i = tid; i < N_PARTIALS; i += NTHREADS) acc64[i] = 0.0;
  for (int i = tid; i < area(8); i += NTHREADS) sm[L::DT + i] = 0.f;
  for (int i = tid; i < 3 * area(3); i += NTHREADS) sm[L::DDEB + i] = 0.f;

  // box +-HALO of the tile inside the image, rows 16-byte aligned
  auto vec = [&](const Tile& tl, int halo) {
    return vec_ok && tl.r0 - halo >= 0 && tl.r0 + TILE + halo <= H &&
           tl.c0 - halo >= 0 && tl.c0 + TILE + halo <= W;
  };
  auto load_g_t = [&](const Tile& tl) {
    const bool v = vec(tl, 4);
#pragma unroll
    for (int k = 0; k < 3; ++k)
      load_box<4>(sm + L::G + k * area(4), g + ((size_t)tl.b * 3 + k) * plane,
                  tl, H, W, v);
    if constexpr (kRes)
      load_box<4>(sm + L::T, res + ((size_t)tl.b * 5 + 4) * plane, tl, H, W,
                  v);
  };
  auto load_s = [&](const Tile& tl) {
    load_box<4>(sm + L::SS, res + ((size_t)tl.b * 5 + 3) * plane, tl, H, W,
                vec(tl, 4));
  };
  auto load_deb = [&](const Tile& tl) {
    const bool v = vec(tl, 4);
#pragma unroll
    for (int k = 0; k < 3; ++k)
      load_box<4>(sm + L::DEB + k * area(4),
                  res + ((size_t)tl.b * 5 + k) * plane, tl, H, W, v);
  };
  auto load_x = [&](const Tile& tl) {
    load_box<L::HX>(sm + L::XS, raw + (size_t)tl.b * plane, tl, H, W,
                    vec(tl, L::HX));
  };

  // The debayer taps of the thread's own site class: its pixels lie in
  // rows warp + 8k and column lane of tiles with even origins, so their
  // class is (warp & 1) + (lane & 1) on every tile.
  __syncthreads();
  float kd[27];
#pragma unroll
  for (int q = 0; q < 27; ++q)
    kd[q] = p[P_KDEB + (q / 3) * 9 + ((warp & 1) + (lane & 1)) * 3 + q % 3];

  // Per-thread sums, kept across tiles until a flush: s28 dK_debayer's
  // 27 products of the thread's site class and -d_raw (d_black_level);
  // s10 dA (k*3+c) and d_gamma. dK_blur and dK_sharp go to the CTA's sums
  // once per tile (stages 3 and 6).
  float s28[28], s10[10];
#pragma unroll
  for (int j = 0; j < 28; ++j) s28[j] = 0.f;
#pragma unroll
  for (int j = 0; j < 10; ++j) s10[j] = 0.f;

  // CTA k walks the tiles [k n / grid, (k + 1) n / grid) in order: a run
  // of consecutive tiles, edge and interior alike.
  const int first = (int)((long long)blockIdx.x * n_tiles / gridDim.x);
  const int last = (int)((long long)(blockIdx.x + 1) * n_tiles / gridDim.x);
  int t = first;
  if (t < last) {
    const Tile tl = tile_at(t, tiles_w, per_img);
    load_g_t(tl);
    if constexpr (kRes) {
      load_s(tl);
      load_deb(tl);
    }
    load_x(tl);
    cp_async_commit();
  }

  for (int n = 0; t < last; ++n, ++t) {
    const Tile tl = tile_at(t, tiles_w, per_img);
    const bool more = t + 1 < last;
    const Tile nx = tile_at(more ? t + 1 : t, tiles_w, per_img);
    const int r0 = tl.r0, c0 = tl.c0;
    const float* img = raw + (size_t)tl.b * plane;
    const Box<4> gs[3] = {{sm + L::G, r0, c0},
                          {sm + L::G + area(4), r0, c0},
                          {sm + L::G + 2 * area(4), r0, c0}};
    const Box<L::HX> xs{sm + L::XS, r0, c0};
    const Box<L::HS> ss{sm + L::SS, r0, c0};
    const Box<4> deb[3] = {{sm + L::DEB, r0, c0},
                           {sm + L::DEB + area(4), r0, c0},
                           {sm + L::DEB + 2 * area(4), r0, c0}};
    const Box<4> tt{sm + L::T, r0, c0};
    const Box<8> dt{sm + L::DT, r0, c0};
    const Box<1> du{sm + L::DU, r0, c0};
    const Box<1> dv{sm + L::DV, r0, c0};
    const Box<2> ds{sm + L::DS, r0, c0};
    const Box<1> y1{sm + L::Y1, r0, c0};
    const Box<3> ddeb[3] = {{sm + L::DDEB, r0, c0},
                            {sm + L::DDEB + area(3), r0, c0},
                            {sm + L::DDEB + 2 * area(3), r0, c0}};

    cp_async_wait_all();
    __syncthreads();

    // 1. The mosaic minus black level (the debayer's reflect ring from
    //    device memory, 0 further out) on the positions the tile reads:
    //    tile+-1 with residuals, tile+-8 for the recompute; then the
    //    recompute's Y on tile+-7, s on tile+-6, deb and t on tile+-4
    //    (zero outside the image).
    {
      constexpr int HF = kRes ? 1 : 8, SF = side(HF);
      for (int i = tid; i < SF * SF; i += NTHREADS) {
        const int rr = i / SF;
        const int r = r0 - HF + rr, c = c0 - HF + (i - rr * SF);
        float& x = xs.at(r, c);
        x = in_image(r, c, H, W) ? x - p[P_BL + (r & 1) * 2 + (c & 1)]
                                 : mosaic_at(img, p, r, c, H, W);
      }
    }
    if constexpr (!kRes) {
      __syncthreads();
      const Plane xp = xs.plane();
      const Plane ys = make_plane(sm + L::YS, r0, c0, L::HY);
      for (int i = tid; i < area(L::HY); i += NTHREADS) {
        const int rr = i / side(L::HY);
        const int r = r0 - L::HY + rr,
                  c = c0 - L::HY + (i - rr * side(L::HY));
        float y = 0.f;
        if (in_image(r, c, H, W)) {
          float d0, d1, d2;
          debayer_at(xp, r, c, p, d0, d1, d2);
          y = mix_row(p + P_A, d0, d1, d2);
        }
        ys.data[i] = y;
      }
      __syncthreads();
      for (int i = tid; i < area(L::HS); i += NTHREADS) {
        const int rr = i / side(L::HS);
        const int r = r0 - L::HS + rr,
                  c = c0 - L::HS + (i - rr * side(L::HS));
        ss.d[i] = in_image(r, c, H, W) ? sharpen_at(ys, r, c, p) : 0.f;
      }
      __syncthreads();
      const Plane sp = ss.plane();
      for (int i = tid; i < area(4); i += NTHREADS) {
        const int rr = i / side(4);
        const int r = r0 - 4 + rr, c = c0 - 4 + (i - rr * side(4));
        float d0 = 0.f, d1 = 0.f, d2 = 0.f, tv = 0.f;
        if (in_image(r, c, H, W)) {
          debayer_at(xp, r, c, p, d0, d1, d2);
          tv = blur_at(sp, r, c, H, W, p);
        }
        deb[0].d[i] = d0;
        deb[1].d[i] = d1;
        deb[2].d[i] = d2;
        tt.d[i] = tv;
      }
    }
    __syncthreads();

    // 2. dv on tile+-4 -> dt there, dU and dV on tile+-1; on the tile's
    //    own pixels d_gamma and the dU, dV rows of dA.
    const float inv_g = 1.0f / p[P_GAMMA];
    for (int i = tid; i < area(4); i += NTHREADS) {
      const int rr = i / side(4), cc = i - rr * side(4);
      const int r = r0 - 4 + rr, c = c0 - 4 + cc;
      float dtv = 0.f, duv = 0.f, dvv = 0.f;
      if (in_image(r, c, H, W)) {
        const float d0 = deb[0].d[i], d1 = deb[1].d[i], d2 = deb[2].d[i];
        const float tv = tt.d[i];
        const float u = mix_row(p + P_A + 3, d0, d1, d2);
        const float v = mix_row(p + P_A + 6, d0, d1, d2);
        const bool own = rr >= 4 && rr < 4 + TILE && cc >= 4 && cc < 4 + TILE;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          const float pre = pre_clip(p, ch, tv, u, v);
          const float cl = clip(pre);
          const float lg = logf(cl);
          const float o = expf(lg * inv_g);
          const float gg = gs[ch].d[i];
          const float dvc =
              (pre >= 1e-5f && pre <= 1.0f) ? gg * (o * inv_g / cl) : 0.f;
          if (own) s10[9] += gg * o * (-lg) * inv_g * inv_g;
          dtv = fmaf(p[P_MINV + ch * 3 + 0], dvc, dtv);
          duv = fmaf(p[P_MINV + ch * 3 + 1], dvc, duv);
          dvv = fmaf(p[P_MINV + ch * 3 + 2], dvc, dvv);
        }
        if (own) {
          s10[3] = fmaf(duv, d0, s10[3]);
          s10[4] = fmaf(duv, d1, s10[4]);
          s10[5] = fmaf(duv, d2, s10[5]);
          s10[6] = fmaf(dvv, d0, s10[6]);
          s10[7] = fmaf(dvv, d1, s10[7]);
          s10[8] = fmaf(dvv, d2, s10[8]);
        }
      }
      dt.at(r, c) = dtv;
      if (rr >= 3 && rr < 5 + TILE && cc >= 3 && cc < 5 + TILE) {
        du.at(r, c) = duv;
        dv.at(r, c) = dvv;
      }
    }
    __syncthreads();
    if (more) {
      load_g_t(nx);
      cp_async_commit();
    }

    // 3. ds on tile+-2: the blur's reflect-2 adjoint, gathered, then
    //    dK_blur. The gather reads dt at each mirror of the position,
    //    unchecked: outside the image the dt box holds zeros.
    //    Each thread takes a strip of DS_ROWS positions down one column
    //    of the box: 10 dt values per column tap feed its 6 outputs.
    for (int w = tid; w < area(2) / DS_ROWS; w += NTHREADS) {
      const int seg = w / side(2), cc = w - seg * side(2);
      const int rb = r0 - 2 + seg * DS_ROWS, c = c0 - 2 + cc;
      float acc[DS_ROWS];
#pragma unroll
      for (int j = 0; j < DS_ROWS; ++j) acc[j] = 0.f;
      if (warp_all(inside(rb, 3, H) && inside(rb + DS_ROWS - 1, 3, H) &&
                   inside(c, 3, W))) {
#pragma unroll
        for (int b = 0; b < 5; ++b) {
          float col[DS_ROWS + 4];
#pragma unroll
          for (int m = 0; m < DS_ROWS + 4; ++m)
            col[m] = dt.at(rb - 2 + m, c - b + 2);
#pragma unroll
          for (int a = 0; a < 5; ++a) {
            const float k = p[P_KBLUR + a * 5 + b];
#pragma unroll
            for (int j = 0; j < DS_ROWS; ++j)
              acc[j] = fmaf(k, col[j - a + 4], acc[j]);
          }
        }
      } else {
        for (int j = 0; j < DS_ROWS; ++j) {
          const int r = rb + j;
          if (!in_image(r, c, H, W)) continue;
          float sum = 0.f;
          for (int er = 0; er < 3; ++er) {
            int mr;
            if (!mirror(r, er, H, 2, mr)) continue;
            for (int ec = 0; ec < 3; ++ec) {
              int mc;
              if (!mirror(c, ec, W, 2, mc)) continue;
#pragma unroll
              for (int b = 0; b < 5; ++b) {
#pragma unroll
                for (int a = 0; a < 5; ++a)
                  sum = fmaf(p[P_KBLUR + a * 5 + b],
                             dt.at(mr - a + 2, mc - b + 2), sum);
              }
            }
          }
          acc[j] = sum;
        }
      }
#pragma unroll
      for (int j = 0; j < DS_ROWS; ++j) ds.at(rb + j, c) = acc[j];
    }
    // dK_blur: warp b < 5 takes column tap b, one tile column per lane,
    // and walks down the tile's rows: dt times s at the blur's reflected
    // positions (a window of 5 rows), for the 5 row taps a. The lanes'
    // sums meet in a fixed butterfly; lane 0 adds them to the CTA's sums.
    if (warp < 5) {
      const int b = warp, c = c0 + lane;
      const int rows = min(TILE, H - r0);
      float k5[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
      if (c < W) {
        const int cs = reflect(c + b - 2, W);
        if (r0 >= 2 && r0 + TILE + 2 <= H) {
          float w0 = ss.at(r0 - 2, cs), w1 = ss.at(r0 - 1, cs),
                w2 = ss.at(r0, cs), w3 = ss.at(r0 + 1, cs);
#pragma unroll
          for (int k = 0; k < TILE; ++k) {
            const float w4 = ss.at(r0 + k + 2, cs);
            const float dtv = dt.at(r0 + k, c);
            k5[0] = fmaf(dtv, w0, k5[0]);
            k5[1] = fmaf(dtv, w1, k5[1]);
            k5[2] = fmaf(dtv, w2, k5[2]);
            k5[3] = fmaf(dtv, w3, k5[3]);
            k5[4] = fmaf(dtv, w4, k5[4]);
            w0 = w1;
            w1 = w2;
            w2 = w3;
            w3 = w4;
          }
        } else {
          for (int k = 0; k < rows; ++k) {
            const int r = r0 + k;
            const float dtv = dt.at(r, c);
#pragma unroll
            for (int a = 0; a < 5; ++a)
              k5[a] = fmaf(dtv, ss.at(reflect(r + a - 2, H), cs), k5[a]);
          }
        }
      }
#pragma unroll
      for (int a = 0; a < 5; ++a) {
#pragma unroll
        for (int m = 16; m > 0; m >>= 1)
          k5[a] += __shfl_xor_sync(0xffffffffu, k5[a], m);
      }
      if (lane == 0) {
#pragma unroll
        for (int a = 0; a < 5; ++a) acc64[Q_DKBLUR + a * 5 + b] += k5[a];
      }
    }
    __syncthreads();
    if (kRes && more) {
      load_s(nx);
      cp_async_commit();
    }

    // 4. On tile+-1: dY (the sharpen's zero-pad adjoint), Y, and
    //    ddeb = A^T . (dY, dU, dV); on the own pixels the dY row of dA.
    for (int i = tid; i < area(1); i += NTHREADS) {
      const int rr = i / side(1), cc = i - rr * side(1);
      const int r = r0 - 1 + rr, c = c0 - 1 + cc;
      float dyv = 0.f, yv = 0.f, dd[3] = {0.f, 0.f, 0.f};
      if (in_image(r, c, H, W)) {
        // ds is zero outside the image: the zero pad's adjoint needs no
        // border case
#pragma unroll
        for (int a = 0; a < 3; ++a) {
#pragma unroll
          for (int b = 0; b < 3; ++b)
            dyv = fmaf(p[P_KSHARP + a * 3 + b], ds.at(r - a + 1, c - b + 1),
                       dyv);
        }
        const float d0 = deb[0].at(r, c), d1 = deb[1].at(r, c),
                    d2 = deb[2].at(r, c);
        yv = mix_row(p + P_A, d0, d1, d2);
        const float duv = du.d[i], dvv = dv.d[i];
#pragma unroll
        for (int co = 0; co < 3; ++co)
          dd[co] = fmaf(p[P_A + 6 + co], dvv,
                        fmaf(p[P_A + 3 + co], duv, p[P_A + co] * dyv));
        if (rr >= 1 && rr < 1 + TILE && cc >= 1 && cc < 1 + TILE) {
          s10[0] = fmaf(dyv, d0, s10[0]);
          s10[1] = fmaf(dyv, d1, s10[1]);
          s10[2] = fmaf(dyv, d2, s10[2]);
        }
      }
      y1.d[i] = yv;
#pragma unroll
      for (int co = 0; co < 3; ++co) ddeb[co].at(r, c) = dd[co];
    }
    __syncthreads();
    if (kRes && more) {
      load_deb(nx);
      cp_async_commit();
    }

    // 5. Own pixels (rows warp + 8k, column lane: one RGGB site class per
    //    thread): d_raw (the debayer's reflect-1 adjoint), d_black_level
    //    and dK_debayer.
    for (int k = 0; k < TILE * TILE / NTHREADS; ++k) {
      const int r = r0 + warp + 8 * k, c = c0 + lane;
      if (r >= H || c >= W) continue;
      float dx = 0.f;
      if (warp_all(inside(r, 2, H) && inside(c, 2, W))) {
#pragma unroll
        for (int i = 0; i < 3; ++i) {
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            const int q = (i * 3 + j) * 3, pr = r - i + 1, pc = c - j + 1;
            dx = fmaf(kd[q], ddeb[0].at(pr, pc), dx);
            dx = fmaf(kd[q + 1], ddeb[1].at(pr, pc), dx);
            dx = fmaf(kd[q + 2], ddeb[2].at(pr, pc), dx);
          }
        }
      } else {
        // each mirror of the pixel, its taps unchecked: outside the image
        // the ddeb boxes hold zeros
        for (int er = 0; er < 3; ++er) {
          int mr;
          if (!mirror(r, er, H, 1, mr)) continue;
          for (int ec = 0; ec < 3; ++ec) {
            int mc;
            if (!mirror(c, ec, W, 1, mc)) continue;
#pragma unroll
            for (int i = 0; i < 3; ++i) {
#pragma unroll
              for (int j = 0; j < 3; ++j) {
                const int q = (i * 3 + j) * 3, pr = mr - i + 1,
                          pc = mc - j + 1;
                dx = fmaf(kd[q], ddeb[0].at(pr, pc), dx);
                dx = fmaf(kd[q + 1], ddeb[1].at(pr, pc), dx);
                dx = fmaf(kd[q + 2], ddeb[2].at(pr, pc), dx);
              }
            }
          }
        }
      }
      d_raw[tl.b * plane + (size_t)r * W + c] = dx;
      s28[27] -= dx;
      const float dd0 = ddeb[0].at(r, c), dd1 = ddeb[1].at(r, c),
                  dd2 = ddeb[2].at(r, c);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const float x = xs.at(r + i - 1, c + j - 1);
          const int q = (i * 3 + j) * 3;
          s28[q] = fmaf(dd0, x, s28[q]);
          s28[q + 1] = fmaf(dd1, x, s28[q + 1]);
          s28[q + 2] = fmaf(dd2, x, s28[q + 2]);
        }
      }
    }
    __syncthreads();
    if (more) {
      load_x(nx);
      cp_async_commit();
    }

    // 6. dK_sharp: ds times zero-padded Y, as dK_blur in stage 3: warp
    //    b < 3 takes column tap b, a tile column per lane, down the rows.
    if (warp < 3) {
      const int b = warp, c = c0 + lane;
      const int rows = min(TILE, H - r0);
      float k3[3] = {0.f, 0.f, 0.f};
      if (c < W) {
        float w0 = y1.at(r0 - 1, c + b - 1), w1 = y1.at(r0, c + b - 1);
        for (int k = 0; k < rows; ++k) {
          const float w2 = y1.at(r0 + k + 1, c + b - 1);
          const float dsv = ds.at(r0 + k, c);
          k3[0] = fmaf(dsv, w0, k3[0]);
          k3[1] = fmaf(dsv, w1, k3[1]);
          k3[2] = fmaf(dsv, w2, k3[2]);
          w0 = w1;
          w1 = w2;
        }
      }
#pragma unroll
      for (int a = 0; a < 3; ++a) {
#pragma unroll
        for (int m = 16; m > 0; m >>= 1)
          k3[a] += __shfl_xor_sync(0xffffffffu, k3[a], m);
      }
      if (lane == 0) {
#pragma unroll
        for (int a = 0; a < 3; ++a) acc64[Q_DKSHARP + a * 3 + b] += k3[a];
      }
    }

    // Flush: the sums of every FLUSH tiles, and of the walk's last tiles,
    // into the CTA's float64 sums, each group in a fixed order.
    if ((n + 1) % FLUSH == 0 || !more) {
      reduce_pairs<28>(s28, red);
      __syncthreads();
      // entry e = warp*2 + column parity holds pixels of row parity warp&1
      for (int q = tid; q < 85; q += NTHREADS) {
        double s = 0.0;
        if (q < 81) {
          const int tap = q / 9, ci = (q % 9) / 3, co = q % 3;
          const int i = tap / 3, j = tap % 3;
          for (int e = 0; e < 16; ++e)
            if ((((e >> 1) + i - 1) & 1) + (((e & 1) + j - 1) & 1) == ci)
              s += red[e * 28 + tap * 3 + co];
          acc64[Q_DKDEB + q] += s;
        } else {
          const int cls = q - 81;
          for (int e = 0; e < 16; ++e)
            if (((e >> 1) & 1) * 2 + (e & 1) == cls) s += red[e * 28 + 27];
          acc64[Q_DBL + cls] += s;
        }
      }
      __syncthreads();
      reduce_pairs<10>(s10, red);
      __syncthreads();
      for (int q = tid; q < 10; q += NTHREADS) {
        double s = 0.0;
        for (int e = 0; e < 16; ++e) s += red[e * 10 + q];
        acc64[q < 9 ? Q_DA + q : Q_DGAMMA] += s;
      }
#pragma unroll
      for (int j = 0; j < 28; ++j) s28[j] = 0.f;
#pragma unroll
      for (int j = 0; j < 10; ++j) s10[j] = 0.f;
    }
  }
  __syncthreads();
  for (int q = tid; q < N_PARTIALS; q += NTHREADS)
    partials[(size_t)blockIdx.x * N_PARTIALS + q] = acc64[q];
}

int ctas_for(int B, int H, int W, int sms) {
  const long n = (long)B * ((H + TILE - 1) / TILE) * ((W + TILE - 1) / TILE);
  const long most = (long)sms * CTAS_PER_SM;
  return (int)(n < most ? n : most);
}

bool aligned16(const void* ptr) {
  return ptr == nullptr || ((uintptr_t)ptr & 15) == 0;
}

template <bool kRes>
int launch(const float* raw, const float* g, const float* res,
           const float* params, float* d_raw, double* partials, int B, int H,
           int W, int ctas, void* stream) {
  const size_t bytes = Layout<kRes>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      fused_isp_bwd_kernel<kRes>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  if (ctas <= 0) return 0;
  const int vec_ok = W % 4 == 0 && aligned16(raw) && aligned16(g) &&
                     aligned16(res);
  fused_isp_bwd_kernel<kRes><<<ctas, NTHREADS, bytes, (cudaStream_t)stream>>>(
      raw, g, res, params, d_raw, partials, B, H, W, vec_ok);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The grid of r2l_fused_isp_bwd on (B, H, W) on a card with `sms` SMs:
// CTAS_PER_SM per SM, at most one per 32x32 tile. A function of the shape
// and the card only, so repeated launches are bitwise equal.
int r2l_fused_isp_bwd_ctas(int B, int H, int W, int sms) {
  return ctas_for(B, H, W, sms);
}

// Launches on `stream` and returns cudaGetLastError() after the launch.
// `res` null selects the recompute variant. `partials` holds 129 doubles
// for each of the `ctas` CTAs (r2l_fused_isp_bwd_ctas).
int r2l_fused_isp_bwd(const float* raw, const float* g, const float* res,
                      const float* params, float* d_raw, double* partials,
                      int B, int H, int W, int ctas, void* stream) {
  if (res != nullptr)
    return launch<true>(raw, g, res, params, d_raw, partials, B, H, W, ctas,
                        stream);
  return launch<false>(raw, g, nullptr, params, d_raw, partials, B, H, W,
                       ctas, stream);
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
