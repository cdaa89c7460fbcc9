// K4 and K5: the textured-material tap planner and texel filter.
//
// K4 awsm_tap_plan replaces awsm_renderer_tpu/ops/texsample.py::
// _tap_plan_fused (pallas_call at texsample.py:403). One thread per tap:
// the optional KHR_texture_transform (wrap-first fract, affine uv map,
// Jacobian push-forward of the four screen gradients), the descriptor
// row, the anisotropy-aware LOD 0.5*log2(max(min(rx,ry), max(rx,ry)/an^2))
// clamped to the texture's mips, the mip level's size and texel offset,
// the wrapped texel-row index of the bilinear anchor, and the 11 filter
// weights (bilinear quad, parent-mip 3x3 stencil, trilinear blend). The
// TPU kernel fetched descriptor and transform rows with one-hot matmuls
// on the MXU, split the mip offsets into exact 12-bit f32 halves and
// wrapped with an f32-reciprocal remainder (Mosaic workarounds); here a
// thread reads its rows from global memory (a few KB, L1/L2 resident),
// reads the offset straight from the int32 descriptor, and wraps with an
// exact integer floor-mod.
//
// K5 awsm_filter_taps replaces awsm_renderer_tpu/ops/texsample.py::
// _filter_taps_fused (pallas_call at texsample.py:448) together with the
// XLA texel gather that fed it: each thread clips its row index, takes
// the 16 (no mips) or 52 (mips) bf16 columns of its 128-byte texel row,
// widens them exactly to f32 and evaluates the filter. The TPU pair
// materialised the gathered (N, 64) bf16 block (1.33 GB for the helmet's
// five taps per pixel at 1080p); the fused form reads each row once.
//
// Both evaluate the plain PyTorch twins' expressions (ops/texsample.py
// tap_plan_reference, filter_taps_reference) operation by operation,
// and the library is built with -fmad=false, so every product and sum
// rounds like the twin's separate tensor ops. Min/max/clamp here
// propagate NaN like torch.maximum/minimum/clamp.
//
// What bounds them on the H100: K4 is ALU and bytes (24 B in, 48 B out
// per tap, plus descriptor reads that hit cache). K5 moves the index and
// the weight planes it reads (4 B + 16 B or 44 B a tap), 16 B of output a
// tap and each distinct texel row once; the rows are a scattered gather
// (from DRAM when the pool exceeds the 50 MB L2, as the helmet's five
// 1024x1024 maps do). Its first form read a row as 52 two-byte loads, so
// every warp load instruction touched 32 different rows, 52 times a tap.
// Now a thread reads its row as 16-byte vectors on the read-only path (7
// with mips), and the index and the weights stream in with evict-first
// loads, so the L2 keeps the rows; on an NVIDIA H100 (700 W) it runs at
// 76% of its bound on the 1080p stress frame and 86% on the helmet
// (PERF.md).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// core/textures.py descriptor layout
constexpr int TD_WIDTH = 0, TD_HEIGHT = 1, TD_N_MIPS = 2, TD_WRAP_S = 3;
constexpr int TD_WRAP_T = 4, TD_FILTER_LINEAR = 5, TD_MIP_FILTER_LINEAR = 6;
constexpr int TD_MAX_ANISO = 7, TD_MIP_OFFSETS = 8, MAX_MIPS = 14;
constexpr int WRAP_REPEAT = 0, WRAP_CLAMP = 1, WRAP_MIRROR = 2;
constexpr int NW = 11;  // weight planes

__device__ __forceinline__ float maxp(float a, float b) {
  return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ float minp(float a, float b) {
  return (a < b || a != a) ? a : b;
}

// float -> int32 of an already-floored coordinate: NaN -> 0, clamped to
// +-2^30 first (the twin does the same; an out-of-range cast is undefined
// in C++ and saturates in PTX)
__device__ __forceinline__ int to_int(float x) {
  if (x != x) return 0;
  return (int)fminf(fmaxf(x, -1073741824.f), 1073741824.f);
}

__device__ __forceinline__ int floor_mod(int a, int n) {
  const int r = a % n;  // C truncates toward zero; fix the sign
  return r < 0 ? r + n : r;
}

// _wrap_coord: integer texel coordinate into [0, n) by sampler mode
__device__ __forceinline__ int wrap_coord(int i, int n, int mode) {
  if (mode == WRAP_REPEAT) return floor_mod(i, n);
  if (mode == WRAP_CLAMP) return min(max(i, 0), n - 1);
  const int m = floor_mod(i, 2 * n);
  return m >= n ? 2 * n - 1 - m : m;
}

// _prep_coord: continuous texel coordinate with the wrap baked in
__device__ __forceinline__ float prep_coord(float u, float nf, int mode) {
  float up = u;
  if (mode == WRAP_MIRROR) {
    const float h = u * 0.5f;
    up = 1.0f - fabsf(2.0f * (h - floorf(h)) - 1.0f);
  }
  float x = up * nf - 0.5f;
  if (mode != WRAP_REPEAT) x = minp(maxp(x, 0.0f), nf - 1.0f);
  return x;
}

__device__ __forceinline__ float snap(float f, bool linear,
                                      int has_nearest) {
  if (has_nearest && !linear) return f >= 0.5f ? 1.0f : 0.0f;
  return f;
}

__global__ void tap_plan_kernel(
    const int* __restrict__ tex_id, const int* __restrict__ tform_id,
    const float* __restrict__ u_in, const float* __restrict__ v_in,
    const float* __restrict__ dudx_in, const float* __restrict__ dvdx_in,
    const float* __restrict__ dudy_in, const float* __restrict__ dvdy_in,
    const int* __restrict__ desc, int capD, int DC,
    const float* __restrict__ ttab, int capT, int N, int mips, int tform,
    int has_nearest, int* __restrict__ out_idx, float* __restrict__ out_w) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  float uu = u_in[i], vv = v_in[i];
  float dudx = 0.f, dvdx = 0.f, dudy = 0.f, dvdy = 0.f;
  if (mips) {
    dudx = dudx_in[i];
    dvdx = dvdx_in[i];
    dudy = dudy_in[i];
    dvdy = dvdy_in[i];
  }
  if (tform) {
    const int tf = tform_id[i];
    if (tf >= 0) {
      const float* T = ttab + (size_t)min(tf, capT - 1) * 8;
      const bool wrap_first = T[6] > 0.5f;
      const float uw = wrap_first ? uu - floorf(uu) : uu;
      const float vw = wrap_first ? vv - floorf(vv) : vv;
      uu = T[0] * uw + T[1] * vw + T[4];
      vv = T[2] * uw + T[3] * vw + T[5];
      if (mips) {
        const float a = T[0] * dudx + T[1] * dvdx;
        const float b = T[2] * dudx + T[3] * dvdx;
        const float c = T[0] * dudy + T[1] * dvdy;
        const float d = T[2] * dudy + T[3] * dvdy;
        dudx = a;
        dvdx = b;
        dudy = c;
        dvdy = d;
      }
    }
  }
  const int* D = desc + (size_t)min(max(tex_id[i], 0), capD - 1) * DC;
  const int w0 = D[TD_WIDTH], h0 = D[TD_HEIGHT];
  const int wrap_s = D[TD_WRAP_S], wrap_t = D[TD_WRAP_T];
  const bool linear = D[TD_FILTER_LINEAR] > 0;
  const bool tri = D[TD_MIP_FILTER_LINEAR] > 0;

  int l0 = 0;
  float frac = 0.f;
  if (mips) {
    const float wf0 = (float)w0, hf0 = (float)h0;
    const float an = maxp((float)D[TD_MAX_ANISO], 1.0f);
    const float ax_ = dudx * wf0, bx_ = dvdx * hf0;
    const float ay_ = dudy * wf0, by_ = dvdy * hf0;
    const float rx = ax_ * ax_ + bx_ * bx_;
    const float ry = ay_ * ay_ + by_ * by_;
    const float r_eff = maxp(minp(rx, ry), maxp(rx, ry) / (an * an));
    float level = 0.5f * log2f(maxp(r_eff, 1e-12f));
    // clip to [0, n_mips - 1]; the lower bound last, so a dead
    // descriptor (n_mips 0) still gives level 0
    level = maxp(minp(level, (float)D[TD_N_MIPS] - 1.0f), 0.0f);
    if (level != level) level = 0.0f;
    l0 = (int)floorf(level);
    frac = level - (float)l0;
  }
  const int wm = max(w0 >> l0, 1), hm = max(h0 >> l0, 1);
  const int offset = D[TD_MIP_OFFSETS + min(l0, MAX_MIPS - 1)];
  const float wf = (float)wm, hf = (float)hm;
  const float x = prep_coord(uu, wf, wrap_s);
  const float y = prep_coord(vv, hf, wrap_t);
  const float x0 = floorf(x), y0 = floorf(y);
  const float fx = snap(x - x0, linear, has_nearest);
  const float fy = snap(y - y0, linear, has_nearest);
  const int x0i = wrap_coord(to_int(x0), wm, wrap_s);
  const int y0i = wrap_coord(to_int(y0), hm, wrap_t);
  out_idx[i] = offset + y0i * wm + x0i;

  float w[NW];
  w[0] = (1.0f - fx) * (1.0f - fy);
  w[1] = fx * (1.0f - fy);
  w[2] = (1.0f - fx) * fy;
  w[3] = fx * fy;
#pragma unroll
  for (int k = 4; k < NW; ++k) w[k] = 0.f;
  if (mips) {
    // parent-mip 3x3 anchor (core/textures.py _pack_rows layout): the
    // parent's bilinear anchor from uv, located inside the baked 3x3 by
    // its wrapped offset from base = (x0i - 1) >> 1 (arithmetic shift)
    const int w1 = max(wm >> 1, 1), h1 = max(hm >> 1, 1);
    const float x1 = prep_coord(uu, (float)w1, wrap_s);
    const float y1 = prep_coord(vv, (float)h1, wrap_t);
    const float axf = floorf(x1), ayf = floorf(y1);
    const float fx1 = snap(x1 - axf, linear, has_nearest);
    const float fy1 = snap(y1 - ayf, linear, has_nearest);
    const int axw = wrap_coord(to_int(axf), w1, wrap_s);
    const int ayw = wrap_coord(to_int(ayf), h1, wrap_t);
    const int bx = wrap_coord((x0i - 1) >> 1, w1, wrap_s);
    const int by = wrap_coord((y0i - 1) >> 1, h1, wrap_t);
    const int ddx = axw - bx, ddy = ayw - by;
    const bool dx1 = (ddx < 0 ? ddx + w1 : ddx) >= 1;
    const bool dy1 = (ddy < 0 ? ddy + h1 : ddy) >= 1;
    w[4] = dx1 ? 0.0f : 1.0f - fx1;
    w[5] = dx1 ? 1.0f - fx1 : fx1;
    w[6] = dx1 ? fx1 : 0.0f;
    w[7] = dy1 ? 0.0f : 1.0f - fy1;
    w[8] = dy1 ? 1.0f - fy1 : fy1;
    w[9] = dy1 ? fy1 : 0.0f;
    w[10] = tri ? frac : 0.0f;
  }
#pragma unroll
  for (int k = 0; k < NW; ++k) out_w[(size_t)k * N + i] = w[k];
}

constexpr int TEXEL_COLS = 64;  // core/textures.py: 128-byte bf16 rows
constexpr int ROW_VECS = TEXEL_COLS / 8;  // 16-byte vectors a row
constexpr int K5_THREADS = 256;

// the 8 bf16 columns of a 16-byte vector, widened exactly to f32 (the
// lower address holds the lower half of each word)
__device__ __forceinline__ void widen(const uint4& v, float* q) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    q[2 * k] = __uint_as_float(w[k] << 16);
    q[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

// one thread a tap. The texel rows are read on the read-only path as
// 16-byte vectors (7 with mips: columns 0..55 of the 64, holding the 52
// read; 2 without: the 16), the index and the weight planes once each
// with evict-first loads, the output with streaming stores. Each thread
// evaluates the twin's expressions in the twin's order. (A warp staging
// its 32 taps' rows in shared memory, each 16-byte load instruction
// fetching whole rows, was slower: scripts/k9_k5_variants.py.)
template <bool MIPS>
__global__ void __launch_bounds__(K5_THREADS)
filter_taps_kernel(const uint4* __restrict__ texq, int R,
                   const int* __restrict__ idx, const float* __restrict__ w,
                   int N, float* __restrict__ out) {
  constexpr int V = MIPS ? 7 : 2;  // vectors a tap reads
  const int i = blockIdx.x * K5_THREADS + threadIdx.x;
  if (i >= N) return;
  const int r = min(max(__ldcs(idx + i), 0), R - 1);
  uint4 v[V];
#pragma unroll
  for (int k = 0; k < V; ++k) v[k] = __ldg(texq + (size_t)r * ROW_VECS + k);
  float q[8 * V];
#pragma unroll
  for (int k = 0; k < V; ++k) widen(v[k], q + 8 * k);
  const float w00 = __ldcs(w + i), w10 = __ldcs(w + (size_t)N + i);
  const float w01 = __ldcs(w + 2 * (size_t)N + i);
  const float w11 = __ldcs(w + 3 * (size_t)N + i);
  if constexpr (!MIPS) {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      __stcs(out + (size_t)c * N + i,
             q[c] * w00 + q[4 + c] * w10 + q[8 + c] * w01 + q[12 + c] * w11);
  } else {
    const float wx0 = __ldcs(w + 4 * (size_t)N + i);
    const float wx1 = __ldcs(w + 5 * (size_t)N + i);
    const float wx2 = __ldcs(w + 6 * (size_t)N + i);
    const float wy0 = __ldcs(w + 7 * (size_t)N + i);
    const float wy1 = __ldcs(w + 8 * (size_t)N + i);
    const float wy2 = __ldcs(w + 9 * (size_t)N + i);
    const float blend = __ldcs(w + 10 * (size_t)N + i);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float quad =
          q[c] * w00 + q[4 + c] * w10 + q[8 + c] * w01 + q[12 + c] * w11;
      const float par =
          (q[16 + c] * wx0 + q[20 + c] * wx1 + q[24 + c] * wx2) * wy0 +
          (q[28 + c] * wx0 + q[32 + c] * wx1 + q[36 + c] * wx2) * wy1 +
          (q[40 + c] * wx0 + q[44 + c] * wx1 + q[48 + c] * wx2) * wy2;
      __stcs(out + (size_t)c * N + i, quad * (1.0f - blend) + par * blend);
    }
  }
}

}  // namespace

extern "C" int awsm_tap_plan(const int* tex_id, const int* tform_id,
                             const float* u, const float* v,
                             const float* dudx, const float* dvdx,
                             const float* dudy, const float* dvdy,
                             const int* desc, int capD, int DC,
                             const float* ttab, int capT, int N, int mips,
                             int tform, int has_nearest, int* out_idx,
                             float* out_w, cudaStream_t stream) {
  if (N > 0) {
    const int block = 256;
    tap_plan_kernel<<<(N + block - 1) / block, block, 0, stream>>>(
        tex_id, tform_id, u, v, dudx, dvdx, dudy, dvdy, desc, capD, DC, ttab,
        capT, N, mips, tform, has_nearest, out_idx, out_w);
  }
  return (int)cudaGetLastError();
}

extern "C" int awsm_filter_taps(const uint16_t* texq, int R,
                                const int* idx, const float* w, int N,
                                int mips, float* out, cudaStream_t stream) {
  if (N > 0) {
    const uint4* rows = reinterpret_cast<const uint4*>(texq);
    const int blocks = (N + K5_THREADS - 1) / K5_THREADS;
    if (mips) {
      filter_taps_kernel<true><<<blocks, K5_THREADS, 0, stream>>>(
          rows, R, idx, w, N, out);
    } else {
      filter_taps_kernel<false><<<blocks, K5_THREADS, 0, stream>>>(
          rows, R, idx, w, N, out);
    }
  }
  return (int)cudaGetLastError();
}
