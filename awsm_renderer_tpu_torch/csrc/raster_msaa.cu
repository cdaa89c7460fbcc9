// K9: MSAA-4x coverage raster. Four sample winners (tl, tr, bl, br) and
// the min-sample depth per display pixel, from row-major triangle setup in
// supersampled coordinates (twice the display resolution).
//
// Replaces the TPU kernel awsm_renderer_tpu/ops/raster.py::rasterize16_msaa
// (pallas_call at raster.py:1966, body _make_v5_msaa_kernel at
// raster.py:1730, sample math _msaa_sample_winners at raster.py:1663).
//
// One CTA per 32x32 display tile (one 64x64 supersampled bin), one thread
// per display pixel holding its four (z, winner) sample states in
// registers. The CTA walks its bin's packed entries (g << 8) | (mask1 << 4)
// | mask0 in bin order (the binner's near-first order), staging each
// 16-triangle group's edge and depth planes (16 x 12 floats) in shared
// memory; a thread in quadrant q = (ly >= 16) * 2 + (lx >= 16) merges the
// group only when ((e >> q) & 0x11) != 0, the TPU kernel's gate. Then the
// big-group list with the tile-bbox test, in every quadrant. The TPU
// kernel's DMA ring, big-group VMEM cache, pl.when gating and
// quadrant-major output swizzle are dropped: the planes are written
// display row-major, cropped to the frame.
//
// Per triangle, in index order, per sample (i, j): e = a*px + (b*py + c)
// at the top-left sample center px = 2x + 0.5, py = 2y + 0.5, then + a if
// j, then + b if i (the TPU kernel's rounding); covered when all three
// edges pass e >= (top-left ? 0 : FLT_MIN_NORMAL) and z >= 0; strict
// z < best. That equals the TPU's per-subgroup "min z, lowest index" then
// strict < across subgroups; its missing z <= 1 test is implied because
// the states start at 1.0. -fmad=false and __fmul_rn/__fadd_rn keep every
// rounding, so the plain twin in ops/raster.py is bit-equal.
//
// What bounds it on the H100: the merge ALU, four samples x (3 edges +
// z) per triangle-pixel test over every binned (tile, group) pair, and
// the serial walk of a tile's groups with a __syncthreads pair per group.
// Simple and right first; staging several groups per barrier, skipping
// a quadrant's warps without a branch per entry and persistent CTAs are
// later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NSETUP = 64;
constexpr int GROUP = 16;
constexpr int BT = 32;      // display tile edge (64 supersampled pixels)
constexpr int NPLANE = 12;  // edge triples (0..8) + z-plane (9..11)
constexpr float FMIN = 1.1754943508222875e-38f;

__device__ __forceinline__ float plane(float a, float b, float c, float px,
                                       float py) {
  return __fadd_rn(__fmul_rn(a, px), __fadd_rn(__fmul_rn(b, py), c));
}

__device__ __forceinline__ void merge_group_msaa(const float* s,
                                                 int col_base, float px,
                                                 float py, float (&zs)[4],
                                                 int (&cs)[4]) {
#pragma unroll 2
  for (int k = 0; k < GROUP; ++k) {
    const float* r = s + k * NPLANE;
    float e00[3], ea[3], eb[3], thr[3];
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      const float a = r[3 * e], b = r[3 * e + 1], c = r[3 * e + 2];
      e00[e] = plane(a, b, c, px, py);
      ea[e] = a;
      eb[e] = b;
      thr[e] = ((a > 0.f) || (a == 0.f && b > 0.f)) ? 0.f : FMIN;
    }
    const float za = r[9], zb = r[10];
    const float z00 = plane(za, zb, r[11], px, py);
#pragma unroll
    for (int smp = 0; smp < 4; ++smp) {
      const int i = smp >> 1, j = smp & 1;
      bool cover = true;
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        float v = e00[e];
        if (j) v = __fadd_rn(v, ea[e]);
        if (i) v = __fadd_rn(v, eb[e]);
        cover = cover && (v >= thr[e]);
      }
      float z = z00;
      if (j) z = __fadd_rn(z, za);
      if (i) z = __fadd_rn(z, zb);
      if (cover && z >= 0.f && z < zs[smp]) {
        zs[smp] = z;
        cs[smp] = col_base + k;
      }
    }
  }
}

__device__ __forceinline__ void stage_group(const float* __restrict__ setup,
                                            int g, float* s) {
  __syncthreads();
  if (threadIdx.x < GROUP * NPLANE) {
    const int k = threadIdx.x / NPLANE, j = threadIdx.x % NPLANE;
    s[threadIdx.x] = setup[(size_t)(g * GROUP + k) * NSETUP + j];
  }
  __syncthreads();
}

__global__ void __launch_bounds__(BT * BT)
raster_msaa_kernel(const float* __restrict__ setup,
                   const int* __restrict__ entries,
                   const int* __restrict__ offsets,
                   const int* __restrict__ counts,
                   const int* __restrict__ big_packed,
                   const int* __restrict__ big_ids,
                   const int* __restrict__ n_big, int n_tx, int W1, int H1,
                   int* __restrict__ out_samp,
                   float* __restrict__ out_depth) {
  __shared__ float s[GROUP * NPLANE];
  const int t = blockIdx.x;
  const int tile_x = t % n_tx, tile_y = t / n_tx;
  const int lx = threadIdx.x % BT, ly = threadIdx.x / BT;
  const int q = (ly >= BT / 2) * 2 + (lx >= BT / 2);
  const int x = tile_x * BT + lx, y = tile_y * BT + ly;
  const float px = __fadd_rn(__fmul_rn(2.f, (float)x), 0.5f);
  const float py = __fadd_rn(__fmul_rn(2.f, (float)y), 0.5f);

  float zs[4] = {1.f, 1.f, 1.f, 1.f};
  int cs[4] = {-1, -1, -1, -1};
  const int cnt = counts[t], off = offsets[t];
  for (int b = 0; b < cnt; ++b) {
    const int e = entries[off + b];
    stage_group(setup, e >> 8, s);
    if ((e >> q) & 0x11) merge_group_msaa(s, (e >> 8) * GROUP, px, py, zs, cs);
  }
  const int nb = n_big[0];
  for (int i = 0; i < nb; ++i) {
    const int bb = big_packed[i];
    const int gx0 = bb & 255, gy0 = (bb >> 8) & 255;
    const int gx1 = (bb >> 16) & 255, gy1 = (bb >> 24) & 255;
    if (gx0 <= tile_x && tile_x <= gx1 && gy0 <= tile_y && tile_y <= gy1) {
      const int g = big_ids[i];
      stage_group(setup, g, s);
      merge_group_msaa(s, g * GROUP, px, py, zs, cs);
    }
  }
  if (x < W1 && y < H1) {
    const size_t P = (size_t)W1 * H1, o = (size_t)y * W1 + x;
#pragma unroll
    for (int smp = 0; smp < 4; ++smp) out_samp[smp * P + o] = cs[smp];
    out_depth[o] = fminf(fminf(zs[0], zs[1]), fminf(zs[2], zs[3]));
  }
}

}  // namespace

extern "C" int awsm_raster_msaa(const float* setup, const int* entries,
                                const int* offsets, const int* counts,
                                const int* big_packed, const int* big_ids,
                                const int* n_big, int n_tiles, int n_tx,
                                int W1, int H1, int* out_samp,
                                float* out_depth, cudaStream_t stream) {
  if (n_tiles > 0) {
    raster_msaa_kernel<<<n_tiles, BT * BT, 0, stream>>>(
        setup, entries, offsets, counts, big_packed, big_ids, n_big, n_tx,
        W1, H1, out_samp, out_depth);
  }
  return (int)cudaGetLastError();
}
