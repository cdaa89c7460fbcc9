// K1: binned coverage raster over row-major triangle setup (winner column
// + depth per pixel).
//
// Replaces the TPU kernel awsm_renderer_tpu/ops/raster.py::rasterize16_slim
// (pallas_call at raster.py:1615, body _make_v5_kernel at raster.py:1402).
//
// One CTA per 32x32 tile, one thread per pixel. The CTA reads its own bin
// (offsets[t], counts[t]) and walks the binned 16-triangle groups in entry
// order (the binner's near-first order), staging each group's edge and
// depth planes (16 x 12 floats) in shared memory, then walks the global
// big-group list with the tile-bbox test. Per pixel:
//   - edge test e = a*px + (b*py + c) >= (top-left ? 0 : FLT_MIN_NORMAL),
//   - 0 <= z <= 1,
//   - strict z < best: the triangle met first wins a depth tie, which is
//     the TPU kernel's rule (nearest z, lowest index inside a subgroup;
//     strict < across subgroups and groups).
// The file is compiled with -fmad=false and the plane evaluations use
// explicit __fmul_rn/__fadd_rn, so no FMA contraction changes a rounding
// (contracted edge functions open pinholes along shared edges); the plain
// twin in ops/raster.py gives bit-equal col/depth.
//
// What bounds it on the H100: the per-pixel merge ALU (about 12 flops and
// 4 compares per triangle-pixel test) and the serial walk of a tile's
// groups, with a __syncthreads pair per group. Simple and right first;
// speed (several groups per stage, warp-level early-out on empty group
// bboxes, persistent CTAs) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NSETUP = 64;
constexpr int GROUP = 16;
constexpr int BT = 32;
constexpr int NPLANE = 12;  // edge triples (0..8) + z-plane (9..11)
constexpr float FMIN = 1.1754943508222875e-38f;

__device__ __forceinline__ float plane(float a, float b, float c, float px,
                                       float py) {
  return __fadd_rn(__fmul_rn(a, px), __fadd_rn(__fmul_rn(b, py), c));
}

__device__ __forceinline__ void merge_group(const float* s, int col_base,
                                            float px, float py, float& best_z,
                                            int& best_col) {
#pragma unroll 4
  for (int k = 0; k < GROUP; ++k) {
    const float* r = s + k * NPLANE;
    bool cover = true;
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      const float a = r[3 * e], b = r[3 * e + 1], c = r[3 * e + 2];
      const float v = plane(a, b, c, px, py);
      const bool tl = (a > 0.f) || (a == 0.f && b > 0.f);
      cover = cover && (v >= (tl ? 0.f : FMIN));
    }
    const float z = plane(r[9], r[10], r[11], px, py);
    if (cover && z >= 0.f && z <= 1.f && z < best_z) {
      best_z = z;
      best_col = col_base + k;
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
raster16_kernel(const float* __restrict__ setup,
                const int* __restrict__ entries,
                const int* __restrict__ offsets,
                const int* __restrict__ counts,
                const int* __restrict__ big_packed,
                const int* __restrict__ big_ids,
                const int* __restrict__ n_big, int n_tx, int width,
                int height, int* __restrict__ out_col,
                float* __restrict__ out_depth) {
  __shared__ float s[GROUP * NPLANE];
  const int t = blockIdx.x;
  const int tile_x = t % n_tx, tile_y = t / n_tx;
  const int lx = threadIdx.x % BT, ly = threadIdx.x / BT;
  const float px = (float)(tile_x * BT) + (float)lx + 0.5f;
  const float py = (float)(tile_y * BT) + (float)ly + 0.5f;

  float best_z = 1.f;
  int best_col = -1;
  const int cnt = counts[t], off = offsets[t];
  for (int b = 0; b < cnt; ++b) {
    const int g = entries[off + b];
    stage_group(setup, g, s);
    merge_group(s, g * GROUP, px, py, best_z, best_col);
  }
  const int nb = n_big[0];
  for (int i = 0; i < nb; ++i) {
    const int bb = big_packed[i];
    const int gx0 = bb & 255, gy0 = (bb >> 8) & 255;
    const int gx1 = (bb >> 16) & 255, gy1 = (bb >> 24) & 255;
    if (gx0 <= tile_x && tile_x <= gx1 && gy0 <= tile_y && tile_y <= gy1) {
      const int g = big_ids[i];
      stage_group(setup, g, s);
      merge_group(s, g * GROUP, px, py, best_z, best_col);
    }
  }
  const int x = tile_x * BT + lx, y = tile_y * BT + ly;
  if (x < width && y < height) {
    out_col[(size_t)y * width + x] = best_col;
    out_depth[(size_t)y * width + x] = best_z;
  }
}

}  // namespace

extern "C" int awsm_raster16(const float* setup, const int* entries,
                             const int* offsets, const int* counts,
                             const int* big_packed, const int* big_ids,
                             const int* n_big, int n_tiles, int n_tx,
                             int width, int height, int* out_col,
                             float* out_depth, cudaStream_t stream) {
  if (n_tiles > 0) {
    raster16_kernel<<<n_tiles, BT * BT, 0, stream>>>(
        setup, entries, offsets, counts, big_packed, big_ids, n_big, n_tx,
        width, height, out_col, out_depth);
  }
  return (int)cudaGetLastError();
}
