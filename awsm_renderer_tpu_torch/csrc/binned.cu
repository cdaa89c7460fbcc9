// K7 and K8: the binned fat raster of the overlay passes.
//
// K7 replaces awsm_renderer_tpu/ops/raster.py::rasterize_binned
// (pallas_call at raster.py:705, body _make_binned_kernel at :455): per
// 32x32 tile, the nearest fragment of the tile's binned 128-triangle
// chunks, optionally a depth peel (zlo < z < zhi), with the winner's
// attributes interpolated once per pixel. K8 replaces
// raster.py::_rasterize_binned_compact (pallas_call at :1001, the same
// kernel with compact=True): the peel over covered tiles only, block i
// being logical tile tile_idx[i], inputs and outputs in (C, 1024) compact
// blocks. One kernel serves both: tile_idx null means K7 (the logical tile
// is the block index, planes (height, width)), zlo/zhi null means no peel.
//
// One CTA per tile, one thread per pixel holding (z, winner column). The
// CTA walks its chunk list in order (build_bins: near-first by chunk
// z-min). Hi-Z: a chunk whose conservative z-min cannot beat the tile's
// worst current depth is skipped (__syncthreads_or; exact under the strict
// <). A chunk's edge and z planes (128 x 12 floats) are staged in shared
// memory; each pixel merges the 128 triangles in index order with the
// top-left rule, 0 <= z <= 1, the optional zlo < z < zhi and strict
// z < best — a sequential walk equal to the reference's 8-triangle
// subgroup merge (nearest z, lowest index on ties). The flush reads the
// winner's 64-float row from device memory and evaluates resolve_math.cuh
// (K2's math; tri_id is the row's S_ORIG_ID, so compacted pools keep pool
// ids). Not copied from the TPU kernel: the two-phase bf16x3 one-hot MXU
// resolve, the double-buffered DMA and the (8,128) swizzle.
//
// Exactness: explicit __fmul_rn/__fadd_rn and -fmad=false, so the planes
// are bit-equal to the plain twins in ops/raster.py.
//
// What bounds it on the H100: the merge ALU (about 24 operations per
// triangle-pixel test, 128 x 1024 tests per merged chunk) and the
// setup bytes a tile reads — 6 KB of staged planes per merged chunk plus
// one 256-byte winner row per covered pixel. Overlay pools are small, so
// the tile count (2040 at 1080p for K7, the covered tiles for K8) and the
// per-chunk __syncthreads pair set the time. Simple and right first:
// skipping empty per-warp chunk bboxes and overlapping the next chunk's
// staging with the merge are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "resolve_math.cuh"

namespace {

using awsm::NSETUP;

constexpr int CHUNK = 128;
constexpr int BT = 32;
constexpr int NPX = BT * BT;
constexpr int NPLANE = 12;  // edge triples (0..8) + z-plane (9..11)
constexpr float FMIN = 1.1754943508222875e-38f;

__device__ __forceinline__ float plane(float a, float b, float c, float px,
                                       float py) {
  return __fadd_rn(__fmul_rn(a, px), __fadd_rn(__fmul_rn(b, py), c));
}

__global__ void __launch_bounds__(NPX)
binned_kernel(const float* __restrict__ setup, const int* __restrict__ bins,
              const int* __restrict__ counts, const float* __restrict__ zmin,
              int B, const int* __restrict__ tile_idx, int n_tx, int width,
              int height, const float* __restrict__ zlo,
              const float* __restrict__ zhi, int flags, int P_out,
              int* __restrict__ out_tid, float* __restrict__ out) {
  __shared__ float s[CHUNK * NPLANE];
  const bool compact = tile_idx != nullptr;
  const bool peel = zlo != nullptr;
  const int t = compact ? tile_idx[blockIdx.x] : (int)blockIdx.x;
  const int tile_x = t % n_tx, tile_y = t / n_tx;
  const int lx = threadIdx.x % BT, ly = threadIdx.x / BT;
  const float px = (float)(tile_x * BT) + (float)lx + 0.5f;
  const float py = (float)(tile_y * BT) + (float)ly + 0.5f;
  const int x = tile_x * BT + lx, y = tile_y * BT + ly;
  const bool owned = compact || (x < width && y < height);
  const size_t o = compact ? (size_t)blockIdx.x * NPX + threadIdx.x
                           : (size_t)y * width + x;
  // outside the image the reference pads the peel bounds with 0.0
  float lo = 0.f, hi = 0.f;
  if (peel && owned) {
    lo = zlo[o];
    hi = zhi[o];
  }

  float best_z = 1.f;
  int best_col = -1;
  const int cnt = counts[t];
  for (int b = 0; b < cnt; ++b) {
    const int chunk = bins[(size_t)t * B + b];
    // hi-Z: merge only if some pixel's depth can still improve (this is
    // also the barrier that ends the previous chunk's merge)
    if (!__syncthreads_or(best_z > zmin[chunk])) continue;
    for (int i = threadIdx.x; i < CHUNK * NPLANE; i += NPX) {
      const int k = i / NPLANE, j = i % NPLANE;
      s[i] = setup[((size_t)chunk * CHUNK + k) * NSETUP + j];
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < CHUNK; ++k) {
      const float* r = s + k * NPLANE;
      bool cover = true;
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        const float a = r[3 * e], bb = r[3 * e + 1], c = r[3 * e + 2];
        const float v = plane(a, bb, c, px, py);
        const bool tl = (a > 0.f) || (a == 0.f && bb > 0.f);
        cover = cover && (v >= (tl ? 0.f : FMIN));
      }
      const float z = plane(r[9], r[10], r[11], px, py);
      if (cover && z >= 0.f && z <= 1.f && z < best_z &&
          (!peel || (z > lo && z < hi))) {
        best_z = z;
        best_col = chunk * CHUNK + k;
      }
    }
  }
  if (!owned) return;

  // output planes: depth, then RESOLVE_NAMES[1:] without the untaken
  // uv1 / colour / derivative groups (ops/raster.py plane_layout)
  auto emit = [&](int k, float v) {
    const int slot = awsm::plane_slot(k, flags);
    if (slot >= 0) out[(size_t)(1 + slot) * P_out + o] = v;
  };
  out[o] = best_z;
  if (best_col < 0) {
    out_tid[o] = -1;
#pragma unroll
    for (int k = 0; k < awsm::NRESOLVE; ++k) emit(k, 0.f);
    return;
  }
  const float* row = setup + (size_t)best_col * NSETUP;
  out_tid[o] = (int)row[awsm::S_ORIG_ID];
  awsm::resolve_math(row, px, py, emit);
}

}  // namespace

extern "C" int awsm_binned(const float* setup, const int* bins,
                           const int* counts, const float* zmin, int B,
                           const int* tile_idx, int n_blocks, int n_tx,
                           int width, int height, const float* zlo,
                           const float* zhi, int flags, int P_out,
                           int* out_tid, float* out_planes,
                           cudaStream_t stream) {
  if (n_blocks > 0) {
    binned_kernel<<<n_blocks, NPX, 0, stream>>>(
        setup, bins, counts, zmin, B, tile_idx, n_tx, width, height, zlo,
        zhi, flags, P_out, out_tid, out_planes);
  }
  return (int)cudaGetLastError();
}
