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
// The function. Each tile walks its chunk list in order (build_bins:
// near first by chunk z-min). Hi-Z: a chunk whose conservative z-min
// cannot beat the tile's worst current depth is skipped (exact under the
// strict <; the grain is the tile's, as in the twin). A merged chunk's
// triangles are taken in index order per pixel: the top-left rule,
// 0 <= z <= 1, the optional zlo < z < zhi and strict z < best, so the
// winner is the least z, the earliest in walk order on ties, with z's own
// bits. The winner's 64-float row then goes through resolve_math.cuh
// (K2's math; tri_id is the row's S_ORIG_ID, so compacted pools keep pool
// ids); a pixel nothing covers gets depth 1.0, tri_id -1 and zero planes.
// Not copied from the TPU kernel: the two-phase bf16x3 one-hot MXU
// resolve, the double-buffered DMA and the (8,128) swizzle.
//
// What bounds it on the H100. The overlay's pools are small and their
// triangles large: a covered tile lists 1-2 chunks, of which a few
// triangles reach any one part of it, and most of K7's 2,040 tiles list
// nothing the walk keeps. So the time is the planes' bytes (about 20 f32
// planes a pixel) and the latency of a tile's few dependent steps, and
// the design is about tests the tile does not need and tiles in flight:
//   - A per-warp cull. Warp w owns the 16 x BH block (w % 2, w / 2) of
//     the tile, PX pixels a thread along a row. One barrier stages a
//     chunk: thread k < 128 loads triangle k's edges, z plane and bbox,
//     computes the top-left thresholds and the warps whose block the
//     bbox, widened by one pixel, reaches (raster16.cu's rule: the bbox
//     holds every centre the rounded edge test can cover). Each warp
//     then walks the chunk a ballot of 32 triangles at a time, taking
//     the set bits in order, so it tests only its own triangles and in
//     index order.
//   - The flush out of the walk's live range. The walk leaves each
//     pixel's (z, column) in shared memory; after one barrier the CTA
//     flushes row by row (a warp's store is one 128-byte row of a plane),
//     one pixel a thread at a time, so resolve_math's registers are not
//     held beside the walk's.
//   - Empty tiles. A tile where no pixel took a fragment (no chunk
//     listed, every chunk skipped or culled) writes its constant planes
//     with 16-byte stores wherever the rows are 16-byte aligned (K8
//     always, K7 when width % 4 == 0), plain stores otherwise. The peel
//     bounds are read only when a chunk is merged.
//   - Tiles in flight. PX = 2 pixels a thread, 512 threads a CTA (16x4
//     warp blocks), 56 registers and no spills, 17 KB of shared memory:
//     two tiles an SM, so K8's 224 covered tiles on the 1080p stress
//     frame run in one wave (the first port: 1,024 threads, one tile an
//     SM, two waves) and K7's 2,040 in 8. On an NVIDIA H100 (700 W;
//     scripts/k7_k8_variants.py, PERF.md), device time a call: K8
//     0.0109 ms (the first port 0.0718), K7's band peel 0.0500 (0.1306,
//     its byte bound 0.0446), K7's HUD call 0.0343 (0.0460); 1 pixel a
//     thread took 0.0139-0.0149 / 0.0523-0.0529 / 0.0350-0.0402 at one or
//     two tiles an SM, 4 pixels 0.0122-0.0188 / 0.0501-0.0790 /
//     0.0346-0.0468 at two to six (spilling from four on).
// Exactness: explicit __fmul_rn/__fadd_rn and -fmad=false, so the planes
// are bit-equal to the plain twins in ops/raster.py, which walk every
// triangle of every merged chunk with no cull.

#include <cuda_runtime.h>
#include <stdint.h>

#include "resolve_math.cuh"

namespace {

using awsm::NSETUP;

constexpr int CHUNK = 128;
constexpr int BT = 32;
constexpr int NPX = BT * BT;
constexpr int PX = 2;  // pixels a thread in the walk, along a row
constexpr int THREADS = NPX / PX;
constexpr int NWARP = THREADS / 32;
constexpr int LX = 16 / PX;  // lanes along a row of a warp's 16-pixel block
constexpr int BH = 32 / LX;  // rows of a warp's block
constexpr int MIN_BLOCKS = 2;  // CTAs an SM the registers must allow
constexpr int S_BB_MINX = 15;  // then min y, max x, max y
constexpr float FMIN = 1.1754943508222875e-38f;

// a staged triangle: per edge (a, b, c, threshold), then the z plane
struct alignas(16) Tri {
  float4 e[3];
  float4 z;
};

__device__ __forceinline__ float4 edge(float a, float b, float c) {
  const bool tl = (a > 0.f) || (a == 0.f && b > 0.f);
  return make_float4(a, b, c, tl ? 0.f : FMIN);
}

// triangle k of `chunk` into stage[k], and into smask[k] the warps of
// tile (X, Y) whose block its bbox, widened by one pixel, reaches
__device__ __forceinline__ void stage_tri(const float* __restrict__ setup,
                                          int chunk, int k, float X, float Y,
                                          Tri* stage, unsigned* smask) {
  const float* r = setup + ((size_t)chunk * CHUNK + k) * NSETUP;
  const float4* r4 = reinterpret_cast<const float4*>(r);
  const float4 r0 = __ldg(r4), r1 = __ldg(r4 + 1), r2 = __ldg(r4 + 2);
  const float x0 = __ldg(r + S_BB_MINX) - 1.f;
  const float y0 = __ldg(r + S_BB_MINX + 1) - 1.f;
  const float x1 = __ldg(r + S_BB_MINX + 2) + 1.f;
  const float y1 = __ldg(r + S_BB_MINX + 3) + 1.f;
  Tri tri;
  // r0..r2 hold floats 0..11 of the row: the three edges' (a, b, c),
  // then the z plane (za, zb, zc)
  tri.e[0] = edge(r0.x, r0.y, r0.z);
  tri.e[1] = edge(r0.w, r1.x, r1.y);
  tri.e[2] = edge(r1.z, r1.w, r2.x);
  tri.z = make_float4(r2.y, r2.z, r2.w, 0.f);
  // pixel centres of warp w's block: X + 16 (w % 2) + [0.5, 15.5],
  // Y + BH (w / 2) + [0.5, BH - 0.5]
  unsigned mask = 0;
#pragma unroll
  for (int w = 0; w < NWARP; ++w) {
    const float bx = X + (float)(16 * (w & 1));
    const float by = Y + (float)(BH * (w >> 1));
    if (x0 <= bx + 15.5f && x1 >= bx + 0.5f &&
        y0 <= by + ((float)BH - 0.5f) && y1 >= by + 0.5f) {
      mask |= 1u << w;
    }
  }
  stage[k] = tri;
  smask[k] = mask;
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
binned_kernel(const float* __restrict__ setup, const int* __restrict__ bins,
              const int* __restrict__ counts, const float* __restrict__ zmin,
              int B, const int* __restrict__ tile_idx, int n_tx, int width,
              int height, const float* __restrict__ zlo,
              const float* __restrict__ zhi, int flags, int P_out,
              int* __restrict__ out_tid, float* __restrict__ out) {
  __shared__ Tri stage[CHUNK];
  __shared__ unsigned smask[CHUNK];
  __shared__ float s_z[NPX];
  __shared__ int s_col[NPX];
  const bool compact = tile_idx != nullptr;
  const bool peel = zlo != nullptr;
  const int t = compact ? tile_idx[blockIdx.x] : (int)blockIdx.x;
  const int tile_x = t % n_tx, tile_y = t / n_tx;
  const float X = (float)(tile_x * BT), Y = (float)(tile_y * BT);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int lx0 = 16 * (warp & 1) + PX * (lane % LX);
  const int ly = BH * (warp >> 1) + lane / LX;
  const float py = Y + (float)ly + 0.5f;
  float px[PX], bz[PX], lo[PX], hi[PX];
  int bc[PX];
#pragma unroll
  for (int i = 0; i < PX; ++i) {
    px[i] = X + (float)(lx0 + i) + 0.5f;
    bz[i] = 1.f;
    bc[i] = -1;
    // outside the image the reference pads the peel bounds with 0.0
    lo[i] = hi[i] = 0.f;
  }

  const int cnt = counts[t];
  bool bounds = !peel;  // the peel bounds, read at the first merged chunk
  for (int b = 0; b < cnt; ++b) {
    const int chunk = bins[(size_t)t * B + b];
    const float zm = zmin[chunk];
    bool open = false;
#pragma unroll
    for (int i = 0; i < PX; ++i) open = open || bz[i] > zm;
    // hi-Z: merge only if some pixel of the tile can still improve (this
    // is also the barrier that ends the previous chunk's merge)
    if (!__syncthreads_or(open)) continue;
    if (threadIdx.x < CHUNK) {
      stage_tri(setup, chunk, threadIdx.x, X, Y, stage, smask);
    }
    if (!bounds) {
      bounds = true;
#pragma unroll
      for (int i = 0; i < PX; ++i) {
        const int x = tile_x * BT + lx0 + i, y = tile_y * BT + ly;
        if (compact) {
          const size_t o = (size_t)blockIdx.x * NPX + ly * BT + lx0 + i;
          lo[i] = zlo[o];
          hi[i] = zhi[o];
        } else if (x < width && y < height) {
          lo[i] = zlo[(size_t)y * width + x];
          hi[i] = zhi[(size_t)y * width + x];
        }
      }
    }
    __syncthreads();
    const int col0 = chunk * CHUNK;
    for (int k0 = 0; k0 < CHUNK; k0 += 32) {
      unsigned mine =
          __ballot_sync(0xffffffffu, (smask[k0 + lane] >> warp) & 1u);
      while (mine) {
        const int k = k0 + __ffs(mine) - 1;
        mine &= mine - 1;
        const float4 e0 = stage[k].e[0], e1 = stage[k].e[1];
        const float4 e2 = stage[k].e[2], zq = stage[k].z;
        const float h0 = __fadd_rn(__fmul_rn(e0.y, py), e0.z);
        const float h1 = __fadd_rn(__fmul_rn(e1.y, py), e1.z);
        const float h2 = __fadd_rn(__fmul_rn(e2.y, py), e2.z);
        const float hz = __fadd_rn(__fmul_rn(zq.y, py), zq.z);
#pragma unroll
        for (int i = 0; i < PX; ++i) {
          const float v0 = __fadd_rn(__fmul_rn(e0.x, px[i]), h0);
          const float v1 = __fadd_rn(__fmul_rn(e1.x, px[i]), h1);
          const float v2 = __fadd_rn(__fmul_rn(e2.x, px[i]), h2);
          const float z = __fadd_rn(__fmul_rn(zq.x, px[i]), hz);
          // z < bz <= 1 implies the reference's z <= 1
          if (v0 >= e0.w && v1 >= e1.w && v2 >= e2.w && z >= 0.f &&
              z < bz[i] && (!peel || (z > lo[i] && z < hi[i]))) {
            bz[i] = z;
            bc[i] = col0 + k;
          }
        }
      }
    }
  }

  // the winners to shared memory, then the flush row by row
  bool hit = false;
#pragma unroll
  for (int i = 0; i < PX; ++i) {
    s_z[ly * BT + lx0 + i] = bz[i];
    s_col[ly * BT + lx0 + i] = bc[i];
    hit = hit || bc[i] >= 0;
  }
  int n_attr = 0;  // float planes after depth in this layout
#pragma unroll
  for (int k = 0; k < awsm::NRESOLVE; ++k) {
    n_attr += awsm::plane_slot(k, flags) >= 0;
  }
  if (!__syncthreads_or(hit)) {
    // no fragment in the tile: tri_id -1, depth 1.0, zero planes; plane p
    // of the stores is tri_id (0), depth (1) or attribute plane p - 2
    const int n_planes = 2 + n_attr;
    if (compact || (width & 3) == 0) {
      constexpr int QR = BT / 4;  // 16-byte groups a tile row
      for (int v = threadIdx.x; v < n_planes * NPX / 4; v += THREADS) {
        const int p = v / (NPX / 4), q = v % (NPX / 4);
        const int ry = q / QR, rx = 4 * (q % QR);
        size_t o;
        if (compact) {
          o = (size_t)blockIdx.x * NPX + ry * BT + rx;
        } else {
          const int x = tile_x * BT + rx, y = tile_y * BT + ry;
          if (x >= width || y >= height) continue;
          o = (size_t)y * width + x;
        }
        if (p == 0) {
          *reinterpret_cast<int4*>(out_tid + o) = make_int4(-1, -1, -1, -1);
        } else {
          const float f = p == 1 ? 1.f : 0.f;
          *reinterpret_cast<float4*>(out + (size_t)(p - 1) * P_out + o) =
              make_float4(f, f, f, f);
        }
      }
    } else {
      for (int v = threadIdx.x; v < n_planes * NPX; v += THREADS) {
        const int p = v / NPX, q = v % NPX;
        const int x = tile_x * BT + q % BT, y = tile_y * BT + q / BT;
        if (x >= width || y >= height) continue;
        const size_t o = (size_t)y * width + x;
        if (p == 0) {
          out_tid[o] = -1;
        } else {
          out[(size_t)(p - 1) * P_out + o] = p == 1 ? 1.f : 0.f;
        }
      }
    }
    return;
  }
#pragma unroll 1
  for (int q = threadIdx.x; q < NPX; q += THREADS) {
    const int rx = q % BT, ry = q / BT;
    const int x = tile_x * BT + rx, y = tile_y * BT + ry;
    if (!compact && (x >= width || y >= height)) continue;
    const size_t o =
        compact ? (size_t)blockIdx.x * NPX + q : (size_t)y * width + x;
    // output planes: depth, then RESOLVE_NAMES[1:] without the untaken
    // uv1 / colour / derivative groups (ops/raster.py plane_layout)
    auto emit = [&](int k, float v) {
      const int slot = awsm::plane_slot(k, flags);
      if (slot >= 0) out[(size_t)(1 + slot) * P_out + o] = v;
    };
    const int col = s_col[q];
    out[o] = s_z[q];
    if (col < 0) {
      out_tid[o] = -1;
#pragma unroll
      for (int k = 0; k < awsm::NRESOLVE; ++k) emit(k, 0.f);
      continue;
    }
    const float* row = setup + (size_t)col * NSETUP;
    out_tid[o] = (int)row[awsm::S_ORIG_ID];
    awsm::resolve_math(row, X + (float)rx + 0.5f, Y + (float)ry + 0.5f,
                       emit);
  }
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
    binned_kernel<<<n_blocks, THREADS, 0, stream>>>(
        setup, bins, counts, zmin, B, tile_idx, n_tx, width, height, zlo,
        zhi, flags, P_out, out_tid, out_planes);
  }
  return (int)cudaGetLastError();
}

// The compiled kernel, for measurement (chip_smoke.py): out[0..4] =
// registers a thread, local (spill) bytes a thread, CTAs resident an SM,
// threads a CTA, rows of a warp's cull block. `out` is host memory.
extern "C" int awsm_binned_info(int* out, cudaStream_t stream) {
  (void)stream;
  cudaFuncAttributes a = {};
  cudaError_t e = cudaFuncGetAttributes(&a, binned_kernel);
  int per_sm = 0;
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, binned_kernel,
                                                      THREADS, 0);
  }
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = per_sm;
  out[3] = THREADS;
  out[4] = BH;
  return (int)e;
}
