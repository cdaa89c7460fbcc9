// K11a and K11b: the dense raster and the dense peel.
//
// K11a replaces awsm_renderer_tpu/ops/raster.py::_rasterize_dense
// (pallas_call at raster.py:807) and K11b raster.py::_rasterize_peel_dense
// (pallas_call at :872); both run the body _make_kernel (:309) with
// _merge_subgroup (:140), _init_fields (:243) and _flush_planes (:250).
// Per 8x128 tile, the nearest fragment over EVERY 128-triangle chunk whose
// conservative bbox overlaps the tile (no bins, no near-first order, no
// hi-Z): the top-left fill rule, 0 <= z <= 1, zlo < z < zhi for the peel,
// nearest z wins and the lowest triangle index wins a tie. The reference
// merges 8-triangle subgroups (min z, lowest index, then strict < across
// subgroups and chunks); that is a sequential strict-< walk of the
// triangles in index order, which is what each thread here does.
//
// In the port this is the on-card oracle for K1, K7, K8 and K9 (chip_smoke
// phase oracle): its walk shares no code with binned.cu, raster16.cu or
// raster_msaa.cu, so a fault in their bin order, gates or hi-Z cannot pass
// through it. Only the fat flush is shared (resolve_math.cuh, K2's math).
//
// Two launches: chunk_bbox_kernel reduces each chunk's 128 triangle
// bboxes (the reference's _chunk_bboxes), then dense_kernel runs one CTA
// per 8x128 tile, one thread per pixel. The CTA walks the chunks in index
// order, skips one whose bbox misses the tile (a uniform branch), stages
// the chunk's edge and z planes (128 x 12 floats) and its sixteen
// 8-triangle subgroup bboxes in shared memory, and merges the triangles of
// each subgroup whose bbox overlaps the tile (the reference's tile_xy
// skip in _merge_subgroup, again uniform). Slim output: tri_id (the winner's S_ORIG_ID,
// -1 on a miss) and depth (1.0 on a miss); fat: the winner's 64-float row
// resolved at the pixel centre (tri_id from the row, -1 and zero planes on
// a miss).
//
// Exactness: explicit __fmul_rn/__fadd_rn and -fmad=false, so every edge
// and z value rounds like the plain twins in ops/raster.py; denormals are
// kept (no fast math), as the _FMIN threshold needs.
//
// What bounds it on the H100: the merge ALU, 16 operations per
// triangle-pixel coverage test over the overlapping (tile, subgroup)
// pairs, 8 x 1024 tests each; the setup bytes are read once per
// overlapping (tile, chunk) pair (6 KB staged) and are small next to that. Simple and right first:
// the serial bbox scan (n_chunks uniform tests per tile) and the
// per-chunk __syncthreads pair are left as they are.

#include <cuda_runtime.h>
#include <stdint.h>

#include "resolve_math.cuh"

namespace {

using awsm::NSETUP;

constexpr int TILE_W = 128, TILE_H = 8, NPX = TILE_W * TILE_H;
constexpr int CHUNK = 128, SUB = 8, NSUB = CHUNK / SUB;
constexpr int NPL = 12;  // the three edge triples and the z plane, rows 0..11
constexpr int S_BB_MINX = 15, S_BB_MINY = 16, S_BB_MAXX = 17, S_BB_MAXY = 18;
constexpr float FMIN = 1.1754943508222875e-38f;
constexpr int SLIM = 8;  // flags bit beside awsm::HAS_UV1/HAS_COLOR/HAS_DERIVS

// one 128-thread block per chunk: (min x, min y, max x, max y)
__global__ void __launch_bounds__(CHUNK)
chunk_bbox_kernel(const float* __restrict__ setup, float4* __restrict__ bbox) {
  const float* r = setup + ((size_t)blockIdx.x * CHUNK + threadIdx.x) * NSETUP;
  float mnx = r[S_BB_MINX], mny = r[S_BB_MINY];
  float mxx = r[S_BB_MAXX], mxy = r[S_BB_MAXY];
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    mnx = fminf(mnx, __shfl_xor_sync(0xffffffffu, mnx, d));
    mny = fminf(mny, __shfl_xor_sync(0xffffffffu, mny, d));
    mxx = fmaxf(mxx, __shfl_xor_sync(0xffffffffu, mxx, d));
    mxy = fmaxf(mxy, __shfl_xor_sync(0xffffffffu, mxy, d));
  }
  __shared__ float4 w[CHUNK / 32];
  if (threadIdx.x % 32 == 0) {
    w[threadIdx.x / 32] = make_float4(mnx, mny, mxx, mxy);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float4 b = w[0];
    for (int i = 1; i < CHUNK / 32; ++i) {
      b.x = fminf(b.x, w[i].x);
      b.y = fminf(b.y, w[i].y);
      b.z = fmaxf(b.z, w[i].z);
      b.w = fmaxf(b.w, w[i].w);
    }
    bbox[blockIdx.x] = b;
  }
}

__device__ __forceinline__ bool overlaps(float4 b, float tx0, float ty0) {
  return b.x < tx0 + TILE_W && b.z > tx0 && b.y < ty0 + TILE_H && b.w > ty0;
}

// a*px + (b*py + c), each step rounded
__device__ __forceinline__ float affine(float a, float b, float c, float px,
                                        float py) {
  return __fadd_rn(__fmul_rn(a, px), __fadd_rn(__fmul_rn(b, py), c));
}

__global__ void __launch_bounds__(NPX)
dense_kernel(const float* __restrict__ setup, const float4* __restrict__ bbox,
             int n_chunks, int width, const float* __restrict__ zlo,
             const float* __restrict__ zhi, int flags, int P,
             int* __restrict__ out_tid, float* __restrict__ out) {
  __shared__ float s[CHUNK * NPL];
  __shared__ float4 sg[NSUB];  // the chunk's subgroup bboxes
  const int x = blockIdx.x * TILE_W + threadIdx.x % TILE_W;
  const int y = blockIdx.y * TILE_H + threadIdx.x / TILE_W;
  const float tx0 = (float)(blockIdx.x * TILE_W);
  const float ty0 = (float)(blockIdx.y * TILE_H);
  const float px = (float)x + 0.5f, py = (float)y + 0.5f;
  const size_t o = (size_t)y * width + x;
  const bool peel = zlo != nullptr;
  const float lo = peel ? zlo[o] : 0.f, hi = peel ? zhi[o] : 0.f;

  float best_z = 1.f;  // the depth clear; LESS
  int best = -1;       // winner's setup row
  for (int c = 0; c < n_chunks; ++c) {
    if (!overlaps(bbox[c], tx0, ty0)) continue;  // the same for every thread
    __syncthreads();  // the previous chunk's merge has read shared memory
    for (int i = threadIdx.x; i < CHUNK * NPL; i += NPX) {
      s[i] = setup[((size_t)c * CHUNK + i / NPL) * NSETUP + i % NPL];
    }
    if (threadIdx.x < NSUB) {
      const float* r = setup + ((size_t)c * CHUNK + threadIdx.x * SUB) * NSETUP;
      float4 q = make_float4(r[S_BB_MINX], r[S_BB_MINY], r[S_BB_MAXX],
                             r[S_BB_MAXY]);
      for (int k = 1; k < SUB; ++k) {
        r += NSETUP;
        q.x = fminf(q.x, r[S_BB_MINX]);
        q.y = fminf(q.y, r[S_BB_MINY]);
        q.z = fmaxf(q.z, r[S_BB_MAXX]);
        q.w = fmaxf(q.w, r[S_BB_MAXY]);
      }
      sg[threadIdx.x] = q;
    }
    __syncthreads();
    for (int g = 0; g < NSUB; ++g) {
      if (!overlaps(sg[g], tx0, ty0)) continue;  // uniform, as above
      for (int k = g * SUB; k < (g + 1) * SUB; ++k) {
        const float* t = s + k * NPL;
        bool in = true;
#pragma unroll
        for (int e = 0; e < 3; ++e) {
          const float a = t[3 * e], bb = t[3 * e + 1];
          const float v = affine(a, bb, t[3 * e + 2], px, py);
          // top-left rule: a left edge (a > 0) or a top edge (a == 0,
          // b > 0) owns its exact zeros
          in = in && v >= ((a > 0.f || (a == 0.f && bb > 0.f)) ? 0.f : FMIN);
        }
        const float z = affine(t[9], t[10], t[11], px, py);
        if (in && z >= 0.f && z <= 1.f && (!peel || (z > lo && z < hi)) &&
            z < best_z) {
          best_z = z;
          best = c * CHUNK + k;
        }
      }
    }
  }

  const float* row = best >= 0 ? setup + (size_t)best * NSETUP : nullptr;
  out_tid[o] = row ? (int)row[awsm::S_ORIG_ID] : -1;
  out[o] = best_z;
  if (flags & SLIM) return;
  auto emit = [&](int k, float v) {
    const int slot = awsm::plane_slot(k, flags);
    if (slot >= 0) out[(size_t)(1 + slot) * P + o] = v;
  };
  if (row == nullptr) {
#pragma unroll
    for (int k = 0; k < awsm::NRESOLVE; ++k) emit(k, 0.f);
    return;
  }
  awsm::resolve_math(row, px, py, emit);
}

}  // namespace

// width a multiple of 128, height of 8, setup (n_chunks * 128, 64) f32;
// bbox is (n_chunks, 4) f32 scratch; zlo/zhi null without a peel.
extern "C" int awsm_dense(const float* setup, int n_chunks, float* bbox,
                          int width, int height, const float* zlo,
                          const float* zhi, int flags, int* out_tid,
                          float* out_planes, cudaStream_t stream) {
  if (width <= 0 || height <= 0) return (int)cudaGetLastError();
  if (n_chunks > 0) {
    chunk_bbox_kernel<<<n_chunks, CHUNK, 0, stream>>>(
        setup, reinterpret_cast<float4*>(bbox));
  }
  const dim3 grid(width / TILE_W, height / TILE_H);
  dense_kernel<<<grid, NPX, 0, stream>>>(
      setup, reinterpret_cast<const float4*>(bbox), n_chunks, width, zlo, zhi,
      flags, width * height, out_tid, out_planes);
  return (int)cudaGetLastError();
}
