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
// phase oracle): its walk shares no code with binned.cu, raster16.cu,
// raster_msaa.cu or tile_walk.cuh, so a fault in their bin order, gates,
// culls or hi-Z cannot pass through it. Only the fat flush is shared
// (resolve_math.cuh, K2's math). It skips only where the reference does:
// a chunk, or an 8-triangle subgroup, whose bbox misses the tile.
//
// Two launches. chunk_bbox_kernel reduces each chunk's 128 triangle bboxes
// (the reference's _chunk_bboxes) and each of its sixteen 8-triangle
// subgroups' bboxes (_merge_subgroup's tile_xy test), once per call. Then
// dense_kernel runs one CTA of THREADS threads per ROWS rows of an 8x128
// tile, PX neighbouring pixels of one row a thread; its skips are the
// tile's, whatever rows it owns. The CTA scans the chunk bboxes
// one window of SCAN chunks at a time, one chunk a thread; a thread whose
// chunk overlaps the tile tests that chunk's sixteen subgroup bboxes, and
// a prefix sum over the threads (warp shuffles, then the warps' totals)
// lists the window's overlapping subgroups in index order in shared
// memory. The listed subgroups' edge and z planes (12 floats a triangle,
// with each edge's top-left threshold and the triangle's index) are
// staged STAGE triangles at a time and merged by every thread in list
// order. Slim output: tri_id (the winner's S_ORIG_ID, -1 on a miss) and
// depth (1.0 on a miss), 16-byte stores from the walk's registers; fat:
// the same, then the winner's 64-float row resolved at the pixel centre,
// one pixel a thread from shared memory (a warp writes 32 neighbouring
// pixels); a thread whose pixels all miss writes their zero planes with
// 16-byte stores.
//
// Exactness: explicit __fmul_rn/__fadd_rn and -fmad=false, so every edge
// and z value rounds like the plain twins in ops/raster.py; denormals are
// kept (no fast math), as the _FMIN threshold needs. b*py + c is the same
// value for a thread's PX pixels of one row, so it is computed once.
//
// What bounds it on the H100: by the bound, the fat planes' bytes (22
// planes of the frame written once) for K11a fat and K11b, the coverage
// tests (16 operations each over the overlapping (tile, subgroup) pairs)
// for slim at 3840x2160. In practice the merge's instruction issue: with
// -fmad=false a test is 3 x (mul, add, compare) for the edges, mul and
// add for z, two compares and two selects, ~20 issue slots a test-pixel
// with the staged loads. The design keeps the issue on the merge: a tile's
// scan is n_chunks / SCAN parallel steps (each thread walked every chunk
// bbox in series before, half the old kernel's time), the subgroup bboxes
// come from the pre-pass, and only overlapping subgroups are staged.
// PX = 4 with two 256-thread CTAs an SM (121 registers, no spill) was the
// fastest shape on the fat and peel calls (scripts/k11_variants.py);
// splitting a tile's rows over two CTAs (ROWS = 4) gained 3% fat and lost
// 10% slim.

#include <cuda_runtime.h>
#include <stdint.h>

#include "resolve_math.cuh"

namespace {

using awsm::NSETUP;

constexpr int TILE_W = 128, TILE_H = 8;
constexpr int CHUNK = 128, SUB = 8, NSUB = CHUNK / SUB;
constexpr int S_BB_MINX = 15, S_BB_MINY = 16, S_BB_MAXX = 17, S_BB_MAXY = 18;
constexpr float FMIN = 1.1754943508222875e-38f;
constexpr int SLIM = 8;  // flags bit beside awsm::HAS_UV1/HAS_COLOR/HAS_DERIVS
constexpr int PX = 4;          // pixels a thread, neighbours along a row
constexpr int ROWS = 8;        // rows of a tile a CTA owns
constexpr int MIN_BLOCKS = 2;  // CTAs an SM the registers must allow
constexpr int THREADS = ROWS * TILE_W / PX;
constexpr int NWARPS = THREADS / 32;
constexpr int SCAN = THREADS;  // chunks a window, one a thread
constexpr int STAGE = 256;  // triangles staged at once (32 subgroups)

static_assert(PX == 2 || PX % 4 == 0, "PX: 2 or 4k");
static_assert(TILE_H % ROWS == 0 && THREADS % 32 == 0, "ROWS, PX");
static_assert(THREADS <= 512, "a window's list: 16 KB of shared memory");

// one 128-thread block per chunk: (min x, min y, max x, max y) of the
// chunk into bbox[chunk] and of its subgroups into sub[chunk * NSUB + g];
// min and max are exact, so the reduction's order does not matter
__global__ void __launch_bounds__(CHUNK)
chunk_bbox_kernel(const float* __restrict__ setup, float4* __restrict__ bbox,
                  float4* __restrict__ sub) {
  const float* r = setup + ((size_t)blockIdx.x * CHUNK + threadIdx.x) * NSETUP;
  float mnx = r[S_BB_MINX], mny = r[S_BB_MINY];
  float mxx = r[S_BB_MAXX], mxy = r[S_BB_MAXY];
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    mnx = fminf(mnx, __shfl_xor_sync(0xffffffffu, mnx, d));
    mny = fminf(mny, __shfl_xor_sync(0xffffffffu, mny, d));
    mxx = fmaxf(mxx, __shfl_xor_sync(0xffffffffu, mxx, d));
    mxy = fmaxf(mxy, __shfl_xor_sync(0xffffffffu, mxy, d));
    if (d == SUB / 2 && threadIdx.x % SUB == 0) {
      sub[(size_t)blockIdx.x * NSUB + threadIdx.x / SUB] =
          make_float4(mnx, mny, mxx, mxy);
    }
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

// the top-left rule: a left edge (a > 0) or a top edge (a == 0, b > 0)
// owns its exact zeros
__device__ __forceinline__ float edge_threshold(float a, float b) {
  return (a > 0.f || (a == 0.f && b > 0.f)) ? 0.f : FMIN;
}

__device__ __forceinline__ int bits(int v) { return v; }
__device__ __forceinline__ int bits(float v) { return __float_as_int(v); }

// PX neighbouring values to p, 16-byte aligned (8-byte for PX = 2)
template <typename T>
__device__ __forceinline__ void store_px(T* p, const T (&v)[PX]) {
  if constexpr (PX % 4 == 0) {
#pragma unroll
    for (int j = 0; j < PX; j += 4) {
      reinterpret_cast<int4*>(p)[j / 4] = make_int4(
          bits(v[j]), bits(v[j + 1]), bits(v[j + 2]), bits(v[j + 3]));
    }
  } else {
    *reinterpret_cast<int2*>(p) = make_int2(bits(v[0]), bits(v[1]));
  }
}

template <bool PEEL>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
dense_kernel(const float* __restrict__ setup, const float4* __restrict__ bbox,
             const float4* __restrict__ sub_bbox, int n_chunks, int width,
             const float* __restrict__ zlo, const float* __restrict__ zhi,
             int flags, int P, int* __restrict__ out_tid,
             float* __restrict__ out) {
  // the staged triangles: (a, b, c, threshold) of each edge, then (za, zb,
  // zc, index bits); the flush reuses it for the winners
  __shared__ float4 s_tri[STAGE * 4];
  __shared__ uint16_t s_list[SCAN * NSUB];  // (chunk - base) * NSUB + g
  __shared__ int s_warp[2][NWARPS];         // warp totals, by window parity
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int rx = t % (TILE_W / PX) * PX, ry = t / (TILE_W / PX);
  // the tile's skips, this CTA's ROWS rows of it from Y
  const int X = blockIdx.x * TILE_W, Y = blockIdx.y * ROWS;
  const float tx0 = (float)X, ty0 = (float)(Y / TILE_H * TILE_H);
  const float py = (float)(Y + ry) + 0.5f;
  const size_t o0 = (size_t)(Y + ry) * width + X + rx;

  float lo[PX], hi[PX], best_z[PX];
  int best[PX];  // winner's setup row
#pragma unroll
  for (int j = 0; j < PX; ++j) {
    best_z[j] = 1.f;  // the depth clear; LESS
    best[j] = -1;
    if (PEEL) {
      lo[j] = zlo[o0 + j];
      hi[j] = zhi[o0 + j];
    }
  }

  float4 nb = t < n_chunks ? bbox[t] : float4{};
  for (int base = 0, par = 0; base < n_chunks; base += SCAN, par ^= 1) {
    // ---- scan: this window's overlapping subgroups, in index order ----
    const int c = base + t;
    const bool hit = c < n_chunks && overlaps(nb, tx0, ty0);
    if (c + SCAN < n_chunks) nb = bbox[c + SCAN];
    unsigned m = 0;
    if (hit) {
      const float4* sb = sub_bbox + (size_t)c * NSUB;
#pragma unroll
      for (int g = 0; g < NSUB; ++g) {
        m |= (unsigned)overlaps(sb[g], tx0, ty0) << g;
      }
    }
    const int n = __popc(m);
    int incl = n;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += v;
    }
    if (lane == 31) s_warp[par][warp] = incl;
    __syncthreads();
    int off = incl - n, total = 0;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      const int v = s_warp[par][w];
      total += v;
      off += w < warp ? v : 0;
    }
    if (total == 0) continue;  // the same for every thread
    for (; m; m &= m - 1) {
      s_list[off++] = (uint16_t)(t * NSUB + __ffs(m) - 1);
    }
    __syncthreads();

    // ---- merge: the listed subgroups, STAGE triangles at a time ----
    for (int b0 = 0; b0 < total * SUB; b0 += STAGE) {
      const int nt = min(STAGE, total * SUB - b0);
      for (int i = t; i < nt; i += THREADS) {
        const int s = s_list[(b0 + i) / SUB];
        const int k = (base + s / NSUB) * CHUNK + s % NSUB * SUB + i % SUB;
        const float4* r = reinterpret_cast<const float4*>(
            setup + (size_t)k * NSETUP);
        const float4 q0 = r[0], q1 = r[1], q2 = r[2];  // setup rows 0..11
        s_tri[4 * i] = make_float4(q0.x, q0.y, q0.z,
                                   edge_threshold(q0.x, q0.y));
        s_tri[4 * i + 1] = make_float4(q0.w, q1.x, q1.y,
                                       edge_threshold(q0.w, q1.x));
        s_tri[4 * i + 2] = make_float4(q1.z, q1.w, q2.x,
                                       edge_threshold(q1.z, q1.w));
        s_tri[4 * i + 3] = make_float4(q2.y, q2.z, q2.w, __int_as_float(k));
      }
      __syncthreads();
      for (int i = 0; i < nt; ++i) {
        const float4 e0 = s_tri[4 * i], e1 = s_tri[4 * i + 1];
        const float4 e2 = s_tri[4 * i + 2], zq = s_tri[4 * i + 3];
        const float r0 = __fadd_rn(__fmul_rn(e0.y, py), e0.z);
        const float r1 = __fadd_rn(__fmul_rn(e1.y, py), e1.z);
        const float r2 = __fadd_rn(__fmul_rn(e2.y, py), e2.z);
        const float rz = __fadd_rn(__fmul_rn(zq.y, py), zq.z);
#pragma unroll
        for (int j = 0; j < PX; ++j) {
          const float px = (float)(X + rx + j) + 0.5f;
          const bool in = __fadd_rn(__fmul_rn(e0.x, px), r0) >= e0.w &&
                          __fadd_rn(__fmul_rn(e1.x, px), r1) >= e1.w &&
                          __fadd_rn(__fmul_rn(e2.x, px), r2) >= e2.w;
          const float z = __fadd_rn(__fmul_rn(zq.x, px), rz);
          // z < best_z <= 1 also holds z <= 1
          if (in && z >= 0.f && z < best_z[j] &&
              (!PEEL || (z > lo[j] && z < hi[j]))) {
            best_z[j] = z;
            best[j] = __float_as_int(zq.w);
          }
        }
      }
      __syncthreads();  // the merge has read s_tri and s_list
    }
  }

  // ---- flush ----
  int ids[PX];
  bool all_miss = true;
#pragma unroll
  for (int j = 0; j < PX; ++j) {
    ids[j] = best[j] >= 0 ? (int)setup[(size_t)best[j] * NSETUP +
                                       awsm::S_ORIG_ID]
                          : -1;
    all_miss = all_miss && best[j] < 0;
  }
  store_px(out_tid + o0, ids);
  store_px(out + o0, best_z);
  if (flags & SLIM) return;
  if (all_miss) {
    const float zero[PX] = {};
#pragma unroll
    for (int k = 0; k < awsm::NRESOLVE; ++k) {
      const int slot = awsm::plane_slot(k, flags);
      if (slot >= 0) store_px(out + (size_t)(1 + slot) * P + o0, zero);
    }
  }
  // the winners, one pixel a thread along the rows (-2: written above);
  // the last merge's __syncthreads freed s_tri
  int* s_col = reinterpret_cast<int*>(s_tri);
#pragma unroll
  for (int j = 0; j < PX; ++j) {
    s_col[ry * TILE_W + rx + j] = all_miss ? -2 : best[j];
  }
  __syncthreads();
  for (int q = t; q < ROWS * TILE_W; q += THREADS) {
    const int col = s_col[q];
    if (col == -2) continue;
    const int x = X + q % TILE_W, y = Y + q / TILE_W;
    const size_t o = (size_t)y * width + x;
    auto emit = [&](int k, float v) {
      const int slot = awsm::plane_slot(k, flags);
      if (slot >= 0) out[(size_t)(1 + slot) * P + o] = v;
    };
    if (col < 0) {
#pragma unroll
      for (int k = 0; k < awsm::NRESOLVE; ++k) emit(k, 0.f);
    } else {
      awsm::resolve_math(setup + (size_t)col * NSETUP, (float)x + 0.5f,
                         (float)y + 0.5f, emit);
    }
  }
}

}  // namespace

// width a multiple of 128, height of 8, setup (n_chunks * 128, 64) f32,
// 16-byte aligned; bbox is (n_chunks * (1 + 16), 4) f32 scratch (the
// chunks' bboxes, then their subgroups'); zlo/zhi null without a peel,
// else 4-byte aligned planes of width * height.
extern "C" int awsm_dense(const float* setup, int n_chunks, float* bbox,
                          int width, int height, const float* zlo,
                          const float* zhi, int flags, int* out_tid,
                          float* out_planes, cudaStream_t stream) {
  if (width <= 0 || height <= 0) return (int)cudaGetLastError();
  float4* cb = reinterpret_cast<float4*>(bbox);
  float4* sb = cb + n_chunks;
  if (n_chunks > 0) chunk_bbox_kernel<<<n_chunks, CHUNK, 0, stream>>>(
      setup, cb, sb);
  const dim3 grid(width / TILE_W, height / ROWS);
  if (zlo != nullptr) {
    dense_kernel<true><<<grid, THREADS, 0, stream>>>(
        setup, cb, sb, n_chunks, width, zlo, zhi, flags, width * height,
        out_tid, out_planes);
  } else {
    dense_kernel<false><<<grid, THREADS, 0, stream>>>(
        setup, cb, sb, n_chunks, width, nullptr, nullptr, flags,
        width * height, out_tid, out_planes);
  }
  return (int)cudaGetLastError();
}

// The compiled kernel, for measurement (chip_smoke.py): out[0..4] =
// registers a thread, local (spill) bytes a thread, CTAs resident an SM,
// threads a CTA, pixels a thread; of the peel's kernel where peel != 0.
// `out` is host memory.
extern "C" int awsm_dense_info(int* out, int peel, cudaStream_t stream) {
  (void)stream;
  const void* fn = peel ? (const void*)dense_kernel<true>
                        : (const void*)dense_kernel<false>;
  cudaFuncAttributes a = {};
  cudaError_t e = cudaFuncGetAttributes(&a, fn);
  int per_sm = 0;
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, THREADS,
                                                      0);
  }
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = per_sm;
  out[3] = THREADS;
  out[4] = PX;
  return (int)e;
}
