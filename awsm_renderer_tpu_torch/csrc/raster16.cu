// K1: binned coverage raster over row-major triangle setup (winner column
// + depth per pixel).
//
// Replaces the TPU kernel awsm_renderer_tpu/ops/raster.py::rasterize16_slim
// (pallas_call at raster.py:1615, body _make_v5_kernel at raster.py:1402).
//
// The function. Each 32x32 tile walks its bin (offsets[t], counts[t]: the
// binned 16-triangle groups in the binner's near-first order), then the
// big groups whose tile box holds it, in big-list order. Per pixel:
//   - edge test e = a*px + (b*py + c) >= (top-left ? 0 : FLT_MIN_NORMAL),
//   - 0 <= z <= 1,
//   - strict z < best: the triangle met first wins a depth tie, which is
//     the TPU kernel's rule (nearest z, lowest index inside a subgroup;
//     strict < across subgroups and groups).
// So the winner is the least z in [0, 1) (+0.0 and -0.0 equal), the
// earliest walk position on equal z, with z's own bits; -1 and 1.0 where
// nothing covers. The plain twin in ops/raster.py walks the same order.
//
// What bounds it on the H100. The work is the coverage tests, 16 float
// operations each: e = a*px + (b*py + c) for three edges and the z plane.
// The bins vary a lot from tile to tile: on the 1080p stress frame most of
// the 2,040 tiles hold a handful of groups and a few hold well over 127.
// One CTA per tile walking its groups in turn (the first port of this
// kernel) took the time of its heaviest tile on one SM while the others
// idled. So the design spreads the walk:
//   - Balance. The wrapper's plan (two small kernels in tile_walk.cuh,
//     shared with K9) cuts each tile's walk into slices of at most S = 16
//     groups (the fastest of 8, 16 and 32 on the 1080p stress frame;
//     ops/raster.py K1_SLICE mirrors it to size the plan's workspace)
//     and lists them; a persistent grid takes slices from an atomic
//     counter. The plan reads no count on the host: its sizes are upper
//     bounds from the bins' shapes.
//   - Merge. The plan writes a tile with nothing to walk (on the 1080p
//     stress frame 869 of 2,040) and lists no slice for it. A tile of one
//     slice writes its pixels directly. The slices of a split tile meet
//     in a 64-bit atomicMin per pixel of (|z|'s bits, walk position) in a
//     scratch plane (the plan sets a split tile's keys to all ones); the
//     slice that finishes last (a per-tile counter) turns each position
//     back into its column and recomputes z from the same rounded plane
//     (a -0.0 winner keeps its bits).
//   - Staging. One barrier per slice: each thread loads its triangles of
//     the NEXT slice into registers while the CTA merges the current one
//     from shared memory, then stores them (edge coefficients with their
//     top-left threshold, the z plane, an 8-bit warp mask) to the other
//     buffer. Registers, not cp.async or TMA (no such variant was built
//     or timed): the thresholds and the mask are computed on the way in,
//     which a raw async copy would leave to a second pass behind a second
//     barrier, and at S = 16 a thread stages one triangle, 17 registers.
//   - Work per thread and culling. 256 threads, 4 pixels each along a
//     row, so b*py + c is formed once per edge for 4 tests and each
//     shared-memory read serves 4 pixels. Warp w owns the 16x8 block (w %
//     2, w / 2) of the tile. A triangle whose bbox, widened by one pixel,
//     misses a warp's block is not tested by that warp: after the
//     barrier each warp lists, in walk order, the slice's triangles whose
//     mask names it (a ballot a 32 triangles), and walks only its list.
//     The bbox holds every centre the rounded edge test can cover: the
//     rounding error of e in pixels is about 2^-24 times the vertex
//     coordinates, far below a pixel on screen (tests/test_torch_raster.py
//     checks the rule on its cases).
// Rounding stays exactly the twin's: the file is compiled with
// -fmad=false and the planes use __fmul_rn/__fadd_rn, with no incremental
// stepping of the edge functions. Under -fmad=false the f32 pipe issues
// each multiply and add as two instructions, so the 67 TFLOP/s behind the
// row's operation bound (an FMA counted as two) is reachable at half rate
// only: twice that bound is this kernel's real ALU floor.
//
// What bounds it now. The walk is spread, so the time follows the summed
// work, and the work is set by the cull's grain: a warp tests its 128
// pixels against every triangle whose widened bbox reaches its block,
// while the stress frame's triangles cover a few pixels each (the tests
// inside the triangles' bboxes are under 1% of the walk's tests,
// chip_smoke.py); the plan's two launches add a fixed cost. Rasterizing
// pixel-sized triangles one thread a triangle over its bbox, into the
// same (|z|, walk position) keys, is the step after this one.
//
// The plan and the merge (tile_walk.cuh) take any per-tile list of
// groups; K9 (raster_msaa.cu) walks its bins on them too, and K7
// (binned.cu) walks its chunk lists the same serial way and can.

#include "tile_walk.cuh"

namespace {

constexpr int THREADS = 256;  // 8 warps x 32 lanes x 4 pixels
constexpr int S = 16;  // groups a slice walks at most (K1_SLICE)
constexpr int NT = S * GROUP;  // triangles a slice stages
constexpr int TPT = (NT + THREADS - 1) / THREADS;  // of them a thread

// a staged triangle: per edge (a, b, c, threshold), then the z plane
struct alignas(16) Tri {
  float4 e[3];
  float4 z;
};

// a triangle as loaded from its setup row, before staging
struct Raw {
  float4 e[3];
  float bb[4];
  int col;
};

// ---- the slice walk --------------------------------------------------------

// this thread's triangles q = tid + u * THREADS of slice `sl`
__device__ __forceinline__ void load_raw(const float* __restrict__ setup,
                                         const int* __restrict__ entries,
                                         const int* __restrict__ tile_big,
                                         int nb_max, const Slice& sl,
                                         Raw* raw) {
#pragma unroll
  for (int u = 0; u < TPT; ++u) {
    const int q = threadIdx.x + u * THREADS;
    if (q < sl.n * GROUP) {
      const int g = walk_group(entries, tile_big, nb_max, sl.t, sl.off,
                               sl.cnt, sl.p0 + q / GROUP);
      const int col = g * GROUP + q % GROUP;
      const float* r = setup + (size_t)col * NSETUP;
      const float4* r4 = reinterpret_cast<const float4*>(r);
      raw[u].e[0] = __ldg(r4);
      raw[u].e[1] = __ldg(r4 + 1);
      raw[u].e[2] = __ldg(r4 + 2);
#pragma unroll
      for (int k = 0; k < 4; ++k) raw[u].bb[k] = __ldg(r + S_BB_MINX + k);
      raw[u].col = col;
    }
  }
}

// raw -> shared memory: thresholds, and the warp blocks of tile (X, Y)
// that the triangle's widened bbox reaches (bit w of smask)
__device__ __forceinline__ void stage_raw(const Slice& sl, const Raw* raw,
                                          float X, float Y, Tri* stage,
                                          int* scol, int* smask) {
#pragma unroll
  for (int u = 0; u < TPT; ++u) {
    const int q = threadIdx.x + u * THREADS;
    if (q < sl.n * GROUP) {
      // raw[u].e[0..2] hold floats 0..11 of the row: the three edges'
      // (a, b, c), then the z plane (za, zb, zc)
      const float4 r0 = raw[u].e[0], r1 = raw[u].e[1], r2 = raw[u].e[2];
      Tri tri;
      tri.e[0] = edge(r0.x, r0.y, r0.z);
      tri.e[1] = edge(r0.w, r1.x, r1.y);
      tri.e[2] = edge(r1.z, r1.w, r2.x);
      // pixel centres of warp block (cx, ry): X + 16 cx + [0.5, 15.5],
      // Y + 8 ry + [0.5, 7.5]; the bbox widened by one pixel
      const float x0 = raw[u].bb[0] - 1.f, y0 = raw[u].bb[1] - 1.f;
      const float x1 = raw[u].bb[2] + 1.f, y1 = raw[u].bb[3] + 1.f;
      unsigned mask = 0;
#pragma unroll
      for (int w = 0; w < 8; ++w) {
        const float bx = X + (float)(16 * (w & 1));
        const float by = Y + (float)(8 * (w >> 1));
        if (x0 <= bx + 15.5f && x1 >= bx + 0.5f && y0 <= by + 7.5f &&
            y1 >= by + 0.5f) {
          mask |= 1u << w;
        }
      }
      tri.z = make_float4(r2.y, r2.z, r2.w, 0.f);
      stage[q] = tri;
      scol[q] = raw[u].col;
      smask[q] = (int)mask;
    }
  }
}

__global__ void __launch_bounds__(THREADS, 3)
raster16_kernel(const float* __restrict__ setup,
                const int* __restrict__ entries,
                const int* __restrict__ tile_big, int nb_max,
                const Slice* __restrict__ work, int* __restrict__ ctl,
                int* __restrict__ done,
                unsigned long long* __restrict__ scratch, int n_tx,
                int width, int height, int* __restrict__ out_col,
                float* __restrict__ out_depth) {
  extern __shared__ float4 smem[];
  Tri* stage = reinterpret_cast<Tri*>(smem);               // [2][NT]
  int* scol = reinterpret_cast<int*>(stage + 2 * NT);      // [2][NT]
  int* smask = scol + 2 * NT;                              // [2][NT]
  short* wlist = reinterpret_cast<short*>(smask + 2 * NT)  // [8][NT]
                 + (threadIdx.x >> 5) * NT;
  __shared__ int s_next[2];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int lx0 = 16 * (warp & 1) + 4 * (lane & 3);  // 4 pixels from lx0
  const int ly = 8 * (warp >> 1) + (lane >> 2);
  const int total = ctl[1];

  if (tid == 0) s_next[0] = atomicAdd(ctl, 1);
  __syncthreads();
  if (s_next[0] >= total) return;
  Slice cur = load_slice(work, s_next[0]);
  Raw raw[TPT];
  load_raw(setup, entries, tile_big, nb_max, cur, raw);

  for (int p = 0;; p ^= 1) {
    const int tile_x = cur.t % n_tx, tile_y = cur.t / n_tx;
    const float X = (float)(tile_x * BT), Y = (float)(tile_y * BT);
    Tri* st = stage + p * NT;
    int* sc = scol + p * NT;
    const int* sm = smask + p * NT;
    stage_raw(cur, raw, X, Y, st, sc, smask + p * NT);
    if (tid == 0) s_next[p ^ 1] = atomicAdd(ctl, 1);
    __syncthreads();
    // the next slice's loads fly while this one merges
    const int s2 = s_next[p ^ 1];
    Slice nxt = cur;
    if (s2 < total) {
      nxt = load_slice(work, s2);
      load_raw(setup, entries, tile_big, nb_max, nxt, raw);
    }

    const float py = Y + (float)ly + 0.5f;
    float px[4], bz[4];
    int bi[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      px[i] = X + (float)(lx0 + i) + 0.5f;
      bz[i] = 1.f;
      bi[i] = -1;
    }
    // this warp's triangles, in walk order: those whose mask names it
    const int ntri = cur.n * GROUP;
    int nw = 0;
    for (int b = 0; b < ntri; b += 32) {
      const int q = b + lane;
      const bool mine = q < ntri && ((sm[q] >> warp) & 1);
      const unsigned bal = __ballot_sync(0xffffffffu, mine);
      if (mine) wlist[nw + __popc(bal & ((1u << lane) - 1))] = (short)q;
      nw += __popc(bal);
    }
    __syncwarp();
    for (int j = 0; j < nw; ++j) {
      const int q = wlist[j];
      const float4 zq = st[q].z;
      const float4 e0 = st[q].e[0], e1 = st[q].e[1], e2 = st[q].e[2];
      const float h0 = __fadd_rn(__fmul_rn(e0.y, py), e0.z);
      const float h1 = __fadd_rn(__fmul_rn(e1.y, py), e1.z);
      const float h2 = __fadd_rn(__fmul_rn(e2.y, py), e2.z);
      const float hz = __fadd_rn(__fmul_rn(zq.y, py), zq.z);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float v0 = __fadd_rn(__fmul_rn(e0.x, px[i]), h0);
        const float v1 = __fadd_rn(__fmul_rn(e1.x, px[i]), h1);
        const float v2 = __fadd_rn(__fmul_rn(e2.x, px[i]), h2);
        const float z = __fadd_rn(__fmul_rn(zq.x, px[i]), hz);
        // z < bz <= 1 implies the reference's z <= 1
        if (v0 >= e0.w && v1 >= e1.w && v2 >= e2.w && z >= 0.f &&
            z < bz[i]) {
          bz[i] = z;
          bi[i] = q;
        }
      }
    }

    const int y = tile_y * BT + ly;
    const size_t row = (size_t)y * width;
    if (cur.ns == 1) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int x = tile_x * BT + lx0 + i;
        if (x < width && y < height) {
          out_col[row + x] = bi[i] >= 0 ? sc[bi[i]] : -1;
          out_depth[row + x] = bz[i];
        }
      }
    } else {
      unsigned long long* tp = scratch + (size_t)cur.t * NPX + ly * BT + lx0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (bi[i] >= 0) {
          atomicMin(tp + i, merge_key(bz[i], cur.p0 * GROUP + bi[i]));
        }
      }
      if (last_slice_of_tile(done, cur)) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int x = tile_x * BT + lx0 + i;
          if (x >= width || y >= height) continue;
          const unsigned long long v = __ldcg(tp + i);
          int col = -1;
          float z = 1.f;
          if (v != NO_HIT) {
            const int pos = (int)(unsigned)v;
            const int g = walk_group(entries, tile_big, nb_max, cur.t,
                                     cur.off, cur.cnt, pos / GROUP);
            col = g * GROUP + pos % GROUP;
            const float* r = setup + (size_t)col * NSETUP;
            z = plane(r[9], r[10], r[11], px[i], py);
          }
          out_col[row + x] = col;
          out_depth[row + x] = z;
        }
      }
    }
    if (s2 >= total) break;
    cur = nxt;
  }
}

}  // namespace

// ws: the plan's int32 workspace and scratch: n_tiles * 1024 u64, the
// merge keys of split tiles (tile_walk.cuh's layout).
extern "C" int awsm_raster16(const float* setup, const int* entries,
                             const int* offsets, const int* counts,
                             const int* big_packed, const int* big_ids,
                             const int* n_big, int n_tiles, int n_tx,
                             int width, int height, int nb_max,
                             int max_slices, int* ws,
                             unsigned long long* scratch, int* out_col,
                             float* out_depth, cudaStream_t stream) {
  if (n_tiles <= 0) return (int)cudaGetLastError();
  if (nb_max < 1 || nb_max > NBIG_CAP || max_slices < n_tiles) {
    return (int)cudaErrorInvalidValue;
  }
  const Plan p = plan_launch<S>(counts, offsets, big_packed, big_ids, n_big,
                                n_tiles, n_tx, width, height, nb_max, 1, ws,
                                scratch, out_col, out_depth, stream);
  constexpr size_t SMEM =
      2 * NT * (sizeof(Tri) + 2 * sizeof(int)) + 8 * NT * sizeof(short);
  static const int resident =
      resident_blocks(raster16_kernel, THREADS, SMEM);
  raster16_kernel<<<min(resident, max_slices), THREADS, SMEM, stream>>>(
      setup, entries, p.tile_big, nb_max, p.work, p.ctl, p.done, scratch,
      n_tx, width, height, out_col, out_depth);
  return (int)cudaGetLastError();
}
