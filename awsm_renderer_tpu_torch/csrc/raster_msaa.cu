// K9: MSAA-4x coverage raster. Four sample winners (tl, tr, bl, br) and
// the min-sample depth per display pixel, from row-major triangle setup in
// supersampled coordinates (twice the display resolution).
//
// Replaces the TPU kernel awsm_renderer_tpu/ops/raster.py::rasterize16_msaa
// (pallas_call at raster.py:1966, body _make_v5_msaa_kernel at
// raster.py:1730, sample math _msaa_sample_winners at raster.py:1663).
//
// The function. Each 32x32 display tile (one 64x64 supersampled bin) walks
// its packed entries (g << 8) | (mask1 << 4) | mask0 in bin order (the
// binner's near-first order), then the big groups whose tile box holds
// it, in big-list order. A binned entry is merged only in the quadrants q
// (= (ly >= 16) * 2 + (lx >= 16)) its gate names, ((e >> q) & 0x11) != 0,
// the TPU kernel's rule; a big group in every quadrant. Per triangle and
// sample (i, j): e = a*px + (b*py + c) at the top-left sample centre px =
// 2x + 0.5, py = 2y + 0.5, then + a if j, then + b if i (the TPU kernel's
// rounding); covered when all three edges pass e >= (top-left ? 0 :
// FLT_MIN_NORMAL) and z >= 0; strict z < best. So each sample's winner is
// the least z in [0, 1), the earliest walk position on equal z, with z's
// own bits; -1 and 1.0 where nothing covers. The depth is the min of the
// four. -fmad=false and __fmul_rn/__fadd_rn keep every rounding, so the
// plain twin in ops/raster.py, which walks the same order, is bit-equal.
//
// The design is K1's (raster16.cu) at a finer grain, with four sample
// states a pixel:
//   - Balance. The plan (tile_walk.cuh, shared with K1) cuts each tile's
//     walk into slices of at most S = 48 groups on a persistent grid. The
//     plan writes a tile with nothing to walk (four planes of -1, depth
//     1.0). A tile of one slice writes its pixels directly; the slices of
//     a split tile meet in one 64-bit atomicMin a sample of (|z|'s bits,
//     walk position * 16 + the triangle), four keys a pixel, and the last
//     of them turns each key back into its column and recomputes that
//     sample's z from the winner's plane with the sample's own rounding.
//     A binned entry's gate travels with it: the walk unpacks the entry
//     (a big group's gate is all quadrants).
//   - Work per thread. 1024 threads, one display pixel each, its four
//     (z, position) sample states in registers (64 registers, no
//     spills). Each sample adds + a and + b to the top-left value, as
//     the twin does.
//   - Two culls, fixed when a slice is staged: warp w owns the 16x2
//     display block (w % 2, w / 2), which lies inside one quadrant, so
//     the gate is one test a warp and an entry; and a triangle whose bbox
//     (supersampled), widened by one supersampled pixel, reaches none of
//     the block's sample centres (2x + 0.5 and 2x + 1.5 over the block's
//     x, the same in y) is not tested by that warp. Each warp walks, in
//     walk order, the slice's triangles both culls leave it.
//   - Why this grain: on the 1080p MSAA frame on an NVIDIA H100 (700 W;
//     scripts/k9_k5_variants.py, PERF.md), 4 pixels a thread with 256
//     threads (16x8 blocks, 115 registers, 2 blocks an SM) took 0.176 ms
//     at S = 16, 2 pixels with 512 threads (16x4 blocks, 64 registers, 2
//     blocks) 0.131, 1 pixel 0.134 at S = 16 and 0.106 at S = 48. A finer
//     block tests fewer pixels against a small triangle; a larger slice
//     pays fewer barriers, staging passes and merges.
//
// What bounds it. The work is the coverage tests, 32 float operations a
// triangle and display pixel (the full test at the top-left sample, then
// + a, + b, + a + b for each of the four planes), and the cull's grain
// sets how many of them are made: a warp tests its 32 pixels against
// every triangle whose widened bbox reaches its block, while the 1080p
// MSAA frame's triangles cover a few display pixels each (chip_smoke.py
// prints both bounds). Under -fmad=false each multiply and add issues
// alone, so half the f32 rate is the real ALU roof. The plan's two
// launches add a fixed cost.

#include "tile_walk.cuh"

namespace {

constexpr int S = 48;  // groups a slice walks at most (K9_SLICE)
constexpr int PX = 1;  // display pixels a thread, along a row
constexpr int THREADS = NPX / PX;
constexpr int NWARP = THREADS / 32;
constexpr int LX = 16 / PX;   // lanes along a row of a warp's 16-pixel block
constexpr int BH = 32 / LX;   // rows of a warp's block
// blocks an SM the registers must allow: at most 128 registers a thread
// (64 at 1024 threads)
constexpr int MIN_BLOCKS = THREADS < 512 ? 512 / THREADS : 1;
constexpr int NT = S * GROUP;  // triangles a slice stages
constexpr int TPT = (NT + THREADS - 1) / THREADS;  // of them a thread
constexpr int SAMPLES = 4;

// a staged triangle: per edge (a, b, c, threshold), then the z plane
struct alignas(16) Tri {
  float4 e[3];
  float4 z;
};

// a triangle as loaded from its setup row, before staging, with its
// entry's quadrant gate
struct Raw {
  float4 e[3];
  float bb[4];
  int col, gate;
};

// the quadrant that warp w's block lies in
__device__ __forceinline__ int warp_quadrant(int w) {
  return ((BH * (w >> 1) >= BT / 2) << 1) | (w & 1);
}

// v at the four samples (tl, tr, bl, br): + a if j, then + b if i
__device__ __forceinline__ void samples(float v, float a, float b,
                                        float (&out)[SAMPLES]) {
  out[0] = v;
  out[1] = __fadd_rn(v, a);
  out[2] = __fadd_rn(v, b);
  out[3] = __fadd_rn(out[1], b);
}

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
      const int b = sl.p0 + q / GROUP;
      const int e = walk_group(entries, tile_big, nb_max, sl.t, sl.off,
                               sl.cnt, b);
      const bool binned = b < sl.cnt;
      const int col = (binned ? e >> 8 : e) * GROUP + q % GROUP;
      const float* r = setup + (size_t)col * NSETUP;
      const float4* r4 = reinterpret_cast<const float4*>(r);
      raw[u].e[0] = __ldg(r4);
      raw[u].e[1] = __ldg(r4 + 1);
      raw[u].e[2] = __ldg(r4 + 2);
#pragma unroll
      for (int k = 0; k < 4; ++k) raw[u].bb[k] = __ldg(r + S_BB_MINX + k);
      raw[u].col = col;
      raw[u].gate = binned ? e & 0xFF : 0xFF;
    }
  }
}

// raw -> shared memory: thresholds, and the warps that test the triangle
// (bit w of smask): its gate names the warp's quadrant and its widened
// bbox reaches a sample centre of the warp's block. (X2, Y2) is the
// tile's supersampled origin.
__device__ __forceinline__ void stage_raw(const Slice& sl, const Raw* raw,
                                          float X2, float Y2, Tri* stage,
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
      // sample centres of warp block (cx, ry): X2 + 32 cx + [0.5, 31.5],
      // Y2 + 2 BH ry + [0.5, 2 BH - 0.5]; the bbox widened by one
      // supersampled pixel
      const float x0 = raw[u].bb[0] - 1.f, y0 = raw[u].bb[1] - 1.f;
      const float x1 = raw[u].bb[2] + 1.f, y1 = raw[u].bb[3] + 1.f;
      unsigned mask = 0;
#pragma unroll
      for (int w = 0; w < NWARP; ++w) {
        const float bx = X2 + (float)(2 * 16 * (w & 1));
        const float by = Y2 + (float)(2 * BH * (w >> 1));
        if (((raw[u].gate >> warp_quadrant(w)) & 0x11) != 0 &&
            x0 <= bx + 31.5f && x1 >= bx + 0.5f &&
            y0 <= by + (float)(2 * BH) - 0.5f && y1 >= by + 0.5f) {
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

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
raster_msaa_kernel(const float* __restrict__ setup,
                   const int* __restrict__ entries,
                   const int* __restrict__ tile_big, int nb_max,
                   const Slice* __restrict__ work, int* __restrict__ ctl,
                   int* __restrict__ done,
                   unsigned long long* __restrict__ scratch, int n_tx,
                   int W1, int H1, int* __restrict__ out_samp,
                   float* __restrict__ out_depth) {
  extern __shared__ float4 smem[];
  Tri* stage = reinterpret_cast<Tri*>(smem);               // [2][NT]
  int* scol = reinterpret_cast<int*>(stage + 2 * NT);      // [2][NT]
  int* smask = scol + 2 * NT;                              // [2][NT]
  short* wlist = reinterpret_cast<short*>(smask + 2 * NT)  // [NWARP][NT]
                 + (threadIdx.x >> 5) * NT;
  __shared__ int s_next[2];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int lx0 = 16 * (warp & 1) + PX * (lane % LX);  // PX pixels from lx0
  const int ly = BH * (warp >> 1) + lane / LX;
  const int total = ctl[1];
  const size_t P = (size_t)W1 * H1;

  if (tid == 0) s_next[0] = atomicAdd(ctl, 1);
  __syncthreads();
  if (s_next[0] >= total) return;
  Slice cur = load_slice(work, s_next[0]);
  Raw raw[TPT];
  load_raw(setup, entries, tile_big, nb_max, cur, raw);

  for (int p = 0;; p ^= 1) {
    const int tile_x = cur.t % n_tx, tile_y = cur.t / n_tx;
    Tri* st = stage + p * NT;
    int* sc = scol + p * NT;
    const int* sm = smask + p * NT;
    stage_raw(cur, raw, (float)(tile_x * 2 * BT), (float)(tile_y * 2 * BT),
              st, sc, smask + p * NT);
    if (tid == 0) s_next[p ^ 1] = atomicAdd(ctl, 1);
    __syncthreads();
    // the next slice's loads fly while this one merges
    const int s2 = s_next[p ^ 1];
    Slice nxt = cur;
    if (s2 < total) {
      nxt = load_slice(work, s2);
      load_raw(setup, entries, tile_big, nb_max, nxt, raw);
    }

    // the top-left sample centres (exact: 2x + 0.5 for x < 2^22)
    const int y = tile_y * BT + ly;
    const float py = 2.f * (float)y + 0.5f;
    float px[PX], bz[PX][SAMPLES];
    int bi[PX][SAMPLES];
#pragma unroll
    for (int i = 0; i < PX; ++i) {
      px[i] = 2.f * (float)(tile_x * BT + lx0 + i) + 0.5f;
#pragma unroll
      for (int s = 0; s < SAMPLES; ++s) {
        bz[i][s] = 1.f;
        bi[i][s] = -1;
      }
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
      for (int i = 0; i < PX; ++i) {
        float v0[SAMPLES], v1[SAMPLES], v2[SAMPLES], z[SAMPLES];
        samples(__fadd_rn(__fmul_rn(e0.x, px[i]), h0), e0.x, e0.y, v0);
        samples(__fadd_rn(__fmul_rn(e1.x, px[i]), h1), e1.x, e1.y, v1);
        samples(__fadd_rn(__fmul_rn(e2.x, px[i]), h2), e2.x, e2.y, v2);
        samples(__fadd_rn(__fmul_rn(zq.x, px[i]), hz), zq.x, zq.y, z);
#pragma unroll
        for (int s = 0; s < SAMPLES; ++s) {
          // z < bz <= 1 implies the reference's z <= 1
          if (v0[s] >= e0.w && v1[s] >= e1.w && v2[s] >= e2.w &&
              z[s] >= 0.f && z[s] < bz[i][s]) {
            bz[i][s] = z[s];
            bi[i][s] = q;
          }
        }
      }
    }

    const size_t row = (size_t)y * W1;
    if (cur.ns == 1) {
#pragma unroll
      for (int i = 0; i < PX; ++i) {
        const int x = tile_x * BT + lx0 + i;
        if (x < W1 && y < H1) {
#pragma unroll
          for (int s = 0; s < SAMPLES; ++s) {
            out_samp[s * P + row + x] = bi[i][s] >= 0 ? sc[bi[i][s]] : -1;
          }
          out_depth[row + x] = fminf(fminf(bz[i][0], bz[i][1]),
                                     fminf(bz[i][2], bz[i][3]));
        }
      }
    } else {
      // keys [tile][sample][pixel]
      unsigned long long* tp =
          scratch + (size_t)cur.t * SAMPLES * NPX + ly * BT + lx0;
#pragma unroll
      for (int i = 0; i < PX; ++i) {
#pragma unroll
        for (int s = 0; s < SAMPLES; ++s) {
          if (bi[i][s] >= 0) {
            atomicMin(tp + s * NPX + i,
                      merge_key(bz[i][s], cur.p0 * GROUP + bi[i][s]));
          }
        }
      }
      if (last_slice_of_tile(done, cur)) {
#pragma unroll
        for (int i = 0; i < PX; ++i) {
          const int x = tile_x * BT + lx0 + i;
          if (x >= W1 || y >= H1) continue;
          float zs[SAMPLES];
#pragma unroll
          for (int s = 0; s < SAMPLES; ++s) {
            const unsigned long long v = __ldcg(tp + s * NPX + i);
            int col = -1;
            zs[s] = 1.f;
            if (v != NO_HIT) {
              const int pos = (int)(unsigned)v, b = pos / GROUP;
              const int e = walk_group(entries, tile_big, nb_max, cur.t,
                                       cur.off, cur.cnt, b);
              col = (b < cur.cnt ? e >> 8 : e) * GROUP + pos % GROUP;
              const float* r = setup + (size_t)col * NSETUP;
              float z = plane(r[9], r[10], r[11], px[i], py);
              if (s & 1) z = __fadd_rn(z, r[9]);
              if (s >> 1) z = __fadd_rn(z, r[10]);
              zs[s] = z;
            }
            out_samp[s * P + row + x] = col;
          }
          out_depth[row + x] = fminf(fminf(zs[0], zs[1]), fminf(zs[2], zs[3]));
        }
      }
    }
    if (s2 >= total) break;
    cur = nxt;
  }
}

}  // namespace

// ws: the plan's int32 workspace and scratch: n_tiles * 4 * 1024 u64, the
// merge keys of split tiles (tile_walk.cuh's layout); out_samp: the four
// (H1, W1) sample planes tl, tr, bl, br.
extern "C" int awsm_raster_msaa(const float* setup, const int* entries,
                                const int* offsets, const int* counts,
                                const int* big_packed, const int* big_ids,
                                const int* n_big, int n_tiles, int n_tx,
                                int W1, int H1, int nb_max, int max_slices,
                                int* ws, unsigned long long* scratch,
                                int* out_samp, float* out_depth,
                                cudaStream_t stream) {
  if (n_tiles <= 0) return (int)cudaGetLastError();
  if (nb_max < 1 || nb_max > NBIG_CAP || max_slices < n_tiles) {
    return (int)cudaErrorInvalidValue;
  }
  const Plan p = plan_launch<S>(counts, offsets, big_packed, big_ids, n_big,
                                n_tiles, n_tx, W1, H1, nb_max, SAMPLES, ws,
                                scratch, out_samp, out_depth, stream);
  constexpr size_t SMEM =
      2 * NT * (sizeof(Tri) + 2 * sizeof(int)) + NWARP * NT * sizeof(short);
  static const int resident =
      resident_blocks(raster_msaa_kernel, THREADS, SMEM);
  raster_msaa_kernel<<<min(resident, max_slices), THREADS, SMEM, stream>>>(
      setup, entries, p.tile_big, nb_max, p.work, p.ctl, p.done, scratch,
      n_tx, W1, H1, out_samp, out_depth);
  return (int)cudaGetLastError();
}
