// The planned slice walk that K1 (raster16.cu) and K9 (raster_msaa.cu)
// share: how a tile's walk over its bin is cut into slices for a
// persistent grid, and how the slices of a split tile meet.
//
// A tile's walk is its cnt binned entries (entries[off ...], the binner's
// near-first order), then the big groups whose tile box holds it, in
// big-list order. The plan (two small kernels, launched by plan_launch)
// lists each big group a tile walks, cuts every walk into slices of at
// most S groups and writes the slice list; it reads no count on the host,
// since the wrapper sizes the workspace from the bins' shapes. A tile with
// nothing to walk is written by the plan (every integer plane -1, depth
// 1.0) and gets no slice. A tile of more than S groups (one that splits)
// has its merge keys set to NO_HIT, `planes` of them a pixel (one a
// sample: K1 has 1, K9 4).
//
// A walk kernel takes slices from ctl[0] with an atomicAdd. A tile of one
// slice writes its pixels directly. The slices of a split tile meet in a
// 64-bit atomicMin a key of (|z|'s bits, walk position * GROUP + the
// triangle in its group): the least z in [0, 1), +0.0 and -0.0 equal, the
// earliest walk position on equal z, which is the sequential walk's strict
// z < best. The last slice of the tile (last_slice_of_tile) turns each
// key back into its column and recomputes z from the winner's plane, so
// a -0.0 keeps its bits.
//
// Workspace (int32): ctl[4] | done[n_tiles] | walk_len[n_tiles] |
// tile_big[n_tiles * nb_max] | (16-byte aligned) max_slices Slice records.
// Scratch: n_tiles * planes * NPX u64 keys (no value needed on entry).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NSETUP = 64;
constexpr int GROUP = 16;
constexpr int BT = 32;  // tile edge in output pixels
constexpr int NPX = BT * BT;
constexpr int NBIG_CAP = 512;  // ops/raster.py NBIG_CAP
constexpr int S_BB_MINX = 15;  // then min y, max x, max y
constexpr float FMIN = 1.1754943508222875e-38f;
constexpr unsigned long long NO_HIT = ~0ull;
constexpr int PLAN_THREADS = 256;

// one work slice: tile t, walk positions [p0, p0 + n) of the tile's walk
// (its cnt binned entries from entries[off], then its big groups), and
// the tile's number of slices ns
struct alignas(16) Slice {
  int t, p0, off, cnt, n, ns, pad0, pad1;
};

__device__ __forceinline__ float plane(float a, float b, float c, float px,
                                       float py) {
  return __fadd_rn(__fmul_rn(a, px), __fadd_rn(__fmul_rn(b, py), c));
}

// (a, b, c, the top-left threshold): e >= threshold covers
__device__ __forceinline__ float4 edge(float a, float b, float c) {
  const bool tl = (a > 0.f) || (a == 0.f && b > 0.f);
  return make_float4(a, b, c, tl ? 0.f : FMIN);
}

__device__ __forceinline__ bool touches(int bb, int tx, int ty) {
  return (bb & 255) <= tx && tx <= ((bb >> 16) & 255) &&
         ((bb >> 8) & 255) <= ty && ty <= ((bb >> 24) & 255);
}

// walk position b of tile t -> its binned entry (b < cnt) or big group id
__device__ __forceinline__ int walk_group(const int* __restrict__ entries,
                                          const int* __restrict__ tile_big,
                                          int nb_max, int t, int off,
                                          int cnt, int b) {
  return b < cnt ? entries[off + b] : tile_big[(size_t)t * nb_max + b - cnt];
}

// ---- the plan ------------------------------------------------------------

// one block per tile: the big groups whose tile box holds it, in
// big-list order (a ballot a warp, warps in order), into tile_big[t *
// nb_max ...]; its walk length; for a tile that will split, its keys set
// to NO_HIT; for a tile with nothing to walk, its pixels (-1 in each of
// `planes` integer planes of width * height, 1.0 in the depth plane)
template <int S>
__global__ void __launch_bounds__(PLAN_THREADS)
plan_count_kernel(const int* __restrict__ counts,
                  const int* __restrict__ big_packed,
                  const int* __restrict__ big_ids,
                  const int* __restrict__ n_big, int n_tx, int nb_max,
                  int width, int height, int planes,
                  int* __restrict__ tile_big, int* __restrict__ walk_len,
                  unsigned long long* __restrict__ scratch,
                  int* __restrict__ out_int, float* __restrict__ out_depth) {
  __shared__ int warp_hits[PLAN_THREADS / 32];
  const int t = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tx = t % n_tx, ty = t / n_tx;
  const int nb = min(n_big[0], nb_max);
  int k = 0;  // big groups listed so far
  for (int i0 = 0; i0 < nb; i0 += PLAN_THREADS) {
    const int i = i0 + threadIdx.x;
    const bool hit = i < nb && touches(big_packed[i], tx, ty);
    const unsigned bal = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) warp_hits[warp] = __popc(bal);
    __syncthreads();
    int at = k + __popc(bal & ((1u << lane) - 1));
    for (int w = 0; w < PLAN_THREADS / 32; ++w) {
      at += w < warp ? warp_hits[w] : 0;
      k += warp_hits[w];
    }
    if (hit) tile_big[(size_t)t * nb_max + at] = big_ids[i];
    __syncthreads();
  }
  const int L = counts[t] + k;
  if (threadIdx.x == 0) walk_len[t] = L;
  if (L > S) {
    unsigned long long* tp = scratch + (size_t)t * planes * NPX;
    for (int p = threadIdx.x; p < planes * NPX; p += PLAN_THREADS) {
      tp[p] = NO_HIT;
    }
  } else if (L == 0) {
    const size_t P = (size_t)width * height;
    for (int p = threadIdx.x; p < NPX; p += PLAN_THREADS) {
      const int x = tx * BT + p % BT, y = ty * BT + p / BT;
      if (x < width && y < height) {
        const size_t o = (size_t)y * width + x;
        for (int k2 = 0; k2 < planes; ++k2) out_int[k2 * P + o] = -1;
        out_depth[o] = 1.f;
      }
    }
  }
}

// one block of 1024 threads: an exclusive scan of the tiles' slice counts
// ceil(L / S) writes the slice list in tile order; ctl = (0, the number
// of slices), done[t] = 0
template <int S>
__global__ void __launch_bounds__(1024)
plan_scan_kernel(const int* __restrict__ counts,
                 const int* __restrict__ offsets,
                 const int* __restrict__ walk_len, int n_tiles,
                 Slice* __restrict__ work, int* __restrict__ ctl,
                 int* __restrict__ done) {
  __shared__ int warp_sums[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int carry = 0;
  for (int base = 0; base < n_tiles; base += 1024) {
    const int t = base + threadIdx.x;
    const int L = t < n_tiles ? walk_len[t] : 0;
    const int ns = t < n_tiles ? (L + S - 1) / S : 0;
    int v = ns;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    if (lane == 31) warp_sums[warp] = v;
    __syncthreads();
    if (warp == 0) {
      int w = warp_sums[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, w, o);
        if (lane >= o) w += u;
      }
      warp_sums[lane] = w;
    }
    __syncthreads();
    if (warp > 0) v += warp_sums[warp - 1];
    const int start = carry + v - ns;
    carry += warp_sums[31];
    if (t < n_tiles) {
      const int cnt = counts[t], off = offsets[t];
      done[t] = 0;
      for (int j = 0; j < ns; ++j) {
        const int p0 = j * S;
        work[start + j] = Slice{t, p0, off, cnt, min(S, L - p0), ns, 0, 0};
      }
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    ctl[0] = 0;
    ctl[1] = carry;
  }
}

// the workspace's parts (layout above)
struct Plan {
  int* ctl;
  int* done;
  int* tile_big;
  Slice* work;
};

// launch the plan on `stream`; the caller has checked the arguments
template <int S>
Plan plan_launch(const int* counts, const int* offsets, const int* big_packed,
                 const int* big_ids, const int* n_big, int n_tiles, int n_tx,
                 int width, int height, int nb_max, int planes, int* ws,
                 unsigned long long* scratch, int* out_int, float* out_depth,
                 cudaStream_t stream) {
  Plan p;
  p.ctl = ws;
  p.done = p.ctl + 4;
  int* walk_len = p.done + n_tiles;
  p.tile_big = walk_len + n_tiles;
  const size_t head = 4 + 2 * (size_t)n_tiles + (size_t)n_tiles * nb_max;
  p.work = reinterpret_cast<Slice*>(ws + (head + 3) / 4 * 4);
  plan_count_kernel<S><<<n_tiles, PLAN_THREADS, 0, stream>>>(
      counts, big_packed, big_ids, n_big, n_tx, nb_max, width, height,
      planes, p.tile_big, walk_len, scratch, out_int, out_depth);
  plan_scan_kernel<S><<<1, 1024, 0, stream>>>(counts, offsets, walk_len,
                                              n_tiles, p.work, p.ctl, p.done);
  return p;
}

// blocks of `kernel` resident on the whole card at `threads` a block and
// `smem` bytes of dynamic shared memory (which this also allows it)
template <class Kernel>
int resident_blocks(Kernel kernel, int threads, size_t smem) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                smem);
  return max(per_sm, 1) * max(sms, 1);
}

// ---- the slice walk ------------------------------------------------------

__device__ __forceinline__ Slice load_slice(const Slice* __restrict__ work,
                                            int s) {
  const int4* w = reinterpret_cast<const int4*>(work + s);
  const int4 a = __ldg(w), b = __ldg(w + 1);
  return Slice{a.x, a.y, a.z, a.w, b.x, b.y, 0, 0};
}

// the merge key of a winner at z (>= 0, so |z| orders like z with -0.0 =
// +0.0) and walk position pos * GROUP + its triangle
__device__ __forceinline__ unsigned long long merge_key(float z, int pos) {
  return (unsigned long long)__float_as_uint(fabsf(z)) << 32 | (unsigned)pos;
}

// called by every thread of the block after its atomicMins into a split
// tile's keys: whether this block ran the tile's last slice (and then sees
// every other slice's keys)
__device__ __forceinline__ bool last_slice_of_tile(int* __restrict__ done,
                                                   const Slice& sl) {
  __shared__ int s_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(done + sl.t, 1) == sl.ns - 1;
  __syncthreads();
  const bool last = s_last;
  if (last) __threadfence();
  return last;
}

}  // namespace
