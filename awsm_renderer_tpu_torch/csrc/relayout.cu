// K3 and K6: the gather-and-split kernels of the shade.
//
// K3 awsm_onehot_split_rows replaces awsm_renderer_tpu/ops/relayout.py::
// onehot_split_rows (pallas_call at relayout.py:157): the per-pixel
// material fetch table[mat_row] into channel-major (C, P) planes. The TPU
// builds a one-hot matrix and multiplies it on the MXU; here each thread
// reads its row directly. A row outside [0, cap) gives zeros, as the
// one-hot product does.
//
// K6 awsm_gather_split_channels replaces awsm_renderer_tpu/ops/relayout.py::
// split_channels (pallas_call at relayout.py:69) on the environment-tap
// path (ops/cubemap.py sample_env_batch_c): it fuses the gather
// texels[clip(idx)][:, :ncols] (bf16 rows of the texel pool) with the
// (M, ncols) -> (ncols, M) split and the exact bf16 -> f32 widening, which
// is what the TPU pair (XLA gather + split_channels) computes.
//
// K6's f32 entry awsm_gather_split_channels_f32 serves the same TPU
// kernel on the volume-refraction path (ops/shade.py
// shade_transparent_layers_c; shade.py:1577 in the reference): it gathers
// the pre-transparent opaque rows table[clip(idx)][:, :ncols] of an
// (N, C) f32 table at the refracted pixels and splits them into
// (ncols, M) planes.
//
// K12 awsm_split_rows replaces awsm_renderer_tpu/ops/relayout.py::
// split_rows (pallas_call at relayout.py:106): a channel-major (C, P)
// table, f32 or bf16, materialised as C separate f32 rows. On the card the
// rows of one (C, P) f32 output are already separate contiguous arrays, so
// this is a widening copy, bound by DRAM bandwidth: at (8, 1920*1080) f32
// it reads and writes 66 MB each, more than the 50 MB L2 holds. The design
// is a plain bandwidth copy: a one-shot grid of 256-thread blocks, each
// copying 8 KB of 16-byte vectors; a thread has both of its loads in
// flight (read-only path, L1 left alone) before its stores, which are
// evict-first (__stcs: nothing here reads the rows back). On the H100
// that matches cudaMemcpyAsync; persistent grid-stride grids (4 or 8
// blocks an SM, 1-8 vectors in flight a thread, any load or store hint)
// measured 2-5 us slower (scripts/bench_k12_copy.cu). A bf16 table loads
// 8 values (16 bytes) and stores two float4s; bf16 -> f32 is the exact
// 16-bit shift. A table that is not 16-byte aligned goes one value at a
// time, and so do the values past the last whole vector.
//
// K13 awsm_channel_rows replaces relayout.py::channel_rows (pallas_call at
// :188): (P, C) -> (C, P) f32, a shared-memory tile transpose. A block
// reads TP whole rows (TP * C contiguous values, coalesced), writes them
// into a padded [C][TP + 1] tile, and stores each channel's TP values as
// one contiguous run of row c.
//
// All five are pure data movement: bounded on the H100 by DRAM bandwidth
// (K3: 4 B read + 4*C B written per pixel, the table stays in L1/L2; K6:
// a 32 B row read and 64 B written per tap; K6-f32: a 16 B row read and
// 16 B written per refracted pixel; K12 and K13: each value read once
// and written once as f32). Only K12 is vectorised so far.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void onehot_split_rows_kernel(const int* __restrict__ rows,
                                         const float* __restrict__ table,
                                         int cap, int C, int P,
                                         float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P) return;
  const int r = rows[i];
  const bool ok = r >= 0 && r < cap;
  const float* src = table + (size_t)(ok ? r : 0) * C;
  for (int c = 0; c < C; ++c) out[(size_t)c * P + i] = ok ? src[c] : 0.f;
}

__global__ void gather_split_kernel(const uint16_t* __restrict__ texels,
                                    int N, int row_cols,
                                    const int* __restrict__ idx, int M,
                                    int ncols, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M) return;
  const int r = min(max(idx[i], 0), N - 1);
  const uint16_t* src = texels + (size_t)r * row_cols;
  for (int c = 0; c < ncols; ++c) {
    out[(size_t)c * M + i] = __uint_as_float((uint32_t)src[c] << 16);
  }
}

__global__ void gather_split_f32_kernel(const float* __restrict__ table,
                                        int N, int row_cols,
                                        const int* __restrict__ idx, int M,
                                        int ncols, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M) return;
  const int r = min(max(idx[i], 0), N - 1);
  const float* src = table + (size_t)r * row_cols;
  for (int c = 0; c < ncols; ++c) out[(size_t)c * M + i] = src[c];
}

// x holds n values, f32 (bf16 == 0) or bf16 bit patterns (bf16 == 1)
__device__ __forceinline__ float load_f32(const void* x, size_t i, int bf16) {
  return bf16 ? __uint_as_float((uint32_t)((const uint16_t*)x)[i] << 16)
              : ((const float*)x)[i];
}

__device__ __forceinline__ float4 widen_lo(uint2 v) {
  return make_float4(__uint_as_float(v.x << 16),
                     __uint_as_float(v.x & 0xffff0000u),
                     __uint_as_float(v.y << 16),
                     __uint_as_float(v.y & 0xffff0000u));
}

// a 16-byte load on the read-only path that leaves L1 alone
__device__ __forceinline__ uint4 ld_stream(const uint4* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0,%1,%2,%3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

constexpr int SR_THREADS = 256, SR_VECS = 2;  // 16-byte vectors a thread

// one 16-byte vector of x (4 f32 or 8 bf16 values) -> its f32 values
template <bool BF16>
__device__ __forceinline__ void copy_vec(uint4 v, float4* out4, size_t i) {
  if (BF16) {
    __stcs(out4 + 2 * i, widen_lo(make_uint2(v.x, v.y)));
    __stcs(out4 + 2 * i + 1, widen_lo(make_uint2(v.z, v.w)));
  } else {
    __stcs(out4 + i, make_float4(__uint_as_float(v.x), __uint_as_float(v.y),
                                 __uint_as_float(v.z), __uint_as_float(v.w)));
  }
}

// block b copies the SR_THREADS * SR_VECS vectors from b * SR_THREADS *
// SR_VECS, both loads of a thread in flight before its stores; block 0
// also copies the values past the last whole vector. nv = 0 (x not
// 16-byte aligned): the block copies as many values, one by one.
template <bool BF16>
__global__ void __launch_bounds__(SR_THREADS)
split_rows_kernel(const void* __restrict__ x, size_t nv, size_t n,
                  float* __restrict__ out) {
  const size_t i = (size_t)blockIdx.x * SR_THREADS * SR_VECS + threadIdx.x;
  if (nv == 0) {
#pragma unroll
    for (int u = 0; u < SR_VECS; ++u) {
      const size_t j = i + u * SR_THREADS;
      if (j < n) out[j] = load_f32(x, j, BF16);
    }
    return;
  }
  const uint4* xv = static_cast<const uint4*>(x);
  float4* out4 = reinterpret_cast<float4*>(out);
  uint4 v[SR_VECS];
#pragma unroll
  for (int u = 0; u < SR_VECS; ++u) {
    if (i + u * SR_THREADS < nv) v[u] = ld_stream(xv + i + u * SR_THREADS);
  }
#pragma unroll
  for (int u = 0; u < SR_VECS; ++u) {
    if (i + u * SR_THREADS < nv) {
      copy_vec<BF16>(v[u], out4, i + u * SR_THREADS);
    }
  }
  const size_t tail = nv * (BF16 ? 8 : 4);
  if (blockIdx.x == 0 && tail + threadIdx.x < n) {
    out[tail + threadIdx.x] = load_f32(x, tail + threadIdx.x, BF16);
  }
}

constexpr int CR_THREADS = 256;

// one block per TP rows; tile is C x (TP + 1) floats of dynamic shared memory
__global__ void __launch_bounds__(CR_THREADS)
channel_rows_kernel(const void* __restrict__ x, int bf16, int P, int C, int TP,
                    float* __restrict__ out) {
  extern __shared__ float tile[];
  const int p0 = blockIdx.x * TP;
  const int rows = min(TP, P - p0);
  const int n = rows * C;
  const size_t base = (size_t)p0 * C;
  for (int i = threadIdx.x; i < n; i += CR_THREADS) {
    tile[(i % C) * (TP + 1) + i / C] = load_f32(x, base + i, bf16);
  }
  __syncthreads();
  for (int c = 0; c < C; ++c) {
    for (int p = threadIdx.x; p < rows; p += CR_THREADS) {
      out[(size_t)c * P + p0 + p] = tile[c * (TP + 1) + p];
    }
  }
}

}  // namespace

extern "C" int awsm_split_rows(const void* x, int bf16, int C, int P,
                               float* out, cudaStream_t stream) {
  const size_t n = (size_t)C * P;
  if (n > 0) {
    const size_t nv = (uintptr_t)x % 16 == 0 ? n / (bf16 ? 8 : 4) : 0;
    const size_t per_block = (size_t)SR_THREADS * SR_VECS;
    const unsigned grid = (unsigned)(((nv > 0 ? nv : n) + per_block - 1) /
                                     per_block);
    if (bf16) {
      split_rows_kernel<true><<<grid, SR_THREADS, 0, stream>>>(x, nv, n, out);
    } else {
      split_rows_kernel<false><<<grid, SR_THREADS, 0, stream>>>(x, nv, n,
                                                                out);
    }
  }
  return (int)cudaGetLastError();
}

// TP rows a block: a power of two with C * TP <= 8192 floats (32 KB of
// shared memory), between 8 and 1024; C at most 1024
extern "C" int awsm_channel_rows(const void* x, int bf16, int P, int C,
                                 float* out, cudaStream_t stream) {
  if (P > 0 && C > 0) {
    int TP = 1024;
    while (TP > 8 && C * TP > 8192) TP >>= 1;
    const size_t smem = (size_t)C * (TP + 1) * sizeof(float);
    channel_rows_kernel<<<(P + TP - 1) / TP, CR_THREADS, smem, stream>>>(
        x, bf16, P, C, TP, out);
  }
  return (int)cudaGetLastError();
}

extern "C" int awsm_onehot_split_rows(const int* rows, const float* table,
                                      int cap, int C, int P, float* out,
                                      cudaStream_t stream) {
  if (P > 0) {
    const int block = 256;
    onehot_split_rows_kernel<<<(P + block - 1) / block, block, 0, stream>>>(
        rows, table, cap, C, P, out);
  }
  return (int)cudaGetLastError();
}

extern "C" int awsm_gather_split_channels(const uint16_t* texels, int N,
                                          int row_cols, const int* idx, int M,
                                          int ncols, float* out,
                                          cudaStream_t stream) {
  if (M > 0) {
    const int block = 256;
    gather_split_kernel<<<(M + block - 1) / block, block, 0, stream>>>(
        texels, N, row_cols, idx, M, ncols, out);
  }
  return (int)cudaGetLastError();
}

extern "C" int awsm_gather_split_channels_f32(const float* table, int N,
                                              int row_cols, const int* idx,
                                              int M, int ncols, float* out,
                                              cudaStream_t stream) {
  if (M > 0) {
    const int block = 256;
    gather_split_f32_kernel<<<(M + block - 1) / block, block, 0, stream>>>(
        table, N, row_cols, idx, M, ncols, out);
  }
  return (int)cudaGetLastError();
}
