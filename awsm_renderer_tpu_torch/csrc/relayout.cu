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
// this is a widening copy, four values a thread per step (16-byte stores).
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
// and written once as f32). Simple and right first; vectorised
// 16 B loads and stores are later work.

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

// vec: x (and out) aligned for 4-value vector accesses; the tail past the
// last whole group of 4, or everything when not aligned, goes one by one
__global__ void split_rows_kernel(const void* __restrict__ x, int bf16,
                                  int vec, size_t n, float* __restrict__ out) {
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  const size_t i0 = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t n4 = vec ? n / 4 : 0;
  float4* out4 = reinterpret_cast<float4*>(out);
  if (bf16) {
    const uint2* x4 = static_cast<const uint2*>(x);  // 4 bf16 values
    for (size_t i = i0; i < n4; i += stride) {
      const uint2 v = x4[i];
      out4[i] = make_float4(__uint_as_float(v.x << 16),
                            __uint_as_float(v.x & 0xffff0000u),
                            __uint_as_float(v.y << 16),
                            __uint_as_float(v.y & 0xffff0000u));
    }
  } else {
    const float4* x4 = static_cast<const float4*>(x);
    for (size_t i = i0; i < n4; i += stride) out4[i] = x4[i];
  }
  for (size_t i = 4 * n4 + i0; i < n; i += stride) {
    out[i] = load_f32(x, i, bf16);
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
    const int vec = (uintptr_t)x % (bf16 ? 8 : 16) == 0;
    const int block = 256;
    const size_t want = (n / 4 + block - 1) / block;
    const int grid = (int)(want < 1 ? 1 : want < 65535 ? want : 65535);
    split_rows_kernel<<<grid, block, 0, stream>>>(x, bf16, vec, n, out);
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
