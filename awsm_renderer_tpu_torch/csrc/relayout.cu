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
// All three are pure data movement: bounded on the H100 by DRAM bandwidth
// (K3: 4 B read + 4*C B written per pixel, the table stays in L1/L2; K6:
// a 32 B row read and 64 B written per tap; K6-f32: a 16 B row read and
// 16 B written per refracted pixel). Simple and right first; vectorised
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

}  // namespace

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
