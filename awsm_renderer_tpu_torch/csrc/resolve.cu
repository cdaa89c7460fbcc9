// K2: attribute resolve. Winner setup column per pixel -> 21 G-buffer
// planes (RESOLVE_NAMES in ops/shade.py).
//
// Replaces the TPU kernel awsm_renderer_tpu/ops/shade.py::
// resolve_planes_fused (pallas_call at shade.py:499). The TPU version
// gathers each winner row as two bf16 halves (a TPU gather-speed trick);
// here one thread per pixel reads its winner's 64-float setup row in f32
// and evaluates _resolve_math at the pixel center: perspective-correct
// barycentrics, uv0/uv1/colour/normal/tangent interpolation, flat mat_row
// and tangent_w, uv0 screen derivatives. A miss writes tri_id = -1 and
// zero planes; tri_id is the raster column itself.
//
// Every product and sum is an explicit __fmul_rn/__fadd_rn/__fsub_rn in
// the reference's order and the file is built with -fmad=false, so the
// kernel rounds like the plain PyTorch twin.
//
// What bounds it on the H100: the scattered 256-byte row read per pixel
// (about 1 row gather + 80 B of plane writes per pixel; ~0.7 GB/frame of
// DRAM traffic at 1080p if the rows miss L2). Simple and right first;
// staging rows through shared memory by tile is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NSETUP = 64;
constexpr int NOUT = 20;  // float planes after tri_id
// setup row indices (ops/vertex.py)
constexpr int S_E0A = 0, S_E1A = 3, S_E2A = 6, S_IW0 = 12, S_MAT_ROW = 19;
constexpr int S_TANGENT_W = 20, S_UV0 = 21, S_UV1 = 27, S_COLOR = 33;
constexpr int S_NORMAL = 45, S_TANGENT = 54;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0,
                                      float b1, float b2) {
  return add(add(mul(a0, b0), mul(a1, b1)), mul(a2, b2));
}

__global__ void resolve_kernel(const int* __restrict__ tid,
                               const float* __restrict__ setup, int T, int P,
                               int width, int row_offset,
                               int* __restrict__ out_tid,
                               float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P) return;
  const int t = tid[i];
  if (t < 0) {
    out_tid[i] = -1;
#pragma unroll
    for (int k = 0; k < NOUT; ++k) out[(size_t)k * P + i] = 0.f;
    return;
  }
  const float* ch = setup + (size_t)min(t, T - 1) * NSETUP;
  float r[NSETUP];
#pragma unroll
  for (int k = 0; k < NSETUP; ++k) r[k] = ch[k];

  const float px = add((float)(i % width), 0.5f);
  const float py = add((float)(i / width + row_offset), 0.5f);

  float e[3], pb[3], pn[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int a = S_E0A + 3 * k;
    e[k] = add(mul(r[a], px), add(mul(r[a + 1], py), r[a + 2]));
    pb[k] = mul(e[k], r[S_IW0 + k]);
  }
  const float denom = add(add(pb[0], pb[1]), pb[2]);
  const float inv_denom = 1.0f / (fabsf(denom) > 1e-30f ? denom : 1.0f);
#pragma unroll
  for (int k = 0; k < 3; ++k) pn[k] = mul(pb[k], inv_denom);

  auto interp = [&](int row) {
    return dot3(pn[0], pn[1], pn[2], r[row], r[row + 1], r[row + 2]);
  };
  float o[NOUT];
  o[0] = r[S_MAT_ROW];
  o[1] = interp(S_UV0);
  o[2] = interp(S_UV0 + 3);
  o[3] = interp(S_UV1);
  o[4] = interp(S_UV1 + 3);
#pragma unroll
  for (int c = 0; c < 4; ++c) o[5 + c] = interp(S_COLOR + 3 * c);
#pragma unroll
  for (int c = 0; c < 3; ++c) o[9 + c] = interp(S_NORMAL + 3 * c);
#pragma unroll
  for (int c = 0; c < 3; ++c) o[12 + c] = interp(S_TANGENT + 3 * c);
  o[15] = r[S_TANGENT_W];

  // uv0 screen derivatives: d(e_i)/dx = A_i, d(e_i)/dy = B_i
  const float a0 = r[S_E0A], a1 = r[S_E1A], a2 = r[S_E2A];
  const float b0 = r[S_E0A + 1], b1 = r[S_E1A + 1], b2 = r[S_E2A + 1];
  const float iw0 = r[S_IW0], iw1 = r[S_IW0 + 1], iw2 = r[S_IW0 + 2];
  const float dD_dx = dot3(a0, a1, a2, iw0, iw1, iw2);
  const float dD_dy = dot3(b0, b1, b2, iw0, iw1, iw2);
  const float dx0 = mul(inv_denom, sub(mul(a0, iw0), mul(pn[0], dD_dx)));
  const float dx1 = mul(inv_denom, sub(mul(a1, iw1), mul(pn[1], dD_dx)));
  const float dx2 = mul(inv_denom, sub(mul(a2, iw2), mul(pn[2], dD_dx)));
  const float dy0 = mul(inv_denom, sub(mul(b0, iw0), mul(pn[0], dD_dy)));
  const float dy1 = mul(inv_denom, sub(mul(b1, iw1), mul(pn[1], dD_dy)));
  const float dy2 = mul(inv_denom, sub(mul(b2, iw2), mul(pn[2], dD_dy)));
  const float* u = r + S_UV0;
  const float* v = r + S_UV0 + 3;
  o[16] = dot3(dx0, dx1, dx2, u[0], u[1], u[2]);
  o[17] = dot3(dx0, dx1, dx2, v[0], v[1], v[2]);
  o[18] = dot3(dy0, dy1, dy2, u[0], u[1], u[2]);
  o[19] = dot3(dy0, dy1, dy2, v[0], v[1], v[2]);

  out_tid[i] = t;
#pragma unroll
  for (int k = 0; k < NOUT; ++k) out[(size_t)k * P + i] = o[k];
}

}  // namespace

extern "C" int awsm_resolve(const int* tid, const float* setup, int T, int P,
                            int width, int row_offset, int* out_tid,
                            float* out_planes, cudaStream_t stream) {
  if (P > 0) {
    const int block = 256;
    resolve_kernel<<<(P + block - 1) / block, block, 0, stream>>>(
        tid, setup, T, P, width, row_offset, out_tid, out_planes);
  }
  return (int)cudaGetLastError();
}
