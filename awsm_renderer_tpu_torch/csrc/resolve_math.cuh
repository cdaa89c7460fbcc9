// The per-pixel attribute reconstruction shared by K2 (resolve.cu) and
// K7/K8 (binned.cu): the reference's _resolve_math / _flush_planes.
//
// From a winner triangle's 64-float setup row at the pixel centre:
// perspective-correct barycentrics, uv0/uv1/colour/normal/tangent
// interpolation, flat mat_row and tangent_w, uv0 screen derivatives.
// Every product and sum is an explicit __fmul_rn/__fadd_rn/__fsub_rn in
// the reference's order (and the files are built with -fmad=false), so
// the kernels round like their plain PyTorch twins.

#pragma once

#include <cuda_runtime.h>

namespace awsm {

constexpr int NSETUP = 64;
constexpr int NRESOLVE = 20;  // float planes after tri_id, RESOLVE_NAMES order
// layout flags of a fat plane set (ops/raster.py plane_layout)
constexpr int HAS_UV1 = 1, HAS_COLOR = 2, HAS_DERIVS = 4;
// setup row indices (ops/vertex.py)
constexpr int S_E0A = 0, S_E1A = 3, S_E2A = 6, S_IW0 = 12, S_MAT_ROW = 19;
constexpr int S_TANGENT_W = 20, S_UV0 = 21, S_UV1 = 27, S_COLOR = 33;
constexpr int S_NORMAL = 45, S_TANGENT = 54, S_ORIG_ID = 63;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0,
                                      float b1, float b2) {
  return add(add(mul(a0, b0), mul(a1, b1)), mul(a2, b2));
}

// Slot of resolve plane k (RESOLVE_NAMES[1:] order) among the float
// planes after depth, in a layout without the untaken uv1 / colour /
// derivative groups; -1 when plane k is not in the layout.
__device__ __forceinline__ int plane_slot(int k, int flags) {
  const bool uv1 = flags & HAS_UV1, color = flags & HAS_COLOR;
  if ((k == 3 || k == 4) && !uv1) return -1;
  if (k >= 5 && k < 9 && !color) return -1;
  if (k >= 16 && !(flags & HAS_DERIVS)) return -1;
  return k - (k >= 5 && !uv1 ? 2 : 0) - (k >= 9 && !color ? 4 : 0);
}

// Emits emit(k, value) for k = 0..NRESOLVE-1 in RESOLVE_NAMES[1:] order:
// mat_row, uv0 u/v, uv1 u/v, colour rgba, normal xyz, tangent xyz,
// tangent_w, du0_dx, dv0_dx, du0_dy, dv0_dy. `r` points at the row.
template <typename Emit>
__device__ __forceinline__ void resolve_math(const float* __restrict__ r,
                                             float px, float py, Emit emit) {
  float pb[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int a = S_E0A + 3 * k;
    const float e = add(mul(r[a], px), add(mul(r[a + 1], py), r[a + 2]));
    pb[k] = mul(e, r[S_IW0 + k]);
  }
  const float denom = add(add(pb[0], pb[1]), pb[2]);
  const float inv_denom = 1.0f / (fabsf(denom) > 1e-30f ? denom : 1.0f);
  const float pn0 = mul(pb[0], inv_denom), pn1 = mul(pb[1], inv_denom);
  const float pn2 = mul(pb[2], inv_denom);
  auto interp = [&](int row) {
    return dot3(pn0, pn1, pn2, r[row], r[row + 1], r[row + 2]);
  };
  emit(0, r[S_MAT_ROW]);
  emit(1, interp(S_UV0));
  emit(2, interp(S_UV0 + 3));
  emit(3, interp(S_UV1));
  emit(4, interp(S_UV1 + 3));
#pragma unroll
  for (int c = 0; c < 4; ++c) emit(5 + c, interp(S_COLOR + 3 * c));
#pragma unroll
  for (int c = 0; c < 3; ++c) emit(9 + c, interp(S_NORMAL + 3 * c));
#pragma unroll
  for (int c = 0; c < 3; ++c) emit(12 + c, interp(S_TANGENT + 3 * c));
  emit(15, r[S_TANGENT_W]);

  // uv0 screen derivatives: d(e_i)/dx = A_i, d(e_i)/dy = B_i
  const float a0 = r[S_E0A], a1 = r[S_E1A], a2 = r[S_E2A];
  const float b0 = r[S_E0A + 1], b1 = r[S_E1A + 1], b2 = r[S_E2A + 1];
  const float iw0 = r[S_IW0], iw1 = r[S_IW0 + 1], iw2 = r[S_IW0 + 2];
  const float dD_dx = dot3(a0, a1, a2, iw0, iw1, iw2);
  const float dD_dy = dot3(b0, b1, b2, iw0, iw1, iw2);
  const float dx0 = mul(inv_denom, sub(mul(a0, iw0), mul(pn0, dD_dx)));
  const float dx1 = mul(inv_denom, sub(mul(a1, iw1), mul(pn1, dD_dx)));
  const float dx2 = mul(inv_denom, sub(mul(a2, iw2), mul(pn2, dD_dx)));
  const float dy0 = mul(inv_denom, sub(mul(b0, iw0), mul(pn0, dD_dy)));
  const float dy1 = mul(inv_denom, sub(mul(b1, iw1), mul(pn1, dD_dy)));
  const float dy2 = mul(inv_denom, sub(mul(b2, iw2), mul(pn2, dD_dy)));
  const float* u = r + S_UV0;
  const float* v = r + S_UV0 + 3;
  emit(16, dot3(dx0, dx1, dx2, u[0], u[1], u[2]));
  emit(17, dot3(dx0, dx1, dx2, v[0], v[1], v[2]));
  emit(18, dot3(dy0, dy1, dy2, u[0], u[1], u[2]));
  emit(19, dot3(dy0, dy1, dy2, v[0], v[1], v[2]));
}

}  // namespace awsm
