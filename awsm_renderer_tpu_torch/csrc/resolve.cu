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
// zero planes; tri_id is the raster column itself. Pixel centres come
// from the flat index, (x * coord_scale + 0.5, (y + row_offset) *
// coord_scale + 0.5) (coord_scale 2: ids taken at the top-left sample of
// the MSAA raster at twice the resolution; the reference's
// awsm_renderer_tpu/ops/shade.py:469-476), or from explicit px/py planes
// (the covered-tile-compacted opaque shade).
//
// The math lives in resolve_math.cuh (shared with K7/K8): explicit
// __fmul_rn/__fadd_rn/__fsub_rn in the reference's order, built with
// -fmad=false, so the kernel rounds like the plain PyTorch twin.
//
// What bounds it on the H100: the scattered 256-byte row read per pixel
// (about 1 row gather + 80 B of plane writes per pixel; ~0.7 GB/frame of
// DRAM traffic at 1080p if the rows miss L2). Simple and right first;
// staging rows through shared memory by tile is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "resolve_math.cuh"

namespace {

using awsm::NRESOLVE;
using awsm::NSETUP;

__global__ void resolve_kernel(const int* __restrict__ tid,
                               const float* __restrict__ setup, int T, int P,
                               int width, int row_offset, int coord_scale,
                               const float* __restrict__ px_in,
                               const float* __restrict__ py_in,
                               int* __restrict__ out_tid,
                               float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P) return;
  const int t = tid[i];
  if (t < 0) {
    out_tid[i] = -1;
#pragma unroll
    for (int k = 0; k < NRESOLVE; ++k) out[(size_t)k * P + i] = 0.f;
    return;
  }
  const float* row = setup + (size_t)min(t, T - 1) * NSETUP;
  const float scale = (float)coord_scale;
  const float px = px_in ? px_in[i]
                         : awsm::add(awsm::mul((float)(i % width), scale), 0.5f);
  const float py =
      py_in ? py_in[i]
            : awsm::add(awsm::mul((float)(i / width + row_offset), scale),
                        0.5f);
  awsm::resolve_math(row, px, py, [&](int k, float v) {
    out[(size_t)k * P + i] = v;
  });
  out_tid[i] = t;
}

}  // namespace

extern "C" int awsm_resolve(const int* tid, const float* setup, int T, int P,
                            int width, int row_offset, int coord_scale,
                            const float* px, const float* py, int* out_tid,
                            float* out_planes, cudaStream_t stream) {
  if (P > 0) {
    const int block = 256;
    resolve_kernel<<<(P + block - 1) / block, block, 0, stream>>>(
        tid, setup, T, P, width, row_offset, coord_scale, px, py, out_tid,
        out_planes);
  }
  return (int)cudaGetLastError();
}
