// K15: the vertex stage, one thread a triangle.
//
// awsm_vertex_stage does in one launch what ops/vertex.py
// vertex_stage_chain's op-by-op PyTorch chain does (~485 elementwise
// launches a call, ~1,090 with near-plane clipping, whatever the triangle
// count): the triangle's mesh-table row and this pass's mesh mask (rows
// outside the tables read zero, as onehot_gather); its three corners from
// the component-major (3C, T) pools, at an optional index (a compacted
// pool, or the animated subset); morph targets, the weighted sum of the
// mesh's live targets' deltas; skins, the weighted sum of the 4 *
// skin_sets joint matrices, whose upper 3x3 is the skinned normal matrix;
// the world and normal matrices, the view-projection (kernel arguments);
// the 2-slot near-plane clip; the screen mapping, facing swap, bbox,
// validity, edge planes with the canonical anchor, z plane and id of
// finish_setup. Each triangle's (NSETUP,) row, and with clipping its
// secondary piece's, go straight to the output: at the triangle's own
// position, or (scatter) at its pool row and T + its pool row, over the
// whole pool's rows; the optional tail past the rows is the raster's
// padding of invalid rows (ops/raster.py pad_setup_rows).
//
// It replaces no TPU kernel: XLA fused the reference's vertex stage
// (awsm_renderer_tpu/ops/vertex.py) and no pallas_call was needed. Its
// plain twin, ops/vertex.py vertex_stage_reference, runs the chain's own
// math on K15's inputs, with the morph and skin sums in K15's order
// (target by target, influence by influence). Every other expression
// follows the chain's operation order, built with -fmad=false, so each
// product and sum rounds like the chain's separate tensor ops; min, max
// and clamp propagate NaN like torch's. So every row is bit-equal to the
// twin's.
//
// What bounds it on the H100: bytes. A triangle reads 18 floats a corner
// (plus joints, weights and morph deltas when animated; the tables are
// L1/L2 resident) and writes 256 B a row, twice with clipping. Each
// thread stores its row as 16-byte pieces; a warp's rows are 256 B
// apart, so a store touches 32 half-sectors, which the L2 merges into
// whole lines. Staging rows through shared memory would coalesce the
// stores; the chain it replaces cost 6-20 ms of host time a frame, and
// that, not the device, bounds every frame.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// ops/vertex.py (tests/test_torch_vertex_fused.py holds these to it)
constexpr int S_E0A = 0;
constexpr int S_E0B = 1;
constexpr int S_E0C = 2;
constexpr int S_E1A = 3;
constexpr int S_E1B = 4;
constexpr int S_E1C = 5;
constexpr int S_E2A = 6;
constexpr int S_E2B = 7;
constexpr int S_E2C = 8;
constexpr int S_ZA = 9;
constexpr int S_ZB = 10;
constexpr int S_ZC = 11;
constexpr int S_IW0 = 12;
constexpr int S_IW1 = 13;
constexpr int S_IW2 = 14;
constexpr int S_BB_MINX = 15;
constexpr int S_BB_MINY = 16;
constexpr int S_BB_MAXX = 17;
constexpr int S_BB_MAXY = 18;
constexpr int S_MAT_ROW = 19;
constexpr int S_TANGENT_W = 20;
constexpr int S_UV0 = 21;
constexpr int S_ORIG_ID = 63;
constexpr int NSETUP = 64;
constexpr int NA = 15;
// core/meshes.py
constexpr int MI_TRANSFORM_ROW = 0;
constexpr int MI_MATERIAL_ROW = 1;
constexpr int MI_FLAGS = 2;
constexpr int MI_N_MORPH_TARGETS = 3;
constexpr int MI_MORPH_STRIDE = 4;
constexpr int MI_SKIN_SETS = 5;
constexpr int MESH_FLAG_DOUBLE_SIDED = 4;

// the chain's Python constants, rounded to f32 as torch rounds a scalar
constexpr float Z_EPS = (float)1e-6;
constexpr float BIG = (float)3.0e38;

constexpr int BLOCK = 128;
// a corner: clip x, y, z, w, then the NA attribute channels (uv0.uv,
// uv1.uv, colour rgba, world normal xyz, world tangent xyz, tangent w)
constexpr int NC = 4 + NA;

}  // namespace

// One field a line, in ops/vertex.py _VertexParams's order (a CPU test
// holds the two layouts together).
struct VertexParams {
  const float* pos;
  const float* nrm;
  const float* tang;
  const float* uv0;
  const float* uv1;
  const float* color;
  const int* joints;
  const float* weights;
  const int* morph_base;
  const int* tri_mesh;
  const int* index;
  const int* mesh_info;
  const uint8_t* mesh_mask;
  const float* morph_deltas;
  const float* morph_weights;
  const float* world;
  const float* normal_mat;
  const float* joint_matrices;
  float* out;
  int64_t ld;
  int n;
  int second;
  int scatter;
  int tail_row;
  int tail_rows;
  int n_mesh;
  int info_cols;
  int n_weight_rows;
  int morph_width;
  int n_deltas;
  int morph_cols;
  int n_tf;
  int n_joints;
  int joint_stride;
  int n_influences;
  int needs_clip;
  int has_morphs;
  int width;
  int height;
  float view_proj[16];
};

namespace {

// torch.minimum / torch.maximum / torch.clamp on the card
__device__ __forceinline__ float tmin(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

__device__ __forceinline__ float tmax(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

__device__ __forceinline__ float tclamp(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}

struct Corner {
  float v[NC];
};

__device__ __forceinline__ Corner pick3(int r, const Corner& a,
                                        const Corner& b, const Corner& c) {
  Corner o;
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    o.v[k] = r == 2 ? c.v[k] : (r == 1 ? b.v[k] : a.v[k]);
  }
  return o;
}

__device__ __forceinline__ Corner pick2(bool first, const Corner& a,
                                        const Corner& b) {
  Corner o;
#pragma unroll
  for (int k = 0; k < NC; ++k) o.v[k] = first ? a.v[k] : b.v[k];
  return o;
}

// vertex_stage_chain lerp_at: the point of p->q where clip z reaches
// Z_EPS, every channel lerped by the same t
__device__ __forceinline__ Corner lerp_at(const Corner& p, const Corner& q) {
  const float dz = q.v[2] - p.v[2];
  const float t =
      tclamp((Z_EPS - p.v[2]) / (fabsf(dz) > (float)1e-20 ? dz : 1.f), 0.f,
             1.f);
  Corner o;
#pragma unroll
  for (int k = 0; k < NC; ++k) o.v[k] = p.v[k] + t * (q.v[k] - p.v[k]);
  return o;
}

__device__ __forceinline__ void store_row(float* __restrict__ dst,
                                          const float (&r)[NSETUP]) {
  float4* d4 = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int q = 0; q < NSETUP / 4; ++q) {
    d4[q] = make_float4(r[4 * q], r[4 * q + 1], r[4 * q + 2], r[4 * q + 3]);
  }
}

// ops/vertex.py finish_setup for one output triangle
__device__ __forceinline__ void finish(const Corner& c0, const Corner& c1,
                                       const Corner& c2, bool act,
                                       float mat_row, int flags, float id,
                                       int width, int height,
                                       float* __restrict__ dst) {
  const Corner* cs[3] = {&c0, &c1, &c2};
  const bool double_sided = (flags & MESH_FLAG_DOUBLE_SIDED) != 0;
  float w[3], iw[3], sx[3], sy[3], z[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float* v = cs[c]->v;
    w[c] = v[3];
    iw[c] = 1.f / (fabsf(w[c]) > (float)1e-20 ? w[c] : (float)1e-20);
    sx[c] = (v[0] * iw[c] * 0.5f + 0.5f) * (float)width;
    sy[c] = (0.5f - v[1] * iw[c] * 0.5f) * (float)height;
    z[c] = v[2] * iw[c];
  }
  const float area2 =
      (sx[1] - sx[0]) * (sy[2] - sy[0]) - (sx[2] - sx[0]) * (sy[1] - sy[0]);
  const bool front = area2 < 0.f;
  const bool keep =
      (front || double_sided) && act && (fabsf(area2) > (float)1e-12);
  // front faces are CW in y-down screen space: swap corners 1 <-> 2
  const Corner& a1 = front ? c2 : c1;
  const Corner& a2 = front ? c1 : c2;
  if (front) {
    float t = sx[1]; sx[1] = sx[2]; sx[2] = t;
    t = sy[1]; sy[1] = sy[2]; sy[2] = t;
    t = z[1]; z[1] = z[2]; z[2] = t;
    t = iw[1]; iw[1] = iw[2]; iw[2] = t;
  }
  const float W = (float)width, H = (float)height;
  float bb_minx = tclamp(tmin(tmin(sx[0], sx[1]), sx[2]), 0.f, W);
  float bb_maxx = tclamp(tmax(tmax(sx[0], sx[1]), sx[2]), 0.f, W);
  float bb_miny = tclamp(tmin(tmin(sy[0], sy[1]), sy[2]), 0.f, H);
  float bb_maxy = tclamp(tmax(tmax(sy[0], sy[1]), sy[2]), 0.f, H);
  const bool on_screen = (bb_maxx > bb_minx) && (bb_maxy > bb_miny);
  const float zmin = tmin(tmin(z[0], z[1]), z[2]);
  const float zmax = tmax(tmax(z[0], z[1]), z[2]);
  const bool w_ok = (w[0] > 0.f) && (w[1] > 0.f) && (w[2] > 0.f);
  const bool valid =
      keep && on_screen && w_ok && (zmax >= 0.f) && (zmin <= 1.f);
  if (!valid) {
    bb_minx = BIG;
    bb_miny = BIG;
    bb_maxx = -BIG;
    bb_maxy = -BIG;
  }
  // edge i is opposite corner i; C anchored at the edge's canonical
  // endpoint (smaller (y, x))
  const float ea[3] = {sy[1] - sy[2], sy[2] - sy[0], sy[0] - sy[1]};
  const float eb[3] = {sx[2] - sx[1], sx[0] - sx[2], sx[1] - sx[0]};
  const int ei[3] = {1, 2, 0}, ej[3] = {2, 0, 1};
  float ec[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int i = ei[k], j = ej[k];
    const bool lt = (sy[i] < sy[j]) || ((sy[i] == sy[j]) && (sx[i] <= sx[j]));
    const float ax = lt ? sx[i] : sx[j];
    const float ay = lt ? sy[i] : sy[j];
    ec[k] = -(ea[k] * ax + eb[k] * ay);
  }
  if (!valid) ec[0] = -BIG;
  const float area_pos = front ? -area2 : area2;
  const float inv_area =
      1.f / (fabsf(area_pos) > (float)1e-30 ? area_pos : 1.f);
  float r[NSETUP];
  r[S_E0A] = ea[0];
  r[S_E0B] = eb[0];
  r[S_E0C] = ec[0];
  r[S_E1A] = ea[1];
  r[S_E1B] = eb[1];
  r[S_E1C] = ec[1];
  r[S_E2A] = ea[2];
  r[S_E2B] = eb[2];
  r[S_E2C] = ec[2];
  r[S_ZA] = (z[0] * ea[0] + z[1] * ea[1] + z[2] * ea[2]) * inv_area;
  r[S_ZB] = (z[0] * eb[0] + z[1] * eb[1] + z[2] * eb[2]) * inv_area;
  r[S_ZC] = (z[0] * ec[0] + z[1] * ec[1] + z[2] * ec[2]) * inv_area;
  r[S_IW0] = iw[0];
  r[S_IW1] = iw[1];
  r[S_IW2] = iw[2];
  r[S_BB_MINX] = bb_minx;
  r[S_BB_MINY] = bb_miny;
  r[S_BB_MAXX] = bb_maxx;
  r[S_BB_MAXY] = bb_maxy;
  r[S_MAT_ROW] = mat_row;
  r[S_TANGENT_W] = c0.v[4 + 14];
#pragma unroll
  for (int ch = 0; ch < 14; ++ch) {
    r[S_UV0 + 3 * ch] = c0.v[4 + ch];
    r[S_UV0 + 3 * ch + 1] = a1.v[4 + ch];
    r[S_UV0 + 3 * ch + 2] = a2.v[4 + ch];
  }
  r[S_ORIG_ID] = id;
  store_row(dst, r);
}

// the row pad_setup_rows appends: an empty bbox, every other column 0
__device__ __forceinline__ void tail_row(float* __restrict__ dst) {
  float r[NSETUP];
#pragma unroll
  for (int k = 0; k < NSETUP; ++k) r[k] = 0.f;
  r[S_BB_MINX] = BIG;
  r[S_BB_MINY] = BIG;
  r[S_BB_MAXX] = -BIG;
  r[S_BB_MAXY] = -BIG;
  store_row(dst, r);
}

// (T, 16) row-major matrix times (x, y, z, 1): _mat4_point
__device__ __forceinline__ void mat4_point(const float* m, const float* p,
                                           float* o) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    o[j] = m[4 * j] * p[0] + m[4 * j + 1] * p[1] + m[4 * j + 2] * p[2] +
           m[4 * j + 3];
  }
}

// (T, 9) row-major 3x3 times a vector: _mat3_vec
__device__ __forceinline__ void mat3_vec(const float* m, const float* v,
                                         float* o) {
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    o[j] = m[3 * j] * v[0] + m[3 * j + 1] * v[1] + m[3 * j + 2] * v[2];
  }
}

template <bool CLIP, bool MORPH, bool SKIN>
__global__ void __launch_bounds__(BLOCK)
    vertex_kernel(const VertexParams p) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i < p.tail_rows) {
    tail_row(p.out + ((int64_t)p.tail_row + i) * NSETUP);
  }
  if (i >= p.n) return;

  // ---- the triangle, its mesh row and pass mask --------------------------
  int col = i, tri, slot = i;
  float id, id2;
  if (p.index) {
    const int g = p.index[i];
    if (p.scatter && g < 0) return;
    col = g > 0 ? g : 0;
    tri = g >= 0 ? p.tri_mesh[col] : -1;
    id = id2 = (float)g;
    if (p.scatter) slot = g;
  } else {
    tri = p.tri_mesh[i];
    id = (float)i;
    id2 = (float)i + (float)p.second;
  }
  const int mesh = min(max(tri, 0), p.n_mesh - 1);
  const int* info = p.mesh_info + (int64_t)mesh * p.info_cols;
  const bool active = p.mesh_mask[mesh] != 0 && tri >= 0;
  const float mat_row = (float)info[MI_MATERIAL_ROW];
  const int flags = info[MI_FLAGS];
  const int tf = info[MI_TRANSFORM_ROW];
  const bool tf_ok = tf >= 0 && tf < p.n_tf;

  // ---- corners from the component-major pools ----------------------------
  const int64_t ld = p.ld;
  float pos[3][3], nrm[3][3], tng[3][4];
  Corner cn[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      pos[c][k] = p.pos[(3 * c + k) * ld + col];
      nrm[c][k] = p.nrm[(3 * c + k) * ld + col];
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) tng[c][k] = p.tang[(4 * c + k) * ld + col];
    float* a = cn[c].v + 4;
    a[0] = p.uv0[(2 * c) * ld + col];
    a[1] = p.uv0[(2 * c + 1) * ld + col];
    a[2] = p.uv1[(2 * c) * ld + col];
    a[3] = p.uv1[(2 * c + 1) * ld + col];
#pragma unroll
    for (int k = 0; k < 4; ++k) a[4 + k] = p.color[(4 * c + k) * ld + col];
    a[14] = tng[c][3];
  }

  // ---- morph targets: the mesh's live targets, one at a time --------------
  if (MORPH) {
    const int n_t = min(info[MI_N_MORPH_TARGETS], p.morph_width);
    const int64_t stride = info[MI_MORPH_STRIDE];
    const float* wrow = mesh < p.n_weight_rows
                            ? p.morph_weights + (int64_t)mesh * p.morph_width
                            : nullptr;
    const int64_t last = (p.n_deltas > 1 ? p.n_deltas : 1) - 1;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float acc[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) acc[k] = 0.f;
      const int64_t base = p.morph_base[c * ld + col];
      if (base >= 0) {
        for (int m = 0; m < n_t; ++m) {
          int64_t row = base + (int64_t)m * stride;
          row = row < 0 ? 0 : (row > last ? last : row);
          const float wm = wrow ? wrow[m] : 0.f;
          const float* d = p.morph_deltas + row * p.morph_cols;
#pragma unroll
          for (int k = 0; k < 9; ++k) acc[k] = acc[k] + wm * d[k];
        }
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        pos[c][k] = pos[c][k] + acc[k];
        nrm[c][k] = nrm[c][k] + acc[3 + k];
        tng[c][k] = tng[c][k] + acc[6 + k];
      }
    }
  }

  // ---- world and normal matrices, skins ------------------------------------
  float node_world[16], node_nmat[9];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    node_world[k] = tf_ok ? p.world[(int64_t)tf * 16 + k] : 0.f;
  }
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    node_nmat[k] = tf_ok ? p.normal_mat[(int64_t)tf * 9 + k] : 0.f;
  }
  const bool skinned = SKIN && info[MI_SKIN_SETS] > 0;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float model[16], tmat[9], nmat[9];
    if (skinned) {
#pragma unroll
      for (int k = 0; k < 16; ++k) model[k] = 0.f;
      for (int s = 0; s < p.n_influences; ++s) {
        const int64_t r = (int64_t)(c * p.joint_stride + s) * ld + col;
        const int j = min(max(p.joints[r], 0), p.n_joints - 1);
        const float wj = p.weights[r];
        const float* jm = p.joint_matrices + (int64_t)j * 16;
#pragma unroll
        for (int k = 0; k < 16; ++k) model[k] = model[k] + jm[k] * wj;
      }
    } else {
#pragma unroll
      for (int k = 0; k < 16; ++k) model[k] = node_world[k];
    }
#pragma unroll
    for (int rr = 0; rr < 3; ++rr) {
#pragma unroll
      for (int k = 0; k < 3; ++k) tmat[3 * rr + k] = model[4 * rr + k];
    }
    // the skinned normal matrix is the skin matrix's upper-left 3x3
#pragma unroll
    for (int k = 0; k < 9; ++k) nmat[k] = skinned ? tmat[k] : node_nmat[k];
    float wp[4];
    mat4_point(model, pos[c], wp);
    const float* vp = p.view_proj;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      cn[c].v[j] = wp[0] * vp[4 * j] + wp[1] * vp[4 * j + 1] +
                   wp[2] * vp[4 * j + 2] + wp[3] * vp[4 * j + 3];
    }
    mat3_vec(nmat, nrm[c], cn[c].v + 4 + 8);
    mat3_vec(tmat, tng[c], cn[c].v + 4 + 11);
  }

  float* out = p.out;
  if (!CLIP) {
    finish(cn[0], cn[1], cn[2], active, mat_row, flags, id, p.width,
           p.height, out + (int64_t)slot * NSETUP);
    return;
  }

  // ---- near-plane clipping (z_clip >= eps; [0, 1] depth) --------------------
  const bool in0 = cn[0].v[2] > Z_EPS, in1 = cn[1].v[2] > Z_EPS,
             in2 = cn[2].v[2] > Z_EPS;
  const int n_in = (int)in0 + (int)in1 + (int)in2;
  const int first_in = in0 ? 0 : (in1 ? 1 : 2);
  const int first_out = !in0 ? 0 : (!in1 ? 1 : 2);
  const int rot =
      (n_in == 1 ? first_in : (n_in == 2 ? first_out + 1 : 0)) % 3;
  const Corner a = pick3(rot, cn[0], cn[1], cn[2]);
  const Corner b = pick3(rot, cn[1], cn[2], cn[0]);
  const Corner c = pick3(rot, cn[2], cn[0], cn[1]);
  const bool one_in = n_in == 1, two_in = n_in == 2;
  const Corner i_bc = lerp_at(b, c);
  const Corner i_ac = lerp_at(a, c);
  {
    const Corner p1 = one_in ? lerp_at(a, b) : b;
    const Corner p2 = pick2(one_in, i_ac, pick2(two_in, i_bc, c));
    finish(a, p1, p2, active && n_in > 0, mat_row, flags, id, p.width,
           p.height, out + (int64_t)slot * NSETUP);
  }
  finish(a, i_bc, i_ac, active && two_in, mat_row, flags, id2, p.width,
         p.height, out + ((int64_t)p.second + slot) * NSETUP);
}

template <bool CLIP, bool MORPH, bool SKIN>
void launch(const VertexParams& p, int threads, cudaStream_t stream) {
  vertex_kernel<CLIP, MORPH, SKIN>
      <<<(threads + BLOCK - 1) / BLOCK, BLOCK, 0, stream>>>(p);
}

}  // namespace

extern "C" int awsm_vertex_stage(const VertexParams* params,
                                 cudaStream_t stream) {
  const VertexParams& p = *params;
  const int threads = p.n > p.tail_rows ? p.n : p.tail_rows;
  if (threads > 0) {
    const bool skin = p.n_influences > 0;
    switch ((p.needs_clip ? 4 : 0) | (p.has_morphs ? 2 : 0) | (skin ? 1 : 0)) {
      case 0: launch<false, false, false>(p, threads, stream); break;
      case 1: launch<false, false, true>(p, threads, stream); break;
      case 2: launch<false, true, false>(p, threads, stream); break;
      case 3: launch<false, true, true>(p, threads, stream); break;
      case 4: launch<true, false, false>(p, threads, stream); break;
      case 5: launch<true, false, true>(p, threads, stream); break;
      case 6: launch<true, true, false>(p, threads, stream); break;
      default: launch<true, true, true>(p, threads, stream); break;
    }
  }
  return (int)cudaGetLastError();
}
