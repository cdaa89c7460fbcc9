// K14: the surface shade after the texture taps, one thread a pixel.
//
// awsm_shade_surface does in one launch what ops/shade.py shade_surface's
// op-by-op PyTorch chain does after K5 (700-1,500 elementwise launches a
// call on the 1080p frames): the world position and view ray from the
// pixel's flat index and band geometry (or its ndc_x / ndc_y planes); the
// material's float parameters and flags read straight from the material
// tables by mat_row; base colour, metallic-roughness, occlusion, emissive,
// specular and specular colour from K5's tap block (white where the
// pixel's material binds no texture in the slot); normal mapping and the
// facing flip; f0 from IOR and specular; the dense punctual loop over the
// light table's first n_lights rows (directional, point with its range
// window, spot); the environment: a solid one's colours as arguments, or
// an image one's irradiance, two prefiltered levels lerped by roughness
// and, on the opaque pass's misses, the sky, each a bilinear tap whose
// cube-face address and weights the thread computes and whose 32-byte bf16
// row it reads from the texel pool at env_base (K6's gather, fused); the
// split-sum fit, the ambient term, emissive, unlit, alpha per alpha mode;
// the normals view; the opaque pass's sky on a miss; the transparent
// pass's editor-grid alpha and transmission factor.
//
// Its scope is the chain's calls with no material extension, the plain or
// the normals view and the dense light loop (ops/shade.py
// _in_k14_scope); the chain keeps the rest. Its plain twin,
// shade_surface_fused_reference, runs the chain's own math (_shade_math)
// on K14's inputs. Every expression here follows the chain's operation
// order, built with -fmad=false, so each product and sum rounds like the
// chain's separate tensor ops; only expf, logf, exp2f and powf may differ
// from the CPU's by an ulp. Min/max/clamp propagate NaN like torch's.
//
// What bounds it on the H100: bytes. A pixel reads its G-buffer planes
// (tri_id, depth, mat_row, normal, and tangent with a normal map, colour
// and ndc when present), 4 B a tapped channel, its material row and light
// rows (L1/L2 resident) and, with an image environment, three 32-byte env
// rows (four on a sky pixel), and writes rgb + alpha (16 B) and on the
// transparent pass the transmission factor (12 B). Slot and mode flags
// are runtime values, uniform across the launch, so one instantiation
// serves every bucket.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// core/materials.py (tests/test_torch_shade_fused.py holds these to it)
constexpr int NUM_F32 = 48;
constexpr int NUM_TEX_SLOTS = 20;
constexpr int NUM_I32 = 8;
constexpr int MF_BASE_COLOR = 0;
constexpr int MF_METALLIC = 4;
constexpr int MF_ROUGHNESS = 5;
constexpr int MF_NORMAL_SCALE = 6;
constexpr int MF_OCCLUSION_STRENGTH = 7;
constexpr int MF_EMISSIVE = 8;
constexpr int MF_EMISSIVE_STRENGTH = 11;
constexpr int MF_ALPHA_CUTOFF = 12;
constexpr int MF_IOR = 13;
constexpr int MF_THICKNESS = 22;
constexpr int MF_ATTENUATION_DISTANCE = 23;
constexpr int MF_ATTENUATION_COLOR = 24;
constexpr int MF_SPECULAR_COLOR = 27;
constexpr int MF_SPECULAR = 30;
constexpr int MF_GRID_SPACING = 44;
constexpr int MF_GRID_MAJOR_EVERY = 45;
constexpr int MF_GRID_FADE_DISTANCE = 46;
constexpr int TS_BASE_COLOR = 0;
constexpr int TS_METALLIC_ROUGHNESS = 1;
constexpr int TS_NORMAL = 2;
constexpr int TS_OCCLUSION = 3;
constexpr int TS_EMISSIVE = 4;
constexpr int TS_SPECULAR = 12;
constexpr int TS_SPECULAR_COLOR = 13;
constexpr int MI_KIND = 0;
constexpr int MI_ALPHA_MODE = 1;
constexpr int KIND_UNLIT = 1;
constexpr int KIND_GRID = 2;
// core/lights.py
constexpr int LIGHT_F32 = 16;
constexpr int L_KIND = 0;
constexpr int L_COLOR = 1;
constexpr int L_INTENSITY = 4;
constexpr int L_POSITION = 5;
constexpr int L_DIRECTION = 8;
constexpr int L_RANGE = 11;
constexpr int L_INNER_COS = 12;
constexpr int L_OUTER_COS = 13;
// core/textures.py: bf16 columns of a texel-pool row
constexpr int TEXEL_COLS = 64;

// the tapped slots K14 reads, in the order of ShadeParams::tap
// (ops/shade.py K14_SLOTS)
enum { T_BASE, T_MR, T_NORMAL, T_OCCLUSION, T_EMISSIVE, T_SPECULAR,
       T_SPECULAR_COLOR, N_TAPPED };

// the chain's Python constants, rounded to f32 as torch rounds a scalar
constexpr float EPS = (float)1e-6;
constexpr float PI_F = (float)3.14159265358979323846;
constexpr float INV_PI = (float)(1.0 / 3.14159265358979323846);

}  // namespace

// One field a line, in ops/shade.py _ShadeParams's order (a CPU test
// holds the two layouts together).
struct ShadeParams {
  const int* tri_id;
  const float* depth;
  const float* mat_row;
  const float* normal[3];
  const float* tangent[4];
  const float* color[4];
  const float* ndc[2];
  const float* taps;
  int64_t tap_stride;
  int tap[7];
  const float* mat_float;
  const int* mat_tex;
  const int* mat_flags;
  int mat_cap;
  const float* lights;
  int n_lights;
  const uint16_t* texels;
  int n_texels;
  int env_base;
  int sky_size;
  int irr_size;
  int pref_size;
  int pref_levels;
  float solid[9];
  float inv_view_proj[16];
  float cam_pos[3];
  int P;
  int width;
  int height;
  int height_full;
  int width_full;
  int row_offset;
  int col_offset;
  int n_layer_tiles;
  int transparent;
  int want_sky;
  int normals_view;
  float* out;
  float* trans;
};

namespace {

__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}

__device__ __forceinline__ float clamp_max(float x, float hi) {
  return x > hi ? hi : x;
}

__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  return clamp_max(clamp_min(x, lo), hi);
}

__device__ __forceinline__ float maxp(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float minp(float a, float b) {
  return (a < b || a != a) ? a : b;
}

__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

__device__ __forceinline__ void norm3(float* a) {
  const float inv = 1.f / clamp_min(sqrtf(dot3(a, a)), EPS);
  a[0] = a[0] * inv;
  a[1] = a[1] * inv;
  a[2] = a[2] * inv;
}

// ops/brdf.py d_ggx * v_smith_ggx_correlated
__device__ __forceinline__ float specular_ggx(float n_dot_l, float n_dot_v,
                                              float n_dot_h, float ar) {
  const float a2 = ar * ar;
  const float f = n_dot_h * n_dot_h * (a2 - 1.f) + 1.f;
  const float d = a2 / clamp_min(f * PI_F * f, EPS);
  const float gv =
      n_dot_l * sqrtf(clamp_min(n_dot_v * n_dot_v * (1.f - a2) + a2, EPS));
  const float gl =
      n_dot_v * sqrtf(clamp_min(n_dot_l * n_dot_l * (1.f - a2) + a2, EPS));
  return d * ((1.f / clamp_min(gv + gl, EPS)) * 0.5f);
}

// ops/shade.py _one_light: one row of the light table into total
__device__ __forceinline__ void one_light(const float* L, const float* pos,
                                          const float* n, const float* v,
                                          const float* c_diff,
                                          const float* f0, float ar,
                                          float n_dot_v, float* total) {
  const float kind = L[L_KIND];
  const bool is_dir = kind == 0.f;
  float tl[3];
  for (int k = 0; k < 3; ++k) {
    tl[k] = is_dir ? -L[L_DIRECTION + k] : L[L_POSITION + k] - pos[k];
  }
  const float dist = sqrtf(dot3(tl, tl));
  const float inv_d = 1.f / clamp_min(dist, EPS);
  float l[3] = {tl[0] * inv_d, tl[1] * inv_d, tl[2] * inv_d};
  float rad = clamp_min(dot3(n, l), 0.f);
  const float n_dot_l = rad;
  if (!is_dir) {
    rad = rad * (1.f / clamp_min(dist * dist, EPS));
    const float lrange = L[L_RANGE];
    if (lrange > 0.f) {
      const float ratio = dist / (lrange >= EPS ? lrange : EPS);
      const float w = clamp(1.f - powf(ratio, 4.f), 0.f, 1.f);
      rad = rad * (w * w);
    }
  }
  if (kind == 2.f) {
    const float cd = -(l[0] * L[L_DIRECTION] + l[1] * L[L_DIRECTION + 1] +
                       l[2] * L[L_DIRECTION + 2]);
    float den = L[L_INNER_COS] - L[L_OUTER_COS];
    den = den >= (float)1e-4 ? den : (float)1e-4;
    rad = rad * clamp((cd - L[L_OUTER_COS]) / den, 0.f, 1.f);
  }
  rad = rad * L[L_INTENSITY];
  float h[3] = {l[0] + v[0], l[1] + v[1], l[2] + v[2]};
  norm3(h);
  const float n_dot_h = clamp_min(dot3(n, h), 0.f);
  const float v_dot_h = clamp_min(dot3(v, h), 0.f);
  const float w5 = powf(clamp(1.f - v_dot_h, 0.f, 1.f), 5.f);
  const float spec = specular_ggx(n_dot_l, n_dot_v, n_dot_h, ar);
  for (int c = 0; c < 3; ++c) {
    const float f = f0[c] + (1.f - f0[c]) * w5;
    const float lobe = c_diff[c] * INV_PI * (1.f - f) + spec * f;
    total[c] = total[c] + L[L_COLOR + c] * rad * lobe;
  }
}

// ops/cubemap.py _bilinear_setup_c + the K6 gather + _blend_quads_c: one
// bilinear tap of the S x S cube map whose rows start at base_row of the
// texel pool, in direction d -> rgba
__device__ __forceinline__ void env_tap(const ShadeParams& p, int base_row,
                                        int S, const float* d, float* out) {
  const float x = d[0], y = d[1], z = d[2];
  const float ax = fabsf(x), ay = fabsf(y), az = fabsf(z);
  const bool is_x = (ax >= ay) && (ax >= az);
  const bool is_y = !is_x && (ay >= az);
  const int face = is_x ? (x > 0.f ? 0 : 1)
                        : (is_y ? (y > 0.f ? 2 : 3) : (z > 0.f ? 4 : 5));
  const float ma = clamp_min(is_x ? ax : (is_y ? ay : az), (float)1e-12);
  const float sc = is_x ? (x > 0.f ? -z : z) : (is_y ? x : (z > 0.f ? x : -x));
  const float tc = is_y ? (y > 0.f ? z : -z) : -y;
  const float u = (sc / ma + 1.f) * 0.5f;
  const float v = (tc / ma + 1.f) * 0.5f;
  const float X = clamp(u * (float)S - 0.5f, 0.f, (float)(S - 1));
  const float Y = clamp(v * (float)S - 0.5f, 0.f, (float)(S - 1));
  const float x0 = floorf(X), y0 = floorf(Y);
  const float fx = X - x0, fy = Y - y0;
  int r = base_row + (face * (S * S) + (int)y0 * S + (int)x0);
  r = min(max(r, 0), p.n_texels - 1);
  const uint4* src =
      reinterpret_cast<const uint4*>(p.texels + (size_t)r * TEXEL_COLS);
  const uint4 a = __ldg(src), b = __ldg(src + 1);
  const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  float q[16];
  for (int j = 0; j < 8; ++j) {
    q[2 * j] = __uint_as_float(w[j] << 16);
    q[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
  const float w00 = (1.f - fx) * (1.f - fy), w10 = fx * (1.f - fy);
  const float w01 = (1.f - fx) * fy, w11 = fx * fy;
  for (int c = 0; c < 4; ++c) {
    out[c] = q[c] * w00 + q[4 + c] * w10 + q[8 + c] * w01 + q[12 + c] * w11;
  }
}

// the editor grid's line coverage at world coordinate x (ops/shade.py
// _shade_math line_alpha); torch.remainder(a, 1) is fmod plus one below 0
__device__ __forceinline__ float line_alpha(float x, float sp, float wdt) {
  float m = fmodf(x / sp + 0.5f, 1.f);
  if (m != 0.f && m < 0.f) m = m + 1.f;
  const float d = fabsf(m - 0.5f) * sp;
  return clamp(1.f - (d - wdt) / clamp_min(wdt, (float)1e-6), 0.f, 1.f);
}

// p stays in the parameter space (__grid_constant__): the helpers take it
// by reference without a per-thread copy
__global__ void __launch_bounds__(256)
shade_surface_kernel(const __grid_constant__ ShadeParams p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.P) return;
  const bool valid = p.tri_id[i] >= 0;
  const float depth = p.depth[i];
  float n[3] = {p.normal[0][i], p.normal[1][i], p.normal[2][i]};
  norm3(n);

  // ---- world position + view ray -----------------------------------------
  float xs, ys;
  if (p.ndc[0]) {
    xs = p.ndc[0][i];
    ys = p.ndc[1][i];
  } else {
    float fx = (float)(i % p.width);
    if (p.col_offset) fx = fx + (float)p.col_offset;
    xs = (fx + 0.5f) / (float)p.width_full * 2.f - 1.f;
    int rows = i / p.width;
    if (p.n_layer_tiles > 1) rows = rows % (p.height / p.n_layer_tiles);
    ys = 1.f - ((float)(rows + p.row_offset) + 0.5f) / (float)p.height_full *
                   2.f;
  }
  const float* ivp = p.inv_view_proj;
  float wp[4];
  for (int j = 0; j < 4; ++j) {
    wp[j] = xs * ivp[4 * j] + ys * ivp[4 * j + 1] + depth * ivp[4 * j + 2] +
            ivp[4 * j + 3];
  }
  const float inv_w = 1.f / (fabsf(wp[3]) > EPS ? wp[3] : EPS);
  const float pos[3] = {wp[0] * inv_w, wp[1] * inv_w, wp[2] * inv_w};
  float v[3] = {p.cam_pos[0] - pos[0], p.cam_pos[1] - pos[1],
                p.cam_pos[2] - pos[2]};
  norm3(v);

  // ---- material row and taps ---------------------------------------------
  const int row = min(max((int)p.mat_row[i], 0), p.mat_cap - 1);
  const float* mf = p.mat_float + (size_t)row * NUM_F32;
  const int* mt = p.mat_tex + (size_t)row * NUM_TEX_SLOTS * 3;
  const int kind = p.mat_flags[(size_t)row * NUM_I32 + MI_KIND];
  const int alpha_mode = p.mat_flags[(size_t)row * NUM_I32 + MI_ALPHA_MODE];
  // channel c of tapped slot k: white where the material binds no texture
  auto tex = [&](int k, int slot, int c) -> float {
    const int t = p.tap[k];
    if (t < 0 || mt[slot * 3] < 0) return 1.f;
    return p.taps[c * p.tap_stride + (int64_t)t * p.P + i];
  };

  float base[4];
  for (int c = 0; c < 4; ++c) {
    const float vc = p.color[0] ? p.color[c][i] : 1.f;
    base[c] = mf[MF_BASE_COLOR + c] * tex(T_BASE, TS_BASE_COLOR, c) * vc;
  }
  const float metallic = clamp(
      mf[MF_METALLIC] * tex(T_MR, TS_METALLIC_ROUGHNESS, 2), 0.f, 1.f);
  const float roughness =
      clamp(mf[MF_ROUGHNESS] * tex(T_MR, TS_METALLIC_ROUGHNESS, 1),
            (float)0.04, 1.f);
  const float alpha_rough = roughness * roughness;
  const float occlusion =
      1.f + mf[MF_OCCLUSION_STRENGTH] * (tex(T_OCCLUSION, TS_OCCLUSION, 0) -
                                         1.f);
  float emissive[3];
  for (int c = 0; c < 3; ++c) {
    emissive[c] = mf[MF_EMISSIVE + c] * tex(T_EMISSIVE, TS_EMISSIVE, c) *
                  mf[MF_EMISSIVE_STRENGTH];
  }

  // ---- normal mapping, facing flip ---------------------------------------
  float nf[3] = {n[0], n[1], n[2]};
  if (p.tap[T_NORMAL] >= 0) {
    const float tg[3] = {p.tangent[0][i], p.tangent[1][i], p.tangent[2][i]};
    const float n_dot_t = dot3(n, tg);
    float tw[3] = {tg[0] - n[0] * n_dot_t, tg[1] - n[1] * n_dot_t,
                   tg[2] - n[2] * n_dot_t};
    norm3(tw);
    const float t_w = p.tangent[3][i];
    const float bw[3] = {(n[1] * tw[2] - n[2] * tw[1]) * t_w,
                         (n[2] * tw[0] - n[0] * tw[2]) * t_w,
                         (n[0] * tw[1] - n[1] * tw[0]) * t_w};
    const float ns = mf[MF_NORMAL_SCALE];
    const float tsx = (tex(T_NORMAL, TS_NORMAL, 0) * 2.f - 1.f) * ns;
    const float tsy = (tex(T_NORMAL, TS_NORMAL, 1) * 2.f - 1.f) * ns;
    const float tsz = tex(T_NORMAL, TS_NORMAL, 2) * 2.f - 1.f;
    float nm[3];
    for (int k = 0; k < 3; ++k) nm[k] = tsx * tw[k] + tsy * bw[k] + tsz * n[k];
    norm3(nm);
    if (mt[TS_NORMAL * 3] >= 0) {
      for (int k = 0; k < 3; ++k) nf[k] = nm[k];
    }
  }
  if (dot3(nf, v) < 0.f) {
    for (int k = 0; k < 3; ++k) nf[k] = -nf[k];
  }

  // ---- BRDF inputs (glTF spec) -------------------------------------------
  const float ior = mf[MF_IOR];
  const float q = (ior - 1.f) / clamp_min(ior + 1.f, EPS);
  const float f0_scalar = q * q;
  const float spec_amt = mf[MF_SPECULAR] * tex(T_SPECULAR, TS_SPECULAR, 3);
  float f0[3], c_diff[3];
  for (int c = 0; c < 3; ++c) {
    f0[c] = clamp_max(f0_scalar * mf[MF_SPECULAR_COLOR + c] *
                          tex(T_SPECULAR_COLOR, TS_SPECULAR_COLOR, c),
                      1.f) *
                spec_amt * (1.f - metallic) +
            base[c] * metallic;
  }
  for (int c = 0; c < 3; ++c) c_diff[c] = base[c] * (1.f - metallic);

  // ---- punctual lights (the dense loop) ----------------------------------
  const float n_dot_v = clamp_min(dot3(nf, v), EPS);
  float direct[3] = {0.f, 0.f, 0.f};
  for (int li = 0; li < p.n_lights; ++li) {
    one_light(p.lights + (size_t)li * LIGHT_F32, pos, nf, v, c_diff, f0,
              alpha_rough, n_dot_v, direct);
  }

  // ---- environment --------------------------------------------------------
  float r[3];
  for (int k = 0; k < 3; ++k) r[k] = 2.f * n_dot_v * nf[k] - v[k];
  norm3(r);
  float irr[3], pref[3], sky[3];
  const bool sky_here = p.want_sky && !valid;
  if (p.texels) {
    const int A = 6 * p.sky_size * p.sky_size;
    const int B = 6 * p.irr_size * p.irr_size;
    const int C = 6 * p.pref_size * p.pref_size;
    float t4[4], s1[4];
    env_tap(p, p.env_base + A, p.irr_size, nf, t4);
    for (int c = 0; c < 3; ++c) irr[c] = t4[c];
    const float level =
        clamp(roughness, 0.f, 1.f) * (float)(p.pref_levels - 1);
    const int l0 = (int)floorf(level);
    const int l1 = min(l0 + 1, p.pref_levels - 1);
    const float frac = level - (float)l0;
    env_tap(p, p.env_base + A + B + l0 * C, p.pref_size, r, t4);
    env_tap(p, p.env_base + A + B + l1 * C, p.pref_size, r, s1);
    for (int c = 0; c < 3; ++c) {
      pref[c] = t4[c] * (1.f - frac) + s1[c] * frac;
    }
    if (sky_here) {
      const float d[3] = {-v[0], -v[1], -v[2]};
      env_tap(p, p.env_base, p.sky_size, d, t4);
      for (int c = 0; c < 3; ++c) sky[c] = t4[c];
    }
  } else {
    for (int c = 0; c < 3; ++c) {
      irr[c] = p.solid[c];
      pref[c] = p.solid[3 + c];
      sky[c] = p.solid[6 + c];
    }
  }

  // ---- split-sum fit (env_brdf_approx), ambient, emissive -----------------
  const float rx = roughness * -1.f + 1.f;
  const float ry = roughness * (float)-0.0275 + (float)0.0425;
  const float rz = roughness * (float)-0.572 + (float)1.04;
  const float rw = roughness * (float)0.022 + (float)-0.04;
  const float a004 =
      minp(rx * rx, exp2f(n_dot_v * (float)-9.28)) * rx + ry;
  const float lut_a = a004 * (float)-1.04 + rz;
  const float lut_b = a004 * (float)1.04 + rw;
  float fresnel_scale[3], color[3];
  for (int c = 0; c < 3; ++c) {
    fresnel_scale[c] = f0[c] * lut_a + lut_b;
    const float ambient =
        (irr[c] * c_diff[c] + pref[c] * fresnel_scale[c]) * occlusion;
    color[c] = direct[c] + ambient;
    color[c] = color[c] + emissive[c];
  }

  // ---- alpha per mode (OPAQUE = 1, MASK = cutoff test, BLEND = base a) ---
  float alpha = alpha_mode == 0
                    ? 1.f
                    : (alpha_mode == 1
                           ? (base[3] >= mf[MF_ALPHA_CUTOFF] ? 1.f : 0.f)
                           : base[3]);

  if (p.transparent) {
    // editor grid (KIND_GRID: procedural world-space lines)
    const float spacing = clamp_min(mf[MF_GRID_SPACING], (float)1e-3);
    const float major_every = clamp_min(mf[MF_GRID_MAJOR_EVERY], 1.f);
    const float fade = clamp_min(mf[MF_GRID_FADE_DISTANCE], (float)1e-3);
    const float cd[3] = {pos[0] - p.cam_pos[0], pos[1] - p.cam_pos[1],
                         pos[2] - p.cam_pos[2]};
    const float cam_dist = sqrtf(dot3(cd, cd));
    const float aa = clamp_min(cam_dist * (float)2e-3, (float)1e-4);
    const float minor = maxp(line_alpha(pos[0], spacing, aa),
                             line_alpha(pos[2], spacing, aa));
    const float major =
        maxp(line_alpha(pos[0], spacing * major_every, aa * 1.5f),
             line_alpha(pos[2], spacing * major_every, aa * 1.5f));
    const float grid_a = maxp(minor * 0.5f, major) *
                         clamp(1.f - cam_dist / fade, 0.f, 1.f);
    if (kind == KIND_GRID) alpha = grid_a * base[3];
    // transmission factor: the transmission extension is out of K14's
    // scope, so its gate is 0 (the chain's product, NaN included)
    const float att_dist = mf[MF_ATTENUATION_DISTANCE];
    const float inv_att =
        mf[MF_THICKNESS] / clamp_min(att_dist, (float)1e-4);
    for (int c = 0; c < 3; ++c) {
      const float att =
          att_dist > 0.f
              ? expf(logf(clamp_min(mf[MF_ATTENUATION_COLOR + c],
                                    (float)1e-4)) *
                     inv_att)
              : 1.f;
      p.trans[(size_t)c * p.P + i] =
          base[c] * att * (1.f - fresnel_scale[c]) * 0.f;
    }
  }

  for (int c = 0; c < 3; ++c) {
    if (kind == KIND_UNLIT || (p.transparent && kind == KIND_GRID)) {
      color[c] = base[c];
    }
    if (p.normals_view) color[c] = nf[c] * 0.5f + 0.5f;
    if (sky_here) color[c] = sky[c];
    p.out[(size_t)c * p.P + i] = color[c];
  }
  p.out[(size_t)3 * p.P + i] = alpha;
}

}  // namespace

extern "C" int awsm_shade_surface(const ShadeParams* params,
                                  cudaStream_t stream) {
  if (params->P > 0) {
    const int block = 256;
    shade_surface_kernel<<<(params->P + block - 1) / block, block, 0,
                           stream>>>(*params);
  }
  return (int)cudaGetLastError();
}
