// Per-(ray, triangle) arithmetic shared by the port's kernels.
//
// Every function repeats its plain PyTorch counterpart in
// madrona_mp_env_tpu_torch/ops/raycast.py operation for operation (same
// operand order, same guards). The sources are built with --fmad=false and
// IEEE division / square root (no --use_fast_math), so each step rounds as
// the plain version's tensor op does and a kernel agrees bit for bit with
// its plain version on the same inputs. Padding triangles carry all-zero
// rows and valid = 0; NaN compares are false, so they never hit.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace mpenv {

// layout of one row of the [T, 16] per-triangle table (ops/raycast.py)
constexpr int kRowV0 = 0, kRowE1 = 3, kRowE2 = 6, kRowN = 9, kRowValid = 12;
constexpr int kRowCols = 16;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) { return {x, y, z}; }
__device__ __forceinline__ V3 load3(const float* p) { return {p[0], p[1], p[2]}; }
__device__ __forceinline__ V3 operator+(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 operator-(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 operator*(float s, V3 a) { return {s * a.x, s * a.y, s * a.z}; }
// x + y + z, left to right (ops/geom.py dot)
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ float sel_inf(bool ok, float t) { return ok ? t : CUDART_INF_F; }
// torch.minimum without NaN operands (every caller guards them to inf)
__device__ __forceinline__ float min2(float a, float b) { return b < a ? b : a; }

// _ray_vs_tris_dense, one pair: t of a two-sided Moller-Trumbore hit or inf
__device__ __forceinline__ float ray_tri(V3 o, V3 d, V3 v0, V3 e1, V3 e2, bool valid) {
  V3 pvec = cross(d, e2);
  float det = dot(e1, pvec);
  bool det_ok = fabsf(det) > 1e-12f;
  float inv_det = det_ok ? 1.0f / det : 0.0f;
  V3 tvec = o - v0;
  float u = dot(tvec, pvec) * inv_det;
  V3 qvec = cross(tvec, e1);
  float v = dot(d, qvec) * inv_det;
  float t = dot(e2, qvec) * inv_det;
  bool hit = det_ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > 0.0f && valid;
  return sel_inf(hit, t);
}

// _closest_point_on_tri (Ericson RTCD 5.1.5)
__device__ __forceinline__ float safe1(float x) { return fabsf(x) > 1e-20f ? x : 1.0f; }

__device__ __forceinline__ V3 closest_point_on_tri(V3 p, V3 a, V3 ab, V3 ac) {
  V3 ap = p - a;
  float d1 = dot(ab, ap);
  float d2 = dot(ac, ap);
  V3 b = a + ab;
  V3 bp = p - b;
  float d3 = dot(ab, bp);
  float d4 = dot(ac, bp);
  V3 c = a + ac;
  V3 cp = p - c;
  float d5 = dot(ab, cp);
  float d6 = dot(ac, cp);

  float vc = d1 * d4 - d3 * d2;
  float vb = d5 * d2 - d1 * d6;
  float va = d3 * d6 - d5 * d4;
  float denom_vb = d1 - d3;
  float denom_vc = d2 - d6;
  float denom_va = (d4 - d3) + (d5 - d6);

  bool in_a = d1 <= 0.0f && d2 <= 0.0f;
  bool in_b = d3 >= 0.0f && d4 <= d3;
  bool in_c = d6 >= 0.0f && d5 <= d6;
  bool on_ab = vc <= 0.0f && d1 >= 0.0f && d3 <= 0.0f;
  bool on_ac = vb <= 0.0f && d2 >= 0.0f && d6 <= 0.0f;
  bool on_bc = va <= 0.0f && d4 - d3 >= 0.0f && d5 - d6 >= 0.0f;

  float v_ab = d1 / safe1(denom_vb);
  float w_ac = d2 / safe1(denom_vc);
  float w_bc = (d4 - d3) / safe1(denom_va);
  float inv_face = 1.0f / safe1(va + vb + vc);
  float v_f = vb * inv_face;
  float w_f = vc * inv_face;

  V3 result = (a + v_f * ab) + w_f * ac;
  if (on_bc) result = b + w_bc * (c - b);
  if (on_ac) result = a + w_ac * ac;
  if (on_ab) result = a + v_ab * ab;
  if (in_c) result = c;
  if (in_b) result = b;
  if (in_a) result = a;
  return result;
}

// _ray_vs_segment_capsule: ray vs the radius-r capsule around p0..p0+seg
__device__ __forceinline__ float ray_sphere(V3 o, V3 d, float dd, V3 center, float rr) {
  V3 mo = o - center;
  float bb = dot(mo, d);
  float cc = dot(mo, mo) - rr;
  float dsc = bb * bb - dd * cc;
  float sq = sqrtf(fmaxf(dsc, 0.0f));
  float t = (-bb - sq) / fmaxf(dd, 1e-20f);
  return sel_inf(dsc >= 0.0f && t >= 0.0f, t);
}

__device__ __forceinline__ float ray_capsule(V3 o, V3 d, V3 p0, V3 seg, float seg_len2, float rr) {
  V3 m = o - p0;
  float dd = dot(d, d);
  float md = dot(m, d);
  float ms = dot(m, seg);
  float ds = dot(d, seg);
  float mm = dot(m, m);
  float inv_l2 = 1.0f / fmaxf(seg_len2, 1e-20f);
  float a = dd - ds * ds * inv_l2;
  float b = md - ms * ds * inv_l2;
  float c = mm - ms * ms * inv_l2 - rr;
  float disc = b * b - a * c;
  float sqrt_disc = sqrtf(fmaxf(disc, 0.0f));
  bool a_ok = fabsf(a) > 1e-12f;
  float t_cyl = (-b - sqrt_disc) / (a_ok ? a : 1.0f);
  float s_hit = ms + t_cyl * ds;
  bool cyl_ok = a_ok && disc >= 0.0f && t_cyl >= 0.0f && s_hit >= 0.0f && s_hit <= seg_len2;
  t_cyl = sel_inf(cyl_ok, t_cyl);
  float t0 = ray_sphere(o, d, dd, p0, rr);
  float t1 = ray_sphere(o, d, dd, p0 + seg, rr);
  return min2(t_cyl, min2(t0, t1));
}

// _sc_pairs: the per-(cast, triangle) terms of a sphere of radius r
// swept from o along d vs one triangle (start overlap -> t = 0, face via
// the offset plane, edge capsules with vertex spheres); rr = r * r
struct ScPair {
  float t_tri, t_face, t_edge, t_sweep, dist2, sign;
  V3 to_center;
  bool overlap;
};

__device__ __forceinline__ ScPair sc_pair(V3 o, V3 d, float r, float rr, V3 v0, V3 e1, V3 e2,
                                          V3 n, bool valid) {
  ScPair p;
  V3 closest = closest_point_on_tri(o, v0, e1, e2);
  p.to_center = o - closest;
  p.dist2 = dot(p.to_center, p.to_center);
  p.overlap = p.dist2 <= rr && valid;

  float ndotd = dot(n, d);
  float h = dot(o - v0, n);
  float sign = h > 0.0f ? 1.0f : (h < 0.0f ? -1.0f : 1.0f);
  p.sign = sign;
  bool nd_ok = fabsf(ndotd) > 1e-9f;
  float t_face = (sign * r - h) / (nd_ok ? ndotd : 1.0f);
  V3 contact = (o + t_face * d) - (sign * r) * n;
  V3 cp = contact - v0;
  float d00 = dot(e1, e1);
  float d01 = dot(e1, e2);
  float d11 = dot(e2, e2);
  float d20 = dot(cp, e1);
  float d21 = dot(cp, e2);
  float denom = d00 * d11 - d01 * d01;
  float inv_denom = fabsf(denom) > 1e-20f ? 1.0f / denom : 0.0f;
  float bv = (d11 * d20 - d01 * d21) * inv_denom;
  float bw = (d00 * d21 - d01 * d20) * inv_denom;
  bool face_ok = nd_ok && t_face >= 0.0f && bv >= 0.0f && bw >= 0.0f && bv + bw <= 1.0f && valid;
  p.t_face = sel_inf(face_ok, t_face);

  V3 v1 = v0 + e1;
  float t_e0 = ray_capsule(o, d, v0, e1, dot(e1, e1), rr);
  float t_e1 = ray_capsule(o, d, v0, e2, dot(e2, e2), rr);
  V3 e12 = e2 - e1;
  float t_e2 = ray_capsule(o, d, v1, e12, dot(e12, e12), rr);
  p.t_edge = sel_inf(valid, min2(t_e0, min2(t_e1, t_e2)));
  p.t_sweep = min2(p.t_face, p.t_edge);
  p.t_tri = p.overlap ? 0.0f : p.t_sweep;
  return p;
}

// _sc_pairs -> t_tri
__device__ __forceinline__ float sphere_tri(V3 o, V3 d, float r, float rr, V3 v0, V3 e1, V3 e2,
                                            V3 n, bool valid) {
  return sc_pair(o, d, r, rr, v0, e1, e2, n, valid).t_tri;
}

// torch.clamp(x, min=lo): NaN stays NaN
__device__ __forceinline__ float clamp_lo(float x, float lo) { return x < lo ? lo : x; }

// sc_normals_from_idx for one winner triangle: the depenetration
// direction on start overlap, else the face normal signed toward the
// cast when the face hit is no later than the edge hit, else the
// direction from the closest point to the sphere's centre at the hit
__device__ __forceinline__ V3 sc_normal(V3 o, V3 d, float r, float rr, V3 v0, V3 e1, V3 e2, V3 n,
                                        bool valid) {
  ScPair p = sc_pair(o, d, r, rr, v0, e1, e2, n, valid);
  const V3 up = v3(0.0f, 0.0f, 1.0f);
  if (p.overlap) {
    float dist = sqrtf(clamp_lo(p.dist2, 0.0f));
    float dc = clamp_lo(dist, 1e-30f);
    return dist > 0.0f ? v3(p.to_center.x / dc, p.to_center.y / dc, p.to_center.z / dc) : up;
  }
  if (p.t_face <= p.t_edge) return p.sign * n;
  V3 hit_center = o + p.t_sweep * d;
  V3 edge_raw = hit_center - closest_point_on_tri(hit_center, v0, e1, e2);
  float edge_len = sqrtf(dot(edge_raw, edge_raw));
  float ec = clamp_lo(edge_len, 1e-30f);
  return edge_len > 1e-12f ? v3(edge_raw.x / ec, edge_raw.y / ec, edge_raw.z / ec) : up;
}

// dynamic shared memory above the 48 KB default needs an opt-in
template <typename K>
__host__ inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace mpenv
