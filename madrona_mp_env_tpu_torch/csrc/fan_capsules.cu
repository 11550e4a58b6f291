// K3 and K3x: every sensor ray vs its world's agent capsules.
//
// Replaces the TPU kernel madrona_mp_env_tpu/ops/raycast_cull.py
// _make_cap_kernel, both variants: derive_origins=True (K3, via
// _get_cap_flat_planar / fan_capsules_planar: origins = the caster's
// position + a z offset, the caster excluded), the sim's sensor sweep;
// and derive_origins=False (K3x, via _get_cap_kernel / _get_cap_flat /
// fan_capsules: explicit per-ray origins and a per-ray capsule to
// exclude), the kernel bench's. Plain versions: ops/raycast_cull.py
// _fan_capsules_plain (K3, per-group z offsets), _fan_capsules_ray_plain
// (K3's predecessor, per-ray z offsets) and _fan_capsules_explicit_plain.
//
// Bound on the H100: W * A * F rays (slice: 1.28e6) x the world's live
// capsules, from 12 bytes per ray in and 8 out (~26 MB a step, ~8 us at
// 3.35 TB/s) against, as the predecessor wrote it, ~75 f32 operations a
// (ray, capsule) pair (~1e9, ~15 us at 67 TFLOP/s).
//
// fan_capsules_kernel (K3): a block per fan, a thread per ray. Rays of one
// z-group of a fan share their origin, so the terms of ray_capsule that
// depend on the origin and the capsule alone (m, ms, mm, c, and each cap
// sphere's offset and cc) are computed once per (z-group, capsule) into
// shared memory, and those of the ray alone (dd, ds, a) once per ray; the
// pair then costs two dots and three discriminants (cap_pair below). The
// square root and divide of the cylinder and of each cap sphere run only
// where their discriminant lets them hit (disc >= 0 with a != 0, dsc >=
// 0), which is exact: elsewhere the predecessor replaced their result by
// inf. The world's live capsules other than the caster are a bit mask
// (a ballot), walked from the lowest index with a strict <, so ties keep
// the lowest index. Every term repeats tri_math.cuh ray_capsule's
// operations in its order (--fmad=false): the same bits.
// fan_capsules_v1_kernel, the predecessor: a thread per ray running the
// whole of ray_capsule against each capsule; timed beside it, launched by
// no path.
#include "tri_math.cuh"

using namespace mpenv;

// nearest capsule of world w's A capsules along o + t d, capsule skip
// and the dead excluded: (t, index) into t_out / idx_out at ray
__device__ __forceinline__ void nearest_capsule(V3 o, V3 d, const float* __restrict__ pos,
                                                const unsigned char* __restrict__ alive, size_t w,
                                                int A, int skip, float r, float seg_h,
                                                float* __restrict__ t_out,
                                                int* __restrict__ idx_out, size_t ray) {
  // capsule axis: base + (0, 0, r), up by seg_h (ops/raycast_cull.py)
  V3 lift = v3(0.0f * r, 0.0f * r, 1.0f * r);
  V3 seg = v3(0.0f * seg_h, 0.0f * seg_h, 1.0f * seg_h);
  float seg_len2 = seg_h * seg_h;
  float rr = r * r;
  float best = CUDART_INF_F;
  int best_j = 0;
  for (int j = 0; j < A; ++j) {
    if (j == skip || !alive[w * A + j]) continue;
    V3 p0 = load3(pos + 3 * (w * A + j)) + lift;
    float t = ray_capsule(o, d, p0, seg, seg_len2, rr);
    if (t < best) {
      best = t;
      best_j = j;
    }
  }
  t_out[ray] = best;
  idx_out[ray] = isinf(best) ? -1 : best_j;
}

__global__ void fan_capsules_v1_kernel(const float* __restrict__ pos,
                                       const float* __restrict__ zoff,
                                       const float* __restrict__ dx, const float* __restrict__ dy,
                                       const float* __restrict__ dz,
                                       const unsigned char* __restrict__ alive, int W, int A,
                                       int F, float r, float seg_h, float* __restrict__ t_out,
                                       int* __restrict__ idx_out) {
  size_t ray = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  size_t total = (size_t)W * A * F;
  if (ray >= total) return;
  size_t fan = ray / F;  // w * A + a
  const float* p = pos + 3 * fan;
  V3 o = v3(p[0] + 0.0f, p[1] + 0.0f, p[2] + zoff[ray]);
  V3 d = v3(dx[ray], dy[ray], dz[ray]);
  nearest_capsule(o, d, pos, alive, fan / A, A, (int)(fan % A), r, seg_h, t_out, idx_out, ray);
}

// K3x: origins o and directions d [W, A, F, 3], the capsule to exclude
// per ray self_idx [W, A, F]
__global__ void fan_capsules_explicit_kernel(const float* __restrict__ o,
                                             const float* __restrict__ d,
                                             const int* __restrict__ self_idx,
                                             const float* __restrict__ pos,
                                             const unsigned char* __restrict__ alive, int W,
                                             int A, int F, float r, float seg_h,
                                             float* __restrict__ t_out,
                                             int* __restrict__ idx_out) {
  size_t ray = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  size_t total = (size_t)W * A * F;
  if (ray >= total) return;
  nearest_capsule(load3(o + 3 * ray), load3(d + 3 * ray), pos, alive, ray / ((size_t)A * F), A,
                  self_idx[ray], r, seg_h, t_out, idx_out, ray);
}

// K3's per-(z-group, capsule) terms of ray_capsule, planes of G * A floats
// in shared memory: m = o - p0, ms = m.seg, c (the cylinder's), cc0 (cap
// sphere p0's), m1 = o - (p0 + seg) and cc1 (cap sphere p0 + seg's)
enum CapTerm { kMx, kMy, kMz, kMs, kC, kCc0, kM1x, kM1y, kM1z, kCc1, kCapTerms };
constexpr int kCapThreads = 256;  // at most; a block per fan, a thread per ray
constexpr int kCapMaxSmem = 48 * 1024;

// ray_sphere's t from its pair terms (bb = mo.d, cc = mo.mo - rr; den =
// max(dd, 1e-20)): the root and divide only where dsc >= 0 lets it hit
__device__ __forceinline__ float cap_sphere(float bb, float dd, float cc, float den) {
  float dsc = bb * bb - dd * cc;
  if (!(dsc >= 0.0f)) return CUDART_INF_F;
  float sq = sqrtf(fmaxf(dsc, 0.0f));
  float t = (-bb - sq) / den;
  return t >= 0.0f ? t : CUDART_INF_F;
}

// ray_capsule of one ray (d, dd, ds, a, a_ok, den) against capsule e of
// the terms' planes tm (stride GA)
__device__ __forceinline__ float cap_pair(const float* __restrict__ tm, int GA, int e, V3 d,
                                          float dd, float ds, float a, bool a_ok, float den,
                                          float inv_l2, float seg_len2) {
  V3 m = v3(tm[kMx * GA + e], tm[kMy * GA + e], tm[kMz * GA + e]);
  float ms = tm[kMs * GA + e];
  float md = dot(m, d);
  float b = md - ms * ds * inv_l2;
  float disc = b * b - a * tm[kC * GA + e];
  float t_cyl = CUDART_INF_F;
  if (a_ok && disc >= 0.0f) {
    float sqrt_disc = sqrtf(fmaxf(disc, 0.0f));
    float t = (-b - sqrt_disc) / a;
    float s_hit = ms + t * ds;
    if (t >= 0.0f && s_hit >= 0.0f && s_hit <= seg_len2) t_cyl = t;
  }
  // cap sphere p0: mo = o - p0 is m, so bb = md and cc = mm - rr
  float t0 = cap_sphere(md, dd, tm[kCc0 * GA + e], den);
  V3 m1 = v3(tm[kM1x * GA + e], tm[kM1y * GA + e], tm[kM1z * GA + e]);
  float t1 = cap_sphere(dot(m1, d), dd, tm[kCc1 * GA + e], den);
  return min2(t_cyl, min2(t0, t1));
}

// K3: pos [W, A, 3]; zg [W, A, G] z offsets per group; dx, dy, dz [W, A,
// F]; group_of_ray [F]; alive [W, A] (> 0: alive)
__global__ void fan_capsules_kernel(const float* __restrict__ pos, const float* __restrict__ zg,
                                    const float* __restrict__ dx, const float* __restrict__ dy,
                                    const float* __restrict__ dz,
                                    const int* __restrict__ group_of_ray,
                                    const float* __restrict__ alive, int A, int F, int G, float r,
                                    float seg_h, float* __restrict__ t_out,
                                    int* __restrict__ idx_out) {
  extern __shared__ float terms[];  // [kCapTerms][G * A]
  __shared__ unsigned live;
  const size_t fan = blockIdx.x;  // w * A + a
  const size_t w = fan / A;
  const int GA = G * A;
  // capsule axis: base + (0, 0, r), up by seg_h (ops/raycast_cull.py)
  V3 lift = v3(0.0f * r, 0.0f * r, 1.0f * r);
  V3 seg = v3(0.0f * seg_h, 0.0f * seg_h, 1.0f * seg_h);
  float seg_len2 = seg_h * seg_h;
  float rr = r * r;
  float inv_l2 = 1.0f / fmaxf(seg_len2, 1e-20f);
  if (threadIdx.x < 32) {  // the world's live capsules but the caster's
    const int j = threadIdx.x;
    const bool ok = j < A && (size_t)j != fan % A && alive[w * A + j] > 0.0f;
    const unsigned bits = __ballot_sync(0xffffffffu, ok);
    if (j == 0) live = bits;
  }
  const float* p = pos + 3 * fan;
  for (int e = threadIdx.x; e < GA; e += blockDim.x) {
    const int g = e / A, j = e % A;
    V3 o = v3(p[0] + 0.0f, p[1] + 0.0f, p[2] + zg[fan * G + g]);
    V3 p0 = load3(pos + 3 * (w * A + j)) + lift;
    V3 m = o - p0;
    float ms = dot(m, seg);
    float mm = dot(m, m);
    V3 m1 = o - (p0 + seg);
    terms[kMx * GA + e] = m.x;
    terms[kMy * GA + e] = m.y;
    terms[kMz * GA + e] = m.z;
    terms[kMs * GA + e] = ms;
    terms[kC * GA + e] = mm - ms * ms * inv_l2 - rr;
    terms[kCc0 * GA + e] = mm - rr;
    terms[kM1x * GA + e] = m1.x;
    terms[kM1y * GA + e] = m1.y;
    terms[kM1z * GA + e] = m1.z;
    terms[kCc1 * GA + e] = dot(m1, m1) - rr;
  }
  __syncthreads();
  const unsigned mask = live;
  for (int f = threadIdx.x; f < F; f += blockDim.x) {
    const size_t ray = fan * F + f;
    const int e0 = group_of_ray[f] * A;
    V3 d = v3(dx[ray], dy[ray], dz[ray]);
    float dd = dot(d, d);
    float ds = dot(d, seg);
    float a = dd - ds * ds * inv_l2;
    bool a_ok = fabsf(a) > 1e-12f;
    float den = fmaxf(dd, 1e-20f);
    float best = CUDART_INF_F;
    int best_j = 0;
    for (unsigned left = mask; left; left &= left - 1) {
      const int j = __ffs(left) - 1;
      float t = cap_pair(terms, GA, e0 + j, d, dd, ds, a, a_ok, den, inv_l2, seg_len2);
      if (t < best) {
        best = t;
        best_j = j;
      }
    }
    t_out[ray] = best;
    idx_out[ray] = isinf(best) ? -1 : best_j;
  }
}

extern "C" int fan_capsules_launch(const float* pos, const float* zg, const float* dx,
                                   const float* dy, const float* dz, const int* group_of_ray,
                                   const float* alive, int W, int A, int F, int G, float r,
                                   float seg_h, float* t_out, int* idx_out, void* stream) {
  if ((size_t)W * A * F == 0) return 0;
  const size_t smem = sizeof(float) * kCapTerms * G * A;
  if (A > 32 || G <= 0 || smem > kCapMaxSmem) return (int)cudaErrorInvalidValue;
  const int threads = F < kCapThreads ? (F + 31) / 32 * 32 : kCapThreads;
  fan_capsules_kernel<<<(unsigned)(W * A), threads, smem, (cudaStream_t)stream>>>(
      pos, zg, dx, dy, dz, group_of_ray, alive, A, F, G, r, seg_h, t_out, idx_out);
  return (int)cudaGetLastError();
}

extern "C" int fan_capsules_v1_launch(const float* pos, const float* zoff, const float* dx,
                                      const float* dy, const float* dz,
                                      const unsigned char* alive, int W, int A, int F, float r,
                                      float seg_h, float* t_out, int* idx_out, void* stream) {
  size_t total = (size_t)W * A * F;
  if (total == 0) return 0;
  const int threads = 256;
  unsigned blocks = (unsigned)((total + threads - 1) / threads);
  fan_capsules_v1_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      pos, zoff, dx, dy, dz, alive, W, A, F, r, seg_h, t_out, idx_out);
  return (int)cudaGetLastError();
}

extern "C" int fan_capsules_explicit_launch(const float* o, const float* d, const int* self_idx,
                                            const float* pos, const unsigned char* alive, int W,
                                            int A, int F, float r, float seg_h, float* t_out,
                                            int* idx_out, void* stream) {
  size_t total = (size_t)W * A * F;
  if (total == 0) return 0;
  const int threads = 256;
  unsigned blocks = (unsigned)((total + threads - 1) / threads);
  fan_capsules_explicit_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      o, d, self_idx, pos, alive, W, A, F, r, seg_h, t_out, idx_out);
  return (int)cudaGetLastError();
}
