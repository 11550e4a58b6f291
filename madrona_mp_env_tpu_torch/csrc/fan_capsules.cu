// K3 and K3x: every sensor ray vs its world's agent capsules, two
// entries.
//
// Replaces the TPU kernel madrona_mp_env_tpu/ops/raycast_cull.py
// _make_cap_kernel, both variants: derive_origins=True (K3, via
// _get_cap_flat_planar / fan_capsules_planar: origins = the caster's
// position + a per-ray z offset, the caster excluded), the sim's sensor
// sweep; and derive_origins=False (K3x, via _get_cap_kernel /
// _get_cap_flat / fan_capsules: explicit per-ray origins and a per-ray
// capsule to exclude), the kernel bench's. Plain versions:
// ops/raycast_cull.py _fan_capsules_plain and _fan_capsules_explicit_plain.
//
// Bound on the H100: W * A * F rays (slice: 1.28e6) x A capsules of ~70
// f32 operations (cylinder + two cap spheres, two square roots, three
// divides) from 16 bytes per ray in (K3x: 28) and 8 out (bytes: ~31 MB per
// step, ~9 us at 3.35 TB/s; operations: ~1.1e9, ~16 us at 67 TFLOP/s):
// bound by operations. Design: one thread per ray; the thread loops over
// the world's A capsules (skipping the excluded one and the dead), keeping
// the nearest t and the lowest index among equal t (the plain version's
// argmin), -1 on a miss.
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

__global__ void fan_capsules_kernel(const float* __restrict__ pos, const float* __restrict__ zoff,
                                    const float* __restrict__ dx, const float* __restrict__ dy,
                                    const float* __restrict__ dz,
                                    const unsigned char* __restrict__ alive, int W, int A, int F,
                                    float r, float seg_h, float* __restrict__ t_out,
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

extern "C" int fan_capsules_launch(const float* pos, const float* zoff, const float* dx,
                                   const float* dy, const float* dz, const unsigned char* alive,
                                   int W, int A, int F, float r, float seg_h, float* t_out,
                                   int* idx_out, void* stream) {
  size_t total = (size_t)W * A * F;
  if (total == 0) return 0;
  const int threads = 256;
  unsigned blocks = (unsigned)((total + threads - 1) / threads);
  fan_capsules_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(pos, zoff, dx, dy, dz, alive,
                                                                    W, A, F, r, seg_h, t_out,
                                                                    idx_out);
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
