// K2: shared-origin sensor fans vs the triangle soup.
//
// Replaces the TPU kernel madrona_mp_env_tpu/ops/raycast_pallas.py
// _make_fan_kernel_v8 / _fan_v8_body (via _get_fan_flat_planar /
// ray_fans_vs_tris_planar); the bf16 direction dots and the approximate
// reciprocal of that kernel are not carried over. Plain version:
// ops/raycast.py _ray_fans_dense.
//
// Bound on the H100: N fans x F rays x T triangles pair tests (slice: 12288
// x 104 x 256 = 3.3e8 per step) of ~30 f32 operations after hoisting, from
// N * (12 + 4G + 12F) bytes in and 4NF bytes out: bound by operations.
// Design: one block per fan. All rays of a z-group share their origin, so
// the origin terms of Moller-Trumbore (tvec = o - v0, qvec = tvec x e1 and
// e2 . qvec) are computed once per (group, triangle) into shared memory,
// as _fan_v8_body hoists them; each thread then sweeps one ray over the
// triangles with only the direction terms left, min-reducing t in a
// register. Any run lengths work (a ray's group comes from group_of_ray).
#include "tri_math.cuh"

using namespace mpenv;

__global__ void fan_tris_kernel(const float* __restrict__ org, const float* __restrict__ zg,
                                const float* __restrict__ dx, const float* __restrict__ dy,
                                const float* __restrict__ dz, const int* __restrict__ group_of_ray,
                                const float* __restrict__ rows, int F, int G, int T,
                                float* __restrict__ out) {
  extern __shared__ float s[];
  float* e1s = s;                 // [T][3]
  float* e2s = e1s + 3 * T;       // [T][3]
  float* valid = e2s + 3 * T;     // [T]
  float* hoist = valid + T;       // [G][T][7]: tvec qvec e2.qvec
  const int n = blockIdx.x;
  for (int i = threadIdx.x; i < T; i += blockDim.x) {
    const float* row = rows + (size_t)i * kRowCols;
    for (int k = 0; k < 3; ++k) {
      e1s[3 * i + k] = row[kRowE1 + k];
      e2s[3 * i + k] = row[kRowE2 + k];
    }
    valid[i] = row[kRowValid];
  }
  __syncthreads();
  const float ox = org[3 * n], oy = org[3 * n + 1], oz = org[3 * n + 2];
  for (int j = threadIdx.x; j < G * T; j += blockDim.x) {
    int g = j / T, i = j % T;
    // origins + (0, 0, zoff), as the plain version builds it
    V3 o = v3(ox + 0.0f, oy + 0.0f, oz + zg[(size_t)n * G + g]);
    V3 tvec = o - load3(rows + (size_t)i * kRowCols + kRowV0);
    V3 qvec = cross(tvec, load3(e1s + 3 * i));
    float* h = hoist + (size_t)j * 7;
    h[0] = tvec.x; h[1] = tvec.y; h[2] = tvec.z;
    h[3] = qvec.x; h[4] = qvec.y; h[5] = qvec.z;
    h[6] = dot(load3(e2s + 3 * i), qvec);
  }
  __syncthreads();
  for (int f = threadIdx.x; f < F; f += blockDim.x) {
    size_t ray = (size_t)n * F + f;
    V3 d = v3(dx[ray], dy[ray], dz[ray]);
    const float* hg = hoist + (size_t)group_of_ray[f] * T * 7;
    float best = CUDART_INF_F;
    for (int i = 0; i < T; ++i) {
      const float* h = hg + i * 7;
      V3 pvec = cross(d, load3(e2s + 3 * i));
      float det = dot(load3(e1s + 3 * i), pvec);
      bool det_ok = fabsf(det) > 1e-12f;
      float inv_det = det_ok ? 1.0f / det : 0.0f;
      float u = dot(load3(h), pvec) * inv_det;
      float v = dot(d, load3(h + 3)) * inv_det;
      float t = h[6] * inv_det;
      bool hit = det_ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > 0.0f &&
                 valid[i] > 0.0f;
      best = min2(best, sel_inf(hit, t));
    }
    out[ray] = best;
  }
}

extern "C" int fan_tris_launch(const float* org, const float* zg, const float* dx,
                               const float* dy, const float* dz, const int* group_of_ray,
                               const float* rows, int N, int F, int G, int T, float* out,
                               void* stream) {
  if (N <= 0) return 0;
  const int threads = 128;
  size_t smem = (size_t)(7 * T + 7 * G * T) * sizeof(float);
  cudaError_t e = allow_smem(fan_tris_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  fan_tris_kernel<<<N, threads, smem, (cudaStream_t)stream>>>(org, zg, dx, dy, dz, group_of_ray,
                                                              rows, F, G, T, out);
  return (int)cudaGetLastError();
}
