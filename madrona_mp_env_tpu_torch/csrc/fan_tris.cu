// K2: shared-origin sensor fans vs the whole triangle soup.
//
// Replaces the TPU kernel madrona_mp_env_tpu/ops/raycast_pallas.py
// _make_fan_kernel_v8 / _fan_v8_body (via _get_fan_flat_planar /
// ray_fans_vs_tris_planar); the bf16 direction dots and the approximate
// reciprocal of that kernel are not carried over. Plain version:
// ops/raycast.py _ray_fans_dense.
//
// Bound on the H100: N fans x F rays x T triangles pair tests (simple_map:
// 12288 x 104 x 256 = 3.3e8 per step; town_map 6144 triangles: 7.9e9) of
// ~30 f32 operations after hoisting, from N * (12 + 4G + 12F) bytes in and
// 4NF bytes out: bound by operations.
// Design: one block per fan, the soup swept in tiles of kFanTile triangles
// with the origin terms hoisted per (group, triangle) into shared memory
// (csrc/fan_sweep.cuh), so any soup size and any run lengths work.
#include "fan_sweep.cuh"

using namespace mpenv;

__global__ void fan_tris_kernel(const float* __restrict__ org, const float* __restrict__ zg,
                                const float* __restrict__ dx, const float* __restrict__ dy,
                                const float* __restrict__ dz, const int* __restrict__ group_of_ray,
                                const float* __restrict__ rows, int F, int G, int T,
                                float* __restrict__ out) {
  const size_t n = blockIdx.x, ray0 = n * F;
  fan_sweep(org[3 * n], org[3 * n + 1], org[3 * n + 2], zg + n * G, group_of_ray, G, dx + ray0,
            dy + ray0, dz + ray0, rows, nullptr, T, F, out + ray0);
}

extern "C" int fan_tris_launch(const float* org, const float* zg, const float* dx,
                               const float* dy, const float* dz, const int* group_of_ray,
                               const float* rows, int N, int F, int G, int T, float* out,
                               void* stream) {
  if (N <= 0) return 0;
  size_t smem = fan_sweep_smem(G);
  cudaError_t e = allow_smem(fan_tris_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  fan_tris_kernel<<<N, kFanThreads, smem, (cudaStream_t)stream>>>(org, zg, dx, dy, dz,
                                                                  group_of_ray, rows, F, G, T, out);
  return (int)cudaGetLastError();
}
