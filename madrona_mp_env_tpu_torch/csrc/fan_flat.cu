// K7: sensor fans with stacked directions and per-ray z offsets vs the
// whole triangle soup.
//
// Replaces the TPU kernels madrona_mp_env_tpu/ops/raycast_pallas.py
// _make_fan_kernel (per-ray z), _make_fan_kernel_v5 (z-groups that are
// multiples of 8) and _make_fan_kernel_v4 (z-groups of any length), via
// _get_fan_flat / ray_fans_vs_tris_pallas: the fan entry of the stacked
// [N, F, 3] direction layout, which the JAX package takes for the kernel
// bench and for every fan whose z-groups are not multiples of 8 (an odd
// team size: Zone 3v3's LOS run holds 12 rays), on any map. Plain
// version: ops/raycast.py _ray_fans_flat_plain.
//
// What is not carried over: the TPU kernels take the direction dots as a
// bf16 matrix product (dir_packed), relayout the v4 directions ray-major
// and tile FANS_PER_BLOCK fans per grid step. Those are matrix-unit and
// lane economics. Here the function is the nearest hit over the soup in
// _ray_vs_tris_dense's f32 arithmetic (csrc/tri_math.cuh order,
// --fmad=false): bit-equal to the plain version.
//
// Interface: origins [N, 3], per-ray z offsets zoff [N, F] (the wrapper
// expands per-group offsets), directions dirs [N, F, 3] of any scale (t
// is in units of |d|), the soup's [T, 16] rows -> t [N, F], inf on a miss.
//
// Bound on the H100: N fans x F rays x T triangles pair tests (Zone 3v3
// at 1024 worlds on simple_map: 6144 x 92 x 256 = 1.4e8 per step) of ~32
// f32 operations after hoisting, from N * (12 + 16F) bytes in and 4NF
// out: bound by operations.
// Design: one block per fan. The block finds the runs of bitwise-equal z
// offsets of its rays (csrc/fan_sweep.cuh find_runs, as K9 does), so
// per-ray z, per-group z and runs of any length all go through this one
// kernel, then sweeps the soup in tiles with the origin terms hoisted per
// (run, triangle), as K2 does.
#include "fan_sweep.cuh"

using namespace mpenv;

__global__ void __launch_bounds__(kFanThreads)
    fan_flat_kernel(const float* __restrict__ org, const float* __restrict__ zoff,
                    const float* __restrict__ dirs, const float* __restrict__ rows, int F, int T,
                    float* __restrict__ out) {
  extern __shared__ float s[];
  // past fan_sweep's region: each ray's group and each group's z offset
  int* group_of_ray = (int*)((char*)s + fan_sweep_smem(kHoistGroups));
  float* zg = (float*)(group_of_ray + F);

  const size_t n = blockIdx.x, ray0 = n * F;
  const int runs = find_runs(zoff + ray0, F, group_of_ray, zg);
  const float* d = dirs + 3 * ray0;
  fan_sweep<3>(org[3 * n], org[3 * n + 1], org[3 * n + 2], zg, group_of_ray, runs, d, d + 1,
               d + 2, rows, nullptr, T, F, out + ray0);
}

extern "C" int fan_flat_launch(const float* org, const float* zoff, const float* dirs,
                               const float* rows, int N, int F, int T, float* out, void* stream) {
  if (N <= 0) return 0;
  size_t smem = fan_sweep_smem(kHoistGroups) + (size_t)F * (sizeof(int) + sizeof(float));
  cudaError_t e = allow_smem(fan_flat_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  fan_flat_kernel<<<N, kFanThreads, smem, (cudaStream_t)stream>>>(org, zoff, dirs, rows, F, T,
                                                                  out);
  return (int)cudaGetLastError();
}
