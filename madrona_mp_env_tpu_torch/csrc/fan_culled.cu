// K6: shared-origin sensor fans vs each fan's PVS cell candidates.
//
// Replaces the TPU kernel madrona_mp_env_tpu/ops/raycast_pallas.py
// _make_fan_kernel_culled (via _get_fan_culled / ray_fans_culled_planar),
// the big-map fan that takes over when the soup has T >= 4 K triangles
// (its ops/raycast.py fan_cull_wins). Plain version: ops/raycast.py
// _ray_fans_culled_plain.
//
// What is not carried over: the TPU kernel sorts fans by cell into
// 16-fan groups so that a block reads one [16, K] table slice
// (culling.agent_sorted_layout), takes the direction dots in bf16 on the
// MXU and divides with an approximate reciprocal. Those are lane and MXU
// economics; here a block is one fan, which loads its own cell's candidate
// rows, and the arithmetic is _ray_fans_dense's (csrc/tri_math.cuh order,
// --fmad=false): bit-equal to the plain version.
//
// Bound on the H100: sum over fans of F rays x the cell's valid candidates
// (town_map: 12288 x 104 x ~675 = 8.6e8 pairs per step) of ~30 f32
// operations after hoisting: bound by operations.
// Design: K2's (csrc/fan_sweep.cuh): one block per fan, the cell's K
// candidates swept in tiles of kFanTile rows with the origin terms hoisted
// per (group, candidate) into shared memory; -1 padding is dropped while a
// tile is staged, so padded tiles cost one pass over their indices. The
// interface is generic (cells [N], cand [C, K], the soup's [T, 16] rows).
#include "fan_sweep.cuh"

using namespace mpenv;

__global__ void fan_culled_kernel(const float* __restrict__ org, const float* __restrict__ zg,
                                  const float* __restrict__ dx, const float* __restrict__ dy,
                                  const float* __restrict__ dz,
                                  const int* __restrict__ group_of_ray,
                                  const float* __restrict__ rows, const int* __restrict__ cells,
                                  const int* __restrict__ cand, int F, int G, int K,
                                  float* __restrict__ out) {
  const size_t n = blockIdx.x, ray0 = n * F;
  fan_sweep(org[3 * n], org[3 * n + 1], org[3 * n + 2], zg + n * G, group_of_ray, G, dx + ray0,
            dy + ray0, dz + ray0, rows, cand + (size_t)cells[n] * K, K, F, out + ray0);
}

extern "C" int fan_culled_launch(const float* org, const float* zg, const float* dx,
                                 const float* dy, const float* dz, const int* group_of_ray,
                                 const float* rows, const int* cells, const int* cand, int N,
                                 int F, int G, int K, float* out, void* stream) {
  if (N <= 0) return 0;
  size_t smem = fan_sweep_smem(G);
  cudaError_t e = allow_smem(fan_culled_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  fan_culled_kernel<<<N, kFanThreads, smem, (cudaStream_t)stream>>>(
      org, zg, dx, dy, dz, group_of_ray, rows, cells, cand, F, G, K, out);
  return (int)cudaGetLastError();
}
