// K9: sensor fans vs each fan's sensor-ray table candidates.
//
// Replaces the TPU kernel madrona_mp_env_tpu/ops/raycast_pallas.py
// _make_fan_kernel_v9 (via _get_fan_v9 / ray_fans_culled_v9), the opt-in
// fan (MPENV_FAN_V9=1) over the per-cell tables of culling_ray.npz
// (simple_map: 257 cells, K = 80 candidates against the soup's 256
// triangles). Plain version: ops/raycast.py _ray_fans_v9_plain.
//
// What is not carried over: the TPU kernel takes the direction dots of
// all 3K candidate rows against a block's rays as one bf16 matrix product
// (dir9), the origin terms as an f32 affine product (org9 against
// (ox, oy, oz + zoff, 1)), and divides with an approximate reciprocal;
// its fans are sorted by cell into 16-fan groups. Those are matrix-unit
// and lane economics. Here the function is the one the TPU kernel
// computes, the nearest hit over the cell's candidates, in
// _ray_vs_tris_dense's f32 arithmetic (csrc/tri_math.cuh order,
// --fmad=false): bit-equal to the plain version, where the TPU kernel's
// bf16 dots leave ~2% of the t beyond 2e-2 of the dense sweep.
//
// Interface: K9's own, per-ray z offsets zoff [N, F] (the TPU kernel's
// origin stream), direction planes dx, dy, dz [N, F], cells [N],
// cand [C, K] and the soup's [T, 16] rows.
//
// Bound on the H100: N fans x F rays x the cell's valid candidates
// (simple_map: 12288 x 104 x ~37 = 4.7e7 pairs per step) of ~32 f32
// operations after hoisting (~0.023 ms at 67 TFLOP/s), against N * (16 +
// 16F) bytes in and 4NF out (~0.008 ms at 3.35 TB/s): bound by
// operations.
// Design: one block per fan. The block first finds the runs of equal
// (bitwise) z offsets among its rays with a warp-ballot prefix count,
// which gives each ray its z-group (the sensor fan has 5: LOS, and one
// per lidar row; csrc/fan_sweep.cuh find_runs), then runs K2's sweep (csrc/fan_sweep.cuh) over the
// cell's candidates with the origin terms hoisted per (group, candidate):
// at K = 80 the whole cell is one tile, ~13 KB of hoisted terms. Any z
// offsets work: a fan with more than kHoistGroups runs is swept in
// several hoisting passes.
//
// The probes P5 and P6 (the JAX package's tools/probes/v9_kernel_probe.py
// call / call_nogather and v9_scan_timing.py make_variant; Python:
// madrona_mp_env_tpu_torch/tools/probes/v9_kernel_probe.py and
// v9_scan_timing.py) take two more entries of the same kernel:
// fan_v9_gathered reads each cell's candidate rows from a table gathered
// beforehand ([C, K, 16]: the soup's row of each candidate, all-zero and
// invalid for -1 padding, which is swept as a miss), in place of the
// indirection through cand; fan_v9_chunked stages the candidates 8 at a
// time (the TPU probe's "chunked" order) where fan_v9 stages all K = 80
// at once ("full"). The nearest t does not depend on either, so both are
// bit-equal to fan_v9 and its plain version.
#include "fan_sweep.cuh"

using namespace mpenv;

// kGathered: rows = the cells' gathered [C, K, 16] table, cand unused
template <int kTile, bool kGathered>
__global__ void __launch_bounds__(kFanThreads)
    fan_v9_kernel(const float* __restrict__ org, const float* __restrict__ zoff,
                  const float* __restrict__ dx, const float* __restrict__ dy,
                  const float* __restrict__ dz, const float* __restrict__ rows,
                  const int* __restrict__ cells, const int* __restrict__ cand, int F, int K,
                  float* __restrict__ out) {
  extern __shared__ float s[];
  // past fan_sweep's region: each ray's group and each group's z offset
  int* group_of_ray = (int*)((char*)s + fan_sweep_smem(kHoistGroups));
  float* zg = (float*)(group_of_ray + F);

  const size_t n = blockIdx.x, ray0 = n * F;
  const int runs = find_runs(zoff + ray0, F, group_of_ray, zg);
  const size_t cell = (size_t)cells[n] * K;
  fan_sweep<1, FanExact, kTile>(org[3 * n], org[3 * n + 1], org[3 * n + 2], zg, group_of_ray,
                                runs, dx + ray0, dy + ray0, dz + ray0,
                                kGathered ? rows + cell * kRowCols : rows,
                                kGathered ? nullptr : cand + cell, K, F, out + ray0);
}

template <int kTile, bool kGathered>
static int fan_v9_run(const float* org, const float* zoff, const float* dx, const float* dy,
                      const float* dz, const float* rows, const int* cells, const int* cand,
                      int N, int F, int K, float* out, void* stream) {
  if (N <= 0) return 0;
  size_t smem = fan_sweep_smem(kHoistGroups) + (size_t)F * (sizeof(int) + sizeof(float));
  cudaError_t e = allow_smem(fan_v9_kernel<kTile, kGathered>, smem);
  if (e != cudaSuccess) return (int)e;
  fan_v9_kernel<kTile, kGathered><<<N, kFanThreads, smem, (cudaStream_t)stream>>>(
      org, zoff, dx, dy, dz, rows, cells, cand, F, K, out);
  return (int)cudaGetLastError();
}

extern "C" int fan_v9_launch(const float* org, const float* zoff, const float* dx,
                             const float* dy, const float* dz, const float* rows,
                             const int* cells, const int* cand, int N, int F, int K, float* out,
                             void* stream) {
  return fan_v9_run<kFanTile, false>(org, zoff, dx, dy, dz, rows, cells, cand, N, F, K, out,
                                     stream);
}

// P6: the candidates staged 8 at a time
extern "C" int fan_v9_chunked_launch(const float* org, const float* zoff, const float* dx,
                                     const float* dy, const float* dz, const float* rows,
                                     const int* cells, const int* cand, int N, int F, int K,
                                     float* out, void* stream) {
  return fan_v9_run<8, false>(org, zoff, dx, dy, dz, rows, cells, cand, N, F, K, out, stream);
}

// P5: table = [C, K, 16] rows gathered per cell beforehand
extern "C" int fan_v9_gathered_launch(const float* org, const float* zoff, const float* dx,
                                      const float* dy, const float* dz, const float* table,
                                      const int* cells, int N, int F, int K, float* out,
                                      void* stream) {
  return fan_v9_run<kFanTile, true>(org, zoff, dx, dy, dz, table, cells, nullptr, N, F, K, out,
                                    stream);
}
