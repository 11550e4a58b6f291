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
// ~32 f32 operations, each its own instruction under --fmad=false, plus
// the compares and select of the hit test; bytes are N * (12 + 4G + 12F)
// in and 4NF out: bound by instruction issue.
// Design (csrc/fan_sweep_rb.cuh): one thread per octet of 8 rays of one
// z-group (runs are multiples of 8), 8 independent minima in registers,
// the origin terms once per (octet, row) in registers, the soup staged
// kRbTile rows at a time into a cp.async double buffer and read as
// broadcast 16-byte vectors; at most 64 registers (no spill), so four
// blocks of 8 warps share an SM (fewer, larger-register blocks and
// smaller blocks measured slower on the H100, tools/fan_rb_probe.py). The earlier kernel (one block per fan, the
// origin terms hoisted in shared memory, csrc/fan_sweep.cuh) is P2's
// `exact` entry (csrc/fan_probe.cu), the predecessor chip_smoke.py times
// beside it.
#include "fan_sweep_rb.cuh"

using namespace mpenv;

constexpr int kTrisThreads = 256;  // threads per block

__global__ void __launch_bounds__(kTrisThreads, 4)
    fan_tris_rb_kernel(const float* __restrict__ org, const float* __restrict__ zg,
                       const float* __restrict__ dx, const float* __restrict__ dy,
                       const float* __restrict__ dz, const int* __restrict__ group_of_ray,
                       const float* __restrict__ rows, int N, int F, int G, int T,
                       float* __restrict__ out) {
  const int opf = F / kRbRays;
  const long long items = (long long)N * opf;
  const long long item = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = item < items;
  const long long mine = live ? item : items - 1;
  const int n = (int)(mine / opf), oct = (int)(mine % opf);
  RbOctet r = rb_load(org, zg, dx, dy, dz, group_of_ray, n, oct, F, G);
  rb_sweep_tiles(r, rows, T);
  if (live) rb_store(r, out, n, oct, F);
}

extern "C" int fan_tris_launch(const float* org, const float* zg, const float* dx,
                               const float* dy, const float* dz, const int* group_of_ray,
                               const float* rows, int N, int F, int G, int T, float* out,
                               void* stream) {
  if (N <= 0) return 0;
  if (F <= 0 || F % kRbRays != 0 || T < 0) return (int)cudaErrorInvalidValue;
  const long long items = (long long)N * (F / kRbRays);
  const unsigned blocks = (unsigned)((items + kTrisThreads - 1) / kTrisThreads);
  const size_t smem = rb_tiles_smem(T);
  cudaError_t e = allow_smem(fan_tris_rb_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  fan_tris_rb_kernel<<<blocks, kTrisThreads, smem, (cudaStream_t)stream>>>(
      org, zg, dx, dy, dz, group_of_ray, rows, N, F, G, T, out);
  return (int)cudaGetLastError();
}
