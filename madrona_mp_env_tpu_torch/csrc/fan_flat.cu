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
// at 1024 worlds on town_map: 6144 x 92 x 6144 = 3.5e9 per step) of ~32
// f32 operations after hoisting, each its own instruction under
// --fmad=false, from N * (12 + 16F) bytes in and 4NF out: bound by
// instruction issue.
// Design (csrc/fan_sweep_rb.cuh, K2's sweep): a thread owns R consecutive
// rays of one fan (R = 4, a quad, as shipped; 8 is a launch-argument
// variant), read from the stacked directions as they lie: thread i of a
// block column takes part i % ceil(F / R) of fan i / ceil(F / R), so warps
// are full whatever F is, and a fan's last part, where F % R != 0,
// repeats its last ray in the slots past F and stores only its own rays.
// Its directions and R minima stay in registers. If the R rays' origin z
// (oz + zoff, the only term in which their origins differ) are bit-equal,
// as for every quad of runs that are multiples of 4 (Zone 3v3's 12, 32,
// 32, 8, 8 and the kernel bench's), the origin terms are computed once per
// (thread, row) (rb_row_fast); otherwise each ray takes its own
// (rb_row_own_z), so per-ray z and runs of any length, including 1, need
// no run-finding pass. The soup is staged kRbTile rows at a time by
// cp.async into a double buffer and read as 16-byte vectors, swept
// kFlatUnroll rows per unrolled step; each staged row's bound on |det|
// for the reciprocal's fast path is computed once per block
// (rb_sweep_tiles RowBound), not once per thread. The rows are split over
// the S blocks of a thread-block cluster (S from T, ops/raycast.py
// flat_split, given at the launch): each block sweeps T / S rows for its
// column of parts, then block 0 takes the minimum of the S partial minima
// through distributed shared memory and writes out. With S = 1 the last
// of a grid's blocks ran alone on a few SMs (Zone 3v3 on town_map: 552
// blocks of 256 threads where 528 fit at once). One launch, no planning
// pass, no pre-filled output: the part count comes from F in the kernel.
//
// fan_flat_v1 is the earlier kernel (one block per fan, its runs of equal
// offsets found in shared memory, the origin terms hoisted per (run, row)
// in shared memory, csrc/fan_sweep.cuh), kept as the predecessor
// chip_smoke.py times beside it.
#include "fan_sweep.cuh"
#include "fan_sweep_rb.cuh"

namespace cg = cooperative_groups;
using namespace mpenv;

// the largest block the launch takes: under this bound ptxas gives the
// quad kernel the registers it needs (a 512-thread bound held it to 64
// and spilled)
constexpr int kFlatMaxThreads = 256;
constexpr int kFlatMaxSplit = 8;  // blocks per cluster (the portable most)

constexpr int kFlatUnroll = 4;  // rows per unrolled step of the sweep

// the thread's rays against one staged row: hoisted when their origins
// agree, the row's bound on |det| computed once per block
template <int R>
struct FlatRowFn {
  RbRays<R>& r;
  const float (&oz)[R];
  bool same_z;
  __device__ __forceinline__ void operator()(const float4* q) const {
    const bool fast = rb_fast(rb_staged_bound(q), r.dmax);
    if (same_z)
      rb_row_fast(r, q[0], q[1], q[2], fast);
    else
      rb_row_own_z(r, oz, q[0], q[1], q[2], fast);
  }
};

template <int R>
__global__ void __launch_bounds__(kFlatMaxThreads)
    fan_flat_rb_kernel(const float* __restrict__ org, const float* __restrict__ zoff,
                       const float* __restrict__ dirs, const float* __restrict__ rows, int N,
                       int F, int T, float* __restrict__ out) {
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int parts = (F + R - 1) / R;
  const long long items = (long long)N * parts;
  const long long item = (long long)(blockIdx.x / S) * blockDim.x + threadIdx.x;
  const bool live = item < items;
  const long long mine = live ? item : items - 1;
  const int n = (int)(mine / parts), f0 = R * (int)(mine % parts);
  const int nr = min(R, F - f0);
  const size_t ray0 = (size_t)n * F + f0;

  RbRays<R> r;
  float oz[R];
  r.ox = org[3 * (size_t)n] + 0.0f;
  r.oy = org[3 * (size_t)n + 1] + 0.0f;
  const float z0 = org[3 * (size_t)n + 2];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const size_t ray = ray0 + min(j, nr - 1);
    r.dx[j] = dirs[3 * ray];
    r.dy[j] = dirs[3 * ray + 1];
    r.dz[j] = dirs[3 * ray + 2];
    oz[j] = z0 + zoff[ray];
    r.best[j] = CUDART_INF_F;
  }
  bool same_z = true;
#pragma unroll
  for (int j = 1; j < R; ++j) same_z = same_z && __float_as_uint(oz[j]) == __float_as_uint(oz[0]);
  r.oz = oz[0];
  rb_set_dmax(r);
  rb_sweep_split<kFlatUnroll, true>(rows, T, FlatRowFn<R>{r, oz, same_z});
  rb_cluster_min(r.best);
  if (rank == 0 && live) {
#pragma unroll
    for (int j = 0; j < R; ++j)
      if (j < nr) out[ray0 + j] = r.best[j];
  }
  rb_cluster_done();
}

template <int R>
static cudaError_t fan_flat_rb_launch(const float* org, const float* zoff, const float* dirs,
                                      const float* rows, int N, int F, int T, int threads,
                                      int split, float* out, cudaStream_t stream) {
  const long long items = (long long)N * ((F + R - 1) / R);
  const long long cols = (items + threads - 1) / threads;
  return rb_launch_clusters(fan_flat_rb_kernel<R>, (unsigned)(cols * split), threads,
                            rb_tiles_smem((T + split - 1) / split), split, stream, org, zoff,
                            dirs, rows, N, F, T, out);
}

// rays: rays per thread (4 or 8); threads: per block, a multiple of 32 up
// to kFlatMaxThreads; split: blocks per cluster, over which the rows are
// split (1 .. kFlatMaxSplit)
extern "C" int fan_flat_launch(const float* org, const float* zoff, const float* dirs,
                               const float* rows, int N, int F, int T, int rays, int threads,
                               int split, float* out, void* stream) {
  if (N <= 0) return 0;
  if (F <= 0 || T < 0 || threads <= 0 || threads % 32 != 0 || threads > kFlatMaxThreads ||
      split < 1 || split > kFlatMaxSplit)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  if (rays == 4)
    e = fan_flat_rb_launch<4>(org, zoff, dirs, rows, N, F, T, threads, split, out, s);
  else if (rays == 8)
    e = fan_flat_rb_launch<8>(org, zoff, dirs, rows, N, F, T, threads, split, out, s);
  else
    return (int)cudaErrorInvalidValue;
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

__global__ void __launch_bounds__(kFanThreads)
    fan_flat_v1_kernel(const float* __restrict__ org, const float* __restrict__ zoff,
                       const float* __restrict__ dirs, const float* __restrict__ rows, int F,
                       int T, float* __restrict__ out) {
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

extern "C" int fan_flat_v1_launch(const float* org, const float* zoff, const float* dirs,
                                  const float* rows, int N, int F, int T, float* out,
                                  void* stream) {
  if (N <= 0) return 0;
  size_t smem = fan_sweep_smem(kHoistGroups) + (size_t)F * (sizeof(int) + sizeof(float));
  cudaError_t e = allow_smem(fan_flat_v1_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  fan_flat_v1_kernel<<<N, kFanThreads, smem, (cudaStream_t)stream>>>(org, zoff, dirs, rows, F,
                                                                     T, out);
  return (int)cudaGetLastError();
}
