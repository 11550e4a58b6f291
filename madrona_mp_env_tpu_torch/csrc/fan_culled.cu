// K6: shared-origin sensor fans vs each fan's PVS cell candidates.
//
// Replaces the TPU kernel madrona_mp_env_tpu/ops/raycast_pallas.py
// _make_fan_kernel_culled (via _get_fan_culled / ray_fans_culled_planar),
// the big-map fan that takes over when the soup has T >= 4 K triangles
// (its ops/raycast.py fan_cull_wins). Plain version: ops/raycast.py
// _ray_fans_culled_plain.
//
// What is not carried over: the TPU kernel takes the direction dots in
// bf16 on the MXU and divides with an approximate reciprocal; here the
// arithmetic is _ray_fans_dense's (csrc/tri_math.cuh order, --fmad=false):
// bit-equal to the plain version. The TPU kernel sorts fans by cell into
// 16-fan groups so that a block reads one [16, K] table slice
// (culling.agent_sorted_layout); here the wrapper may pass such an order
// (ops/raycast.py fan_cell_order), and the rows come through the
// read-only cache either way.
//
// Bound on the H100: sum over fans of F rays x the cell's valid candidates
// (town_map: 12288 x 104 x ~675 = 8.6e8 pairs per step) of ~32 f32
// operations, each its own instruction under --fmad=false, plus the hit
// test's compares: bound by instruction issue.
// Design (csrc/fan_sweep_rb.cuh): one thread per octet of 8 rays of one
// z-group, 8 minima in registers, the origin terms once per (octet, row).
// Each thread walks its own cell's slots up to span[cell] (1 + the last
// that holds a candidate, CellTables.valid_span); a -1 slot is skipped, a
// valid row is read as three 16-byte vectors through __ldg, one slot
// ahead of its sweep. Thread i takes octet i % (F / 8) of fan
// order[i / (F / 8)] (order [N], a permutation of the fans): with fans
// grouped by cell, a warp's lanes mostly walk one cell, load one row at
// a time and run the same count of slots, and with the cells of most
// candidates first (fan_cell_order below) the longest blocks start
// first. At most 85 registers: a 64-register cap spills the prefetched
// row. The interface is generic (cells [N], cand [C, K], span [C], the
// soup's [T, 16] rows).
//
// fan_culled_v1 is the earlier kernel (one block per fan, the cell's rows
// staged in tiles with the origin terms hoisted per (group, row) in shared
// memory, csrc/fan_sweep.cuh), kept as the predecessor chip_smoke.py times
// beside it.
#include "fan_sweep.cuh"
#include "fan_sweep_rb.cuh"

using namespace mpenv;

// threads per block: blocks of 4 warps spread the cells' uneven work
// finely over the SMs (measured faster than 2 or 8 warps on the H100,
// tools/fan_rb_probe.py)
constexpr int kCullThreads = 128;

__global__ void __launch_bounds__(kCullThreads, 6)
    fan_culled_rb_kernel(const float* __restrict__ org, const float* __restrict__ zg,
                         const float* __restrict__ dx, const float* __restrict__ dy,
                         const float* __restrict__ dz, const int* __restrict__ group_of_ray,
                         const float* __restrict__ rows, const int* __restrict__ cells,
                         const int* __restrict__ cand, const int* __restrict__ span,
                         const int* __restrict__ order, int N, int F, int G, int K,
                         float* __restrict__ out) {
  const int opf = F / kRbRays;
  const long long item = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (item >= (long long)N * opf) return;
  const int rank = (int)(item / opf), oct = (int)(item % opf);
  const int n = order[rank];
  const int c = cells[n];
  RbOctet r = rb_load(org, zg, dx, dy, dz, group_of_ray, n, oct, F, G);
  rb_sweep_list(r, rows, cand + (size_t)c * K, span[c]);
  rb_store(r, out, n, oct, F);
}

extern "C" int fan_culled_launch(const float* org, const float* zg, const float* dx,
                                 const float* dy, const float* dz, const int* group_of_ray,
                                 const float* rows, const int* cells, const int* cand,
                                 const int* span, const int* order, int N, int F, int G, int K,
                                 float* out, void* stream) {
  if (N <= 0) return 0;
  if (F <= 0 || F % kRbRays != 0 || K < 0 || order == nullptr) return (int)cudaErrorInvalidValue;
  const long long items = (long long)N * (F / kRbRays);
  const unsigned blocks = (unsigned)((items + kCullThreads - 1) / kCullThreads);
  fan_culled_rb_kernel<<<blocks, kCullThreads, 0, (cudaStream_t)stream>>>(
      org, zg, dx, dy, dz, group_of_ray, rows, cells, cand, span, order, N, F, G, K, out);
  return (int)cudaGetLastError();
}

// The fans in cell order, for fan_culled_rb_kernel, in one launch of one
// block: a counting sort of the keys rank[cells[n]] (rank a permutation
// of [0, C)) into order [N], the fans of key 0 first, then those of key
// 1, and so on. With rank the cells' places by decreasing candidate count
// (CellTables.heavy_rank), the blocks of the longest cells start first
// and the short ones fill the end of the grid. Within a key the fans come in the order the threads'
// shared-memory atomics land: the sweep's results do not depend on it.
// Plain version: ops/raycast.py _fan_cell_order_plain (a stable sort).
// The JAX package sorts the fans with an XLA argsort
// (madrona_mp_env_tpu/ops/culling.py agent_sorted_layout); torch.sort
// takes a dozen launches (cub's radix passes and their memsets) for the
// same grouping.
constexpr int kOrderThreads = 1024;

__global__ void __launch_bounds__(kOrderThreads)
    fan_cell_order_kernel(const int* __restrict__ cells, const int* __restrict__ rank, int N, int C,
                          int* __restrict__ order) {
  extern __shared__ int start[];  // [C]: counts, then each cell's next slot
  __shared__ int warp_sum[kOrderThreads / 32];
  __shared__ int carry;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int c = threadIdx.x; c < C; c += blockDim.x) start[c] = 0;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int n = threadIdx.x; n < N; n += blockDim.x)
    atomicAdd(&start[rank[cells[n]]], 1);
  __syncthreads();
  // exclusive prefix sum of the counts, kOrderThreads cells at a time
  for (int base = 0; base < C; base += blockDim.x) {
    const int c = base + threadIdx.x;
    const int v = c < C ? start[c] : 0;
    int x = v;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_sum[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int w = lane < (int)(blockDim.x >> 5) ? warp_sum[lane] : 0;
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, w, o);
        if (lane >= o) w += y;
      }
      warp_sum[lane] = w;  // inclusive over warps
    }
    __syncthreads();
    if (c < C) start[c] = carry + (warp > 0 ? warp_sum[warp - 1] : 0) + x - v;
    __syncthreads();
    if (threadIdx.x == 0) carry += warp_sum[31];
    __syncthreads();
  }
  for (int n = threadIdx.x; n < N; n += blockDim.x)
    order[atomicAdd(&start[rank[cells[n]]], 1)] = n;
}

extern "C" int fan_cell_order_launch(const int* cells, const int* rank, int N, int C, int* order,
                                     void* stream) {
  if (N <= 0) return 0;
  if (C <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)C * sizeof(int);
  cudaError_t e = allow_smem(fan_cell_order_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  fan_cell_order_kernel<<<1, kOrderThreads, smem, (cudaStream_t)stream>>>(cells, rank, N, C,
                                                                          order);
  return (int)cudaGetLastError();
}

__global__ void fan_culled_v1_kernel(const float* __restrict__ org, const float* __restrict__ zg,
                                     const float* __restrict__ dx, const float* __restrict__ dy,
                                     const float* __restrict__ dz,
                                     const int* __restrict__ group_of_ray,
                                     const float* __restrict__ rows,
                                     const int* __restrict__ cells, const int* __restrict__ cand,
                                     int F, int G, int K, float* __restrict__ out) {
  const size_t n = blockIdx.x, ray0 = n * F;
  fan_sweep(org[3 * n], org[3 * n + 1], org[3 * n + 2], zg + n * G, group_of_ray, G, dx + ray0,
            dy + ray0, dz + ray0, rows, cand + (size_t)cells[n] * K, K, F, out + ray0);
}

extern "C" int fan_culled_v1_launch(const float* org, const float* zg, const float* dx,
                                    const float* dy, const float* dz, const int* group_of_ray,
                                    const float* rows, const int* cells, const int* cand, int N,
                                    int F, int G, int K, float* out, void* stream) {
  if (N <= 0) return 0;
  size_t smem = fan_sweep_smem(G);
  cudaError_t e = allow_smem(fan_culled_v1_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  fan_culled_v1_kernel<<<N, kFanThreads, smem, (cudaStream_t)stream>>>(
      org, zg, dx, dy, dz, group_of_ray, rows, cells, cand, F, G, K, out);
  return (int)cudaGetLastError();
}
