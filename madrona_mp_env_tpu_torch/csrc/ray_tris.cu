// K1: nearest-hit rays vs the triangle soup (the hitscan of fire_system).
//
// Replaces the TPU kernel madrona_mp_env_tpu/ops/raycast_pallas.py
// _ray_kernel (via _ray_pallas_call / ray_vs_tris_pallas). Plain version:
// ops/raycast.py _ray_vs_tris_dense.
//
// Bound on the H100: the work is R rays x T triangles of ~47 f32 operations
// (two cross products, four dots, one reciprocal, three scales), from R * 24
// bytes in and R * 4 bytes out, so it is bound by operations: at the
// step's R = W * A = 12,288 rays on town_map's 6,144 triangles, 7.5e7
// pairs, a few tens of microseconds of issue.
// Design: every ray has its own origin, so nothing is hoisted per row; the
// card is filled by splitting the rows. A thread-block cluster of S <= 8
// blocks (S chosen by the wrapper from T and R, ops/raycast.py ray_split,
// and given at the launch: no planning pass) takes a tile of
// RPT * kRayThreads rays, and block s of the cluster sweeps rows [s c, (s
// + 1) c), c = ceil(T / S). A thread keeps RPT rays (strided by the block
// size: loads and stores coalesce) and their minima in registers, RPT
// independent chains per row; the rows are staged by cp.async into a
// double buffer, read as 16-byte vectors and swept kRayUnroll rows per
// unrolled step (csrc/fan_sweep_rb.cuh rb_sweep_tiles), each row's bound
// on |det| for the reciprocal's fast path computed once per block and
// tested once per thread for its rays (rb_fast, rb_pair). Then block 0 of the
// cluster takes the minimum of the S partial minima through distributed
// shared memory and writes out: one launch, no pre-filled output, no
// scratch. The nearest t is a minimum over positive floats and +inf, which
// depends neither on the order of the rows nor on their split, so the
// result stays bit-equal to the plain version's amin.
//
// ray_tris_v1 is the earlier kernel (one thread per ray, 128 threads per
// block, every block sweeping every row, 1 / det by IEEE division), kept as
// the predecessor chip_smoke.py times beside it.
#include "fan_sweep_rb.cuh"

namespace cg = cooperative_groups;
using namespace mpenv;

constexpr int kRayThreads = 128;  // threads per block
constexpr int kRayMaxSplit = 8;   // blocks per cluster (the portable most)
constexpr int kRayUnroll = 4;     // rows per unrolled step of the sweep

// RPT rays of their own origins
template <int RPT>
struct RayOwn {
  float ox[RPT], oy[RPT], oz[RPT], dx[RPT], dy[RPT], dz[RPT];
  float best[RPT];
  float dmax;  // 8 max |d| over the rays' direction components
};

template <int RPT>
struct RayRowFn {
  RayOwn<RPT>& r;
  template <bool Fast>
  __device__ __forceinline__ void rays(V3 v0, V3 e1, V3 e2) const {
#pragma unroll
    for (int j = 0; j < RPT; ++j)
      r.best[j] = rb_pair<Fast>(v3(r.ox[j], r.oy[j], r.oz[j]), v3(r.dx[j], r.dy[j], r.dz[j]), v0,
                                e1, e2, r.best[j]);
  }
  __device__ __forceinline__ void operator()(const float4* q) const {
    const V3 v0 = v3(q[0].x, q[0].y, q[0].z), e1 = v3(q[0].w, q[1].x, q[1].y),
             e2 = v3(q[1].z, q[1].w, q[2].x);
    if (rb_fast(rb_staged_bound(q), r.dmax))
      this->template rays<true>(v0, e1, e2);
    else
      this->template rays<false>(v0, e1, e2);
  }
};

template <int RPT>
__global__ void __launch_bounds__(kRayThreads)
    ray_tris_rb_kernel(const float* __restrict__ o, const float* __restrict__ d,
                       const float* __restrict__ rows, int T, int R, float* __restrict__ out) {
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const long long r0 = (long long)(blockIdx.x / S) * (RPT * kRayThreads) + threadIdx.x;

  RayOwn<RPT> r;
  float m = 0.0f;
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    const size_t ray = (size_t)min(r0 + (long long)j * kRayThreads, (long long)R - 1);
    r.ox[j] = o[3 * ray];
    r.oy[j] = o[3 * ray + 1];
    r.oz[j] = o[3 * ray + 2];
    r.dx[j] = d[3 * ray];
    r.dy[j] = d[3 * ray + 1];
    r.dz[j] = d[3 * ray + 2];
    r.best[j] = CUDART_INF_F;
    m = fmaxf(m, max_abs3(v3(r.dx[j], r.dy[j], r.dz[j])));
  }
  r.dmax = 8.0f * m;

  rb_sweep_split<kRayUnroll, true>(rows, T, RayRowFn<RPT>{r});
  rb_cluster_min(r.best);
  if (rank == 0) {
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const long long ray = r0 + (long long)j * kRayThreads;
      if (ray < R) out[ray] = r.best[j];
    }
  }
  rb_cluster_done();
}

template <int RPT>
static cudaError_t ray_tris_rb_launch(const float* o, const float* d, const float* rows, int T,
                                      int R, int split, float* out, cudaStream_t stream) {
  const long long tiles = ((long long)R + RPT * kRayThreads - 1) / (RPT * kRayThreads);
  return rb_launch_clusters(ray_tris_rb_kernel<RPT>, (unsigned)(tiles * split), kRayThreads,
                            rb_tiles_smem((T + split - 1) / split), split, stream, o, d, rows,
                            T, R, out);
}

// split: blocks per cluster (1 .. kRayMaxSplit); rays: per thread (1, 2 or
// 4)
extern "C" int ray_tris_launch(const float* o, const float* d, const float* rows, int T, int R,
                               int split, int rays, float* out, void* stream) {
  if (R <= 0) return 0;
  if (T < 0 || split < 1 || split > kRayMaxSplit) return (int)cudaErrorInvalidValue;
  cudaError_t e;
  const cudaStream_t s = (cudaStream_t)stream;
  if (rays == 1)
    e = ray_tris_rb_launch<1>(o, d, rows, T, R, split, out, s);
  else if (rays == 2)
    e = ray_tris_rb_launch<2>(o, d, rows, T, R, split, out, s);
  else if (rays == 4)
    e = ray_tris_rb_launch<4>(o, d, rows, T, R, split, out, s);
  else
    return (int)cudaErrorInvalidValue;
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

constexpr int kRayTile = 1024;  // ray_tris_v1: triangle rows staged per pass

__global__ void ray_tris_v1_kernel(const float* __restrict__ o, const float* __restrict__ d,
                                   const float* __restrict__ rows, int T, int R,
                                   float* __restrict__ out) {
  extern __shared__ float s[];  // [kRayTile][10]: v0 e1 e2 valid
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = r < R;
  V3 org = live ? load3(o + 3 * (size_t)r) : v3(0.0f, 0.0f, 0.0f);
  V3 dir = live ? load3(d + 3 * (size_t)r) : v3(0.0f, 0.0f, 0.0f);
  float best = CUDART_INF_F;
  for (int base = 0; base < T; base += kRayTile) {
    const int nt = min(kRayTile, T - base);
    __syncthreads();  // the previous tile's sweep is done with shared memory
    for (int i = threadIdx.x; i < nt; i += blockDim.x) {
      const float* row = rows + (size_t)(base + i) * kRowCols;
      for (int k = 0; k < 9; ++k) s[i * 10 + k] = row[kRowV0 + k];
      s[i * 10 + 9] = row[kRowValid];
    }
    __syncthreads();
    if (!live) continue;
    for (int i = 0; i < nt; ++i) {
      const float* t = s + i * 10;
      float ti = ray_tri(org, dir, load3(t), load3(t + 3), load3(t + 6), t[9] > 0.0f);
      best = min2(best, ti);
    }
  }
  if (live) out[r] = best;
}

extern "C" int ray_tris_v1_launch(const float* o, const float* d, const float* rows, int T, int R,
                                  float* out, void* stream) {
  if (R <= 0) return 0;
  const int threads = 128;
  size_t smem = (size_t)min(T, kRayTile) * 10 * sizeof(float);
  cudaError_t e = allow_smem(ray_tris_v1_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  ray_tris_v1_kernel<<<(R + threads - 1) / threads, threads, smem, (cudaStream_t)stream>>>(
      o, d, rows, T, R, out);
  return (int)cudaGetLastError();
}
