// K4 and K8: sphere casts vs the triangle soup, three entries.
//
// Replaces the TPU kernels madrona_mp_env_tpu/ops/raycast_pallas.py
// _make_sc_kernel_planar_T + _sc_sweep_lanes (layout rowsT, via
// _get_sc_planar / sphere_cast_planar_pallas: the dense L2/L3/fall casts)
// and _make_sc_kernel_planar(culled=True) (via _get_sc_culled /
// sphere_cast_agent_culled: the short-table L1 batch; via _get_sc_packed /
// sphere_cast_packed, K4', the MOVE_MARGIN-table L2, L3 and fall casts:
// its 8-lane same-cell packing and pre-gathered per-block tables are TPU
// lane economics; the culled entry serves it as it serves L1), and
// K8, the row-major _make_sc_kernel + _sc_sweep_lanes (via _get_sc_flat /
// sphere_cast_vs_tris_pallas, which rebuilds the winner's contact normal
// outside its kernel with a one-hot matrix product). Plain versions:
// ops/raycast.py _sphere_cast_dense, _sphere_cast_culled_plain and
// _sphere_cast_normal_plain.
//
// Bound on the H100: casts x candidates pair tests of ~330 f32 operations
// (closest point on the triangle, the offset-plane face test, three edge
// capsules with vertex spheres: six square roots and ~10 divides, one
// dependent chain) from 24 bytes per cast in and 8 out (K8: 16 out): bound
// by operations. The table builders' cast battery (K4 dense): 8,192 casts
// x 6,144 rows = 5.0e7 pairs a launch, 0.25 ms at 67 TFLOP/s. Per step
// at 1024 worlds x 12 agents on simple_map: culled L1 7 x 12288 casts x
// the cell's K = 56 candidates = 4.8e6 pairs, packed L2 + L3 + fall 4 x
// 12288 x K_mv = 48 = 2.4e6 (the dense entry, now off the default path,
// 1.3e7). K8 at the kernel bench's 86,016 casts: 2.2e7 pairs on
// simple_map, 5.3e8 on town_map.
//
// Design of the dense entries (K4 dense, K8; sc_dense_kernel): the card is
// filled by splitting the rows, as K1 does (csrc/ray_tris.cu). A
// thread-block cluster of S <= 8 blocks (S chosen by the wrapper from T, R
// and the card's SM count, ops/raycast.py sc_split, and given at the
// launch: no planning pass) takes a tile of kScDenseThreads / kScParts =
// 64 casts, and block s of the cluster sweeps rows [s c, (s + 1) c), c =
// ceil(T / S); the kScParts = 2 threads of a cast split the rows of each
// staged tile, part p taking the rows i with i % 2 == p, so that a launch
// holds 2 R S threads. A thread keeps its cast and its (t, row) minimum in
// registers; the rows are staged by cp.async into a double buffer, kRbTile
// rows a tile, read as 16-byte vectors (csrc/fan_sweep_rb.cuh rb_stage); a
// padding row (valid = 0) is skipped, as its t is inf for every cast.
// Every (cast, row) pair is csrc/tri_math.cuh's sphere_tri, as in the
// predecessor: the same operations on the same operands, --fmad=false. A
// thread keeps the lexicographic minimum of (t, row) under sc_take's rule
// (csrc/sc_sweep.cuh); part 0 takes part 1's through shared memory, then
// block 0 of the cluster the other blocks' through distributed shared
// memory, under the same rule, and writes out: one launch, no pre-filled
// output, no scratch. On the H100 two threads a cast were faster than one
// (the predecessor, sphere_cast_dense_v1, is the one-thread-a-cast
// baseline) at every path's shape, and two casts a thread as independent
// chains slower (K8's spilled): PERF.md.
// Exactness: t is never NaN (every term of sphere_tri is guarded to inf,
// csrc/sc_sweep.cuh), so the lexicographic minimum of (t, row) over a set
// of pairs does not depend on the order in which they are swept or on
// how the rows are split over blocks and threads; it is the plain
// version's argmin (the nearest t, the lowest row among equal t, whose t
// bits it reports), and a miss (t = inf) reports row 0. K8's normal is
// computed once per cast, after the combine, by the thread (block 0, part
// 0) that writes the cast out: its winner row's terms again
// (csrc/tri_math.cuh sc_normal, the plain sc_normals_from_idx), 0 for a
// miss or a hit beyond t_max, whose t it reports as inf.
//
// The predecessor (sphere_cast_dense_kernel, the launches
// sphere_cast_dense_v1 and sphere_cast_normal_v1: one thread per cast,
// 128 threads a block, every block sweeping every row, staged 512 at a
// time by a scalar loop) stays, to be timed beside it. At the cast
// battery's 8,192 casts it made 64 blocks, 4 warps on each of 64 of the
// H100's 132 SMs, for a dependent chain of ~330 operations a pair.
//
// Design of the culled entry (K4 culled and K4', sc_culled_kernel): a
// group is one agent's cpa casts, which share a cell (cells[n]); a warp
// takes a group and its 32 lanes split the group's (slot, cast) pairs
// with stride 32, up to the cell's last candidate
// (ShortTables.valid_span; a -1 inside is skipped), so that a lane's
// share is even to one pair test whatever the cell's count. A pair reads
// its row as 16-byte vectors; the group's casts and each lane's (t, row)
// of each cast sit in shared memory; the lanes then combine (t, row)
// lexicographically by __shfl_xor_sync (csrc/sc_sweep.cuh, the exactness
// argument there). 128 threads a block, 4 groups: K4' at 12,288 casts
// launches 393,216 threads, not 12,288. 32 lanes a group were the fastest
// of 8, 16 and 32 on town_map's launches and on simple_map's from step 40
// on (PERF.md). A cpa above kScMaxCasts, or no span, returns
// cudaErrorInvalidValue. The predecessor (sphere_cast_culled_v1_kernel:
// one thread per cast, every one of the cell's K slots) stays, with its
// own launch, to be timed beside it.
#include "fan_sweep_rb.cuh"
#include "sc_sweep.cuh"
#include "tri_math.cuh"

namespace cg = cooperative_groups;
using namespace mpenv;

constexpr int kStage = 13;  // v0 e1 e2 n valid
constexpr int kScTile = 512;  // the predecessor: triangle rows staged per pass

__device__ __forceinline__ float cast_vs_row(V3 o, V3 d, float r, float rr, const float* t) {
  return sphere_tri(o, d, r, rr, load3(t), load3(t + 3), load3(t + 6), load3(t + 9),
                    t[12] > 0.0f);
}

// the predecessor of sc_dense_kernel: one thread per cast over every
// row; kNormal: K8, (t, normal) with t_max; else K4 dense, (t, winner row)
template <bool kNormal>
__global__ void sphere_cast_dense_kernel(const float* __restrict__ o, const float* __restrict__ d,
                                         const float* __restrict__ rows, float r, int T, int R,
                                         float t_max, int with_normal, float* __restrict__ t_out,
                                         int* __restrict__ idx_out, float* __restrict__ n_out) {
  extern __shared__ float s[];  // [kScTile][13]
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = c < R;
  V3 org = live ? load3(o + 3 * (size_t)c) : v3(0.0f, 0.0f, 0.0f);
  V3 dir = live ? load3(d + 3 * (size_t)c) : v3(0.0f, 0.0f, 0.0f);
  float rr = r * r;
  float best = CUDART_INF_F;
  int best_i = 0;
  for (int base = 0; base < T; base += kScTile) {
    const int nt = min(kScTile, T - base);
    __syncthreads();  // the previous tile's sweep is done with shared memory
    for (int i = threadIdx.x; i < nt; i += blockDim.x)
      for (int k = 0; k < kStage; ++k) s[i * kStage + k] = rows[(size_t)(base + i) * kRowCols + k];
    __syncthreads();
    if (!live) continue;
    for (int i = 0; i < nt; ++i) {
      float t = cast_vs_row(org, dir, r, rr, s + i * kStage);
      if (t < best) {
        best = t;
        best_i = base + i;
      }
    }
  }
  if (!live) return;
  if (!kNormal) {
    t_out[c] = best;
    idx_out[c] = best_i;
    return;
  }
  const bool missed = isinf(best) || best > t_max;
  t_out[c] = missed ? CUDART_INF_F : best;
  V3 nrm = v3(0.0f, 0.0f, 0.0f);
  if (!missed && with_normal) {
    const float* w = rows + (size_t)best_i * kRowCols;
    nrm = sc_normal(org, dir, r, rr, load3(w + kRowV0), load3(w + kRowE1), load3(w + kRowE2),
                    load3(w + kRowN), w[kRowValid] > 0.0f);
  }
  n_out[3 * (size_t)c] = nrm.x;
  n_out[3 * (size_t)c + 1] = nrm.y;
  n_out[3 * (size_t)c + 2] = nrm.z;
}

constexpr int kScDenseThreads = 128;  // dense entries: threads per block
constexpr int kScMaxSplit = 8;        // dense entries: blocks per cluster (the portable most)
constexpr int kScParts = 2;           // dense entries: threads per cast

// rows [base, base + n) of the [T, 16] table, staged kRbTile at a time
// into a double buffer by cp.async (the next tile lands while this one is
// swept): row(q, global row) for each valid row i of each tile with i %
// kScParts == part (q: its four staged float4). Every thread of the block
// calls it (it synchronises). Shared memory: rb_tiles_smem(n).
template <class Row>
__device__ __forceinline__ void sc_sweep_rows(const float* __restrict__ rows, int base, int n,
                                              int part, Row&& row) {
  extern __shared__ float4 sc_tile[];
  const int tiles = (n + kRbTile - 1) / kRbTile;
  rb_stage(sc_tile, rows, base, min(kRbTile, n));
  cp_async_commit();
  for (int k = 0; k < tiles; ++k) {
    const float4* cur = sc_tile + (size_t)(k & 1) * kRbTile * kRbRowVec;
    if (k + 1 < tiles) {
      const int next = (k + 1) * kRbTile;
      rb_stage(sc_tile + (size_t)((k + 1) & 1) * kRbTile * kRbRowVec, rows, base + next,
               min(kRbTile, n - next));
    }
    cp_async_commit();  // an empty group on the last tile keeps the count
    cp_async_wait_one();
    __syncthreads();  // every thread's copies of tile k have landed
    const int span = min(kRbTile, n - k * kRbTile);
    const int row0 = base + k * kRbTile;
    for (int i = part; i < span; i += kScParts) {
      const float4* q = cur + (size_t)i * kRbRowVec;
      if (q[3].x > 0.0f) row(q, row0 + i);
    }
    __syncthreads();  // the sweep is done with cur before tile k + 2 lands in it
  }
}

// K4 dense (kNormal false: t and winner row) and K8 (kNormal: t and the
// winner's contact normal, t beyond t_max a miss): two threads a cast (the
// block's 64 casts, thread i taking cast i % 64 and part i / 64 of the
// block's rows), the rows split over the blocks of a cluster, the (t, row)
// minima combined in part 0, then in block 0 of the cluster
template <bool kNormal>
__global__ void __launch_bounds__(kScDenseThreads)
    sc_dense_kernel(const float* __restrict__ o, const float* __restrict__ d,
                    const float* __restrict__ rows, float r, int T, int R, float t_max,
                    int with_normal, float* __restrict__ t_out, int* __restrict__ idx_out,
                    float* __restrict__ n_out) {
  constexpr int kCasts = kScDenseThreads / kScParts;  // casts a block
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int slot = threadIdx.x % kCasts, part = threadIdx.x / kCasts;
  const long long c = (long long)(blockIdx.x / S) * kCasts + slot;
  const float rr = r * r;

  // a thread past the last cast sweeps a copy of it and stores nothing
  const size_t ci = (size_t)min(c, (long long)R - 1);
  const V3 org = v3(o[3 * ci], o[3 * ci + 1], o[3 * ci + 2]);
  const V3 dir = v3(d[3 * ci], d[3 * ci + 1], d[3 * ci + 2]);
  float best = CUDART_INF_F;
  int best_row = INT_MAX;

  const int span = (T + S - 1) / S;
  const int base = min(T, rank * span);
  sc_sweep_rows(rows, base, min(T, base + span) - base, part, [&](const float4* q, int row) {
    sc_take(sphere_tri(org, dir, r, rr, v3(q[0].x, q[0].y, q[0].z), v3(q[0].w, q[1].x, q[1].y),
                       v3(q[1].z, q[1].w, q[2].x), v3(q[2].y, q[2].z, q[2].w), true),
            row, best, best_row);
  });

  // the block's minima in part 0, then the cluster's in block 0: the
  // partial minima sit in the staged tiles, free after the sweep (part 1's
  // at [0, kCasts), part 0's at [kCasts, 2 kCasts)), and block 0 reads the
  // other blocks' through distributed shared memory
  extern __shared__ float4 sc_tile[];
  float* part_t = reinterpret_cast<float*>(sc_tile);
  int* part_row = reinterpret_cast<int*>(part_t + kScDenseThreads);
  if (part == 1) {
    part_t[slot] = best;
    part_row[slot] = best_row;
  }
  __syncthreads();
  if (part == 0) sc_take(part_t[slot], part_row[slot], best, best_row);
  float* own_t = part_t + kCasts;
  int* own_row = part_row + kCasts;
  if (S > 1) {
    if (part == 0) {
      own_t[slot] = best;
      own_row[slot] = best_row;
    }
    cluster.sync();  // every block's minima are in its shared memory
    if (rank == 0 && part == 0) {
      for (int s = 1; s < S; ++s)
        sc_take(cluster.map_shared_rank(own_t, s)[slot], cluster.map_shared_rank(own_row, s)[slot],
                best, best_row);
    }
  }

  if (rank == 0 && part == 0 && c < R) {
    if constexpr (!kNormal) {
      t_out[c] = best;
      idx_out[c] = isinf(best) ? 0 : best_row;
    } else {
      const bool missed = isinf(best) || best > t_max;
      t_out[c] = missed ? CUDART_INF_F : best;
      V3 nrm = v3(0.0f, 0.0f, 0.0f);
      if (!missed && with_normal) {
        const float* w = rows + (size_t)best_row * kRowCols;
        nrm = sc_normal(org, dir, r, rr, load3(w + kRowV0), load3(w + kRowE1), load3(w + kRowE2),
                        load3(w + kRowN), w[kRowValid] > 0.0f);
      }
      n_out[3 * c] = nrm.x;
      n_out[3 * c + 1] = nrm.y;
      n_out[3 * c + 2] = nrm.z;
    }
  }
  // no block of a cluster leaves while block 0 reads its shared memory
  if (S > 1) cluster.sync();
}

// split: blocks per cluster (1 .. kScMaxSplit)
template <bool kNormal>
static int sc_dense_entry(const float* o, const float* d, const float* rows, float r, int T,
                          int R, int split, float t_max, int with_normal, float* t_out,
                          int* idx_out, float* n_out, void* stream) {
  if (R <= 0) return 0;
  if (T < 0 || split < 1 || split > kScMaxSplit) return (int)cudaErrorInvalidValue;
  constexpr int kCasts = kScDenseThreads / kScParts;
  const long long tiles = ((long long)R + kCasts - 1) / kCasts;
  const cudaError_t e = rb_launch_clusters(
      sc_dense_kernel<kNormal>, (unsigned)(tiles * split), kScDenseThreads,
      rb_tiles_smem((T + split - 1) / split), split, (cudaStream_t)stream, o, d, rows, r, T, R,
      t_max, with_normal, t_out, idx_out, n_out);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// the predecessor of sc_culled_kernel: one thread per cast over its
// cell's K slots
__global__ void sphere_cast_culled_v1_kernel(const float* __restrict__ o,
                                             const float* __restrict__ d,
                                             const float* __restrict__ rows, float r, int R,
                                             const int* __restrict__ cells,
                                             const int* __restrict__ cand, int K, int cpa,
                                             float* __restrict__ t_out,
                                             int* __restrict__ idx_out) {
  int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= R) return;
  V3 org = load3(o + 3 * (size_t)c);
  V3 dir = load3(d + 3 * (size_t)c);
  float rr = r * r;
  const int* cc = cand + (size_t)cells[c / cpa] * K;
  float best = CUDART_INF_F;
  int best_row = 0;
  for (int k = 0; k < K; ++k) {
    int row = cc[k];
    if (row < 0) continue;
    float t = cast_vs_row(org, dir, r, rr, rows + (size_t)row * kRowCols);
    if (t < best || (t == best && row < best_row)) {
      best = t;
      best_row = row;
    }
  }
  t_out[c] = best;
  idx_out[c] = best_row;
}

constexpr int kScThreads = 128;  // culled entry: threads per block
constexpr int kScGroups = kScThreads / 32;  // culled entry: groups (warps) per block
constexpr int kScMaxCasts = 8;  // culled entry: casts per group

// K4 culled / K4': N groups of cpa casts (o, d [N * cpa, 3]), group n
// against the slots [0, span[cells[n]]) of its cell's row of cand [cells,
// K]; the group's casts and each lane's (t, row) of each cast in shared
// memory
__global__ void __launch_bounds__(kScThreads)
    sc_culled_kernel(const float* __restrict__ o, const float* __restrict__ d,
                     const float* __restrict__ rows, float r, int N, int cpa,
                     const int* __restrict__ cells, const int* __restrict__ cand,
                     const int* __restrict__ span, int K, float* __restrict__ t_out,
                     int* __restrict__ idx_out) {
  const int lane = threadIdx.x & 31;
  const int gb = threadIdx.x / 32;
  const int g = blockIdx.x * kScGroups + gb;
  const bool live = g < N;  // every lane goes on: the lanes combine by shuffles
  const int cell = live ? __ldg(cells + g) : 0;
  const int n = live ? __ldg(span + cell) : 0;
  // the block's casts lie together: its groups' casts, cpa each
  constexpr int C = kScMaxCasts;
  __shared__ float s_o[kScGroups * C * 3], s_d[kScGroups * C * 3];
  __shared__ float s_t[C * kScThreads];
  __shared__ int s_row[C * kScThreads];
  const size_t b0 = (size_t)blockIdx.x * kScGroups * cpa;
  const int nb = min(kScGroups, N - (int)blockIdx.x * kScGroups) * cpa * 3;
  for (int i = threadIdx.x; i < nb; i += kScThreads) {
    s_o[i] = o[3 * b0 + i];
    s_d[i] = d[3 * b0 + i];
  }
  for (int j = 0; j < cpa; ++j) {
    s_t[j * kScThreads + threadIdx.x] = CUDART_INF_F;
    s_row[j * kScThreads + threadIdx.x] = INT_MAX;
  }
  __syncthreads();
  sc_pairs_split(s_o + 3 * gb * cpa, s_d + 3 * gb * cpa, s_t + threadIdx.x, s_row + threadIdx.x,
                 kScThreads, cpa, r, rows, cand + (size_t)cell * K, n, lane);
  const size_t c0 = (size_t)g * cpa;  // the group's first cast
  for (int j = 0; j < cpa; ++j) {
    float t = s_t[j * kScThreads + threadIdx.x];
    int row = s_row[j * kScThreads + threadIdx.x];
    sc_combine(t, row);
    if (live && lane == j) {  // 32 lanes >= kScMaxCasts >= cpa
      t_out[c0 + j] = t;
      idx_out[c0 + j] = isinf(t) ? 0 : row;
    }
  }
}

// K4 dense: (t, winner row) of R casts over the whole soup, the rows split
// over `split` blocks of a cluster
extern "C" int sphere_cast_launch(const float* o, const float* d, const float* rows, float r,
                                  int T, int R, int split, float* t_out, int* idx_out,
                                  void* stream) {
  return sc_dense_entry<false>(o, d, rows, r, T, R, split, INFINITY, 0, t_out, idx_out, nullptr,
                               stream);
}

// the predecessor of K4 dense: one thread per cast, every block over every
// row
extern "C" int sphere_cast_dense_v1_launch(const float* o, const float* d, const float* rows,
                                           float r, int T, int R, float* t_out, int* idx_out,
                                           void* stream) {
  if (R <= 0) return 0;
  const int threads = 128;
  unsigned blocks = (unsigned)((R + threads - 1) / threads);
  size_t smem = (size_t)min(T, kScTile) * kStage * sizeof(float);
  cudaError_t e = allow_smem(sphere_cast_dense_kernel<false>, smem);
  if (e != cudaSuccess) return (int)e;
  sphere_cast_dense_kernel<false><<<blocks, threads, smem, (cudaStream_t)stream>>>(
      o, d, rows, r, T, R, INFINITY, 0, t_out, idx_out, nullptr);
  return (int)cudaGetLastError();
}

// K4 culled / K4': N groups of cpa casts, a warp per group
extern "C" int sphere_cast_culled_launch(const float* o, const float* d, const float* rows,
                                         float r, int N, int cpa, const int* cells,
                                         const int* cand, const int* span, int K, float* t_out,
                                         int* idx_out, void* stream) {
  if (cpa < 1 || cpa > kScMaxCasts || span == nullptr || K < 0 || N < 0)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  const unsigned blocks = (unsigned)((N + kScGroups - 1) / kScGroups);
  sc_culled_kernel<<<blocks, kScThreads, 0, (cudaStream_t)stream>>>(
      o, d, rows, r, N, cpa, cells, cand, span, K, t_out, idx_out);
  return (int)cudaGetLastError();
}

// the predecessor: R casts, cast c of group c / cpa
extern "C" int sphere_cast_culled_v1_launch(const float* o, const float* d, const float* rows,
                                            float r, int R, const int* cells, const int* cand,
                                            int K, int cpa, float* t_out, int* idx_out,
                                            void* stream) {
  if (R <= 0) return 0;
  const int threads = 128;
  unsigned blocks = (unsigned)((R + threads - 1) / threads);
  sphere_cast_culled_v1_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      o, d, rows, r, R, cells, cand, K, cpa, t_out, idx_out);
  return (int)cudaGetLastError();
}

// K8: (t, contact normal [R, 3]) over the whole soup; t beyond t_max is a
// miss; with_normal == 0 writes zero normals; split as K4 dense's
extern "C" int sphere_cast_normal_launch(const float* o, const float* d, const float* rows, float r,
                                         int T, int R, int split, float t_max, int with_normal,
                                         float* t_out, float* n_out, void* stream) {
  return sc_dense_entry<true>(o, d, rows, r, T, R, split, t_max, with_normal, t_out, nullptr,
                              n_out, stream);
}

// the predecessor of K8: one thread per cast, every block over every row
extern "C" int sphere_cast_normal_v1_launch(const float* o, const float* d, const float* rows,
                                            float r, int T, int R, float t_max, int with_normal,
                                            float* t_out, float* n_out, void* stream) {
  if (R <= 0) return 0;
  const int threads = 128;
  unsigned blocks = (unsigned)((R + threads - 1) / threads);
  size_t smem = (size_t)min(T, kScTile) * kStage * sizeof(float);
  cudaError_t e = allow_smem(sphere_cast_dense_kernel<true>, smem);
  if (e != cudaSuccess) return (int)e;
  sphere_cast_dense_kernel<true><<<blocks, threads, smem, (cudaStream_t)stream>>>(
      o, d, rows, r, T, R, t_max, with_normal, t_out, nullptr, n_out);
  return (int)cudaGetLastError();
}
