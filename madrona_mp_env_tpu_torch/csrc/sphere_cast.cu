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
// Bound on the H100: casts x candidates pair tests of ~200 f32 operations
// (closest point on the triangle, the offset-plane face test, three edge
// capsules with vertex spheres: six square roots and ~10 divides) from 24
// bytes per cast in and 8 out (K8: 16 out): bound by operations. Per step
// at 1024 worlds x 12 agents on simple_map: culled L1 7 x 12288 casts x
// the cell's K = 56 candidates = 4.8e6 pairs, packed L2 + L3 + fall 4 x
// 12288 x K_mv = 48 = 2.4e6 (the dense entry, now off the default path,
// 1.3e7). K8 at the kernel bench's 86,016 casts: 2.2e7 pairs on
// simple_map, 5.3e8 on town_map.
//
// Design of the dense entries (K4 dense, K8): one thread per cast; the
// block stages the triangle rows (v0 e1 e2 n valid) in shared memory
// kScTile at a time, in order, and every thread sweeps each tile. They
// keep the nearest t and the lowest global row among equal t (the dense
// sweep's argmin); a miss reports row 0, as that argmin does. K8's
// thread, once it holds its winner row, recomputes that row's terms and
// writes the contact normal (csrc/tri_math.cuh sc_normal, the plain
// sc_normals_from_idx), 0 for a miss or a hit beyond t_max, whose t it
// reports as inf.
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
#include "sc_sweep.cuh"
#include "tri_math.cuh"

using namespace mpenv;

constexpr int kStage = 13;  // v0 e1 e2 n valid
constexpr int kScTile = 512;  // dense entry: triangle rows staged per pass

__device__ __forceinline__ float cast_vs_row(V3 o, V3 d, float r, float rr, const float* t) {
  return sphere_tri(o, d, r, rr, load3(t), load3(t + 3), load3(t + 6), load3(t + 9),
                    t[12] > 0.0f);
}

// kNormal: K8, (t, normal) with t_max; else K4 dense, (t, winner row)
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

// K4 dense: (t, winner row) of R casts over the whole soup
extern "C" int sphere_cast_launch(const float* o, const float* d, const float* rows, float r,
                                  int T, int R, float* t_out, int* idx_out, void* stream) {
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
// miss; with_normal == 0 writes zero normals
extern "C" int sphere_cast_normal_launch(const float* o, const float* d, const float* rows, float r,
                                         int T, int R, float t_max, int with_normal, float* t_out,
                                         float* n_out, void* stream) {
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
