// K4 and K8: sphere casts vs the triangle soup, three entries.
//
// Replaces the TPU kernels madrona_mp_env_tpu/ops/raycast_pallas.py
// _make_sc_kernel_planar_T + _sc_sweep_lanes (layout rowsT, via
// _get_sc_planar / sphere_cast_planar_pallas: the dense L2/L3/fall casts)
// and _make_sc_kernel_planar(culled=True) (via _get_sc_culled /
// sphere_cast_agent_culled: the short-table L1 batch; via _get_sc_packed /
// sphere_cast_packed, K4', the MOVE_MARGIN-table L2, L3 and fall casts:
// its 8-lane same-cell packing is TPU lane economics with no counterpart
// at one thread per cast, so the culled entry serves it as it is), and
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
// Design: one thread per cast. Dense entries (cells == nullptr, and K8):
// the block stages the triangle rows (v0 e1 e2 n valid) in shared memory
// kScTile at a time, in order, and every thread sweeps each tile. Culled
// entry: cast c of group c / cpa sweeps only the K candidate rows of its
// group's cell (cand[cell * K + k], -1 padding), reading the triangle
// rows straight from the table (L1-cached). All keep the nearest t and
// the lowest global row among equal t (the dense sweep's argmin); a miss
// reports row 0, as that argmin does. K8's thread, once it holds its
// winner row, recomputes that row's terms and writes the contact normal
// (csrc/tri_math.cuh sc_normal, the plain sc_normals_from_idx), 0 for a
// miss or a hit beyond t_max, whose t it reports as inf.
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

__global__ void sphere_cast_culled_kernel(const float* __restrict__ o, const float* __restrict__ d,
                                          const float* __restrict__ rows, float r, int R,
                                          const int* __restrict__ cells,
                                          const int* __restrict__ cand, int K, int cpa,
                                          float* __restrict__ t_out, int* __restrict__ idx_out) {
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

extern "C" int sphere_cast_launch(const float* o, const float* d, const float* rows, float r,
                                  int T, int R, const int* cells, const int* cand, int K, int cpa,
                                  float* t_out, int* idx_out, void* stream) {
  if (R <= 0) return 0;
  const int threads = 128;
  unsigned blocks = (unsigned)((R + threads - 1) / threads);
  cudaStream_t st = (cudaStream_t)stream;
  if (cells == nullptr) {
    size_t smem = (size_t)min(T, kScTile) * kStage * sizeof(float);
    cudaError_t e = allow_smem(sphere_cast_dense_kernel<false>, smem);
    if (e != cudaSuccess) return (int)e;
    sphere_cast_dense_kernel<false><<<blocks, threads, smem, st>>>(
        o, d, rows, r, T, R, INFINITY, 0, t_out, idx_out, nullptr);
  } else {
    sphere_cast_culled_kernel<<<blocks, threads, 0, st>>>(o, d, rows, r, R, cells, cand, K, cpa,
                                                          t_out, idx_out);
  }
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
