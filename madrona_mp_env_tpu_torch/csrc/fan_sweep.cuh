// One sensor fan (one block) swept over a list of triangle rows, tiled.
//
// Shared by K2 (csrc/fan_tris.cu: every row of the soup), K6
// (csrc/fan_culled.cu: the fan's PVS cell candidates), K9
// (csrc/fan_v9.cu: the fan's sensor-ray table candidates) and K7
// (csrc/fan_flat.cu: every row of the soup, stacked directions). All rays of a
// z-group share their origin, so the origin terms of Moller-Trumbore
// (tvec = o - v0, qvec = tvec x e1 and e2 . qvec) are computed once per
// (group, row) into shared memory, as the TPU kernels hoist them; each
// thread then sweeps its rays over the tile with only the direction terms
// left. The rows are staged kFanTile at a time, so the shared memory is
// kFanTile * (7 + 7 min(G, kHoistGroups)) floats whatever the number of
// rows (a big map's 6,144 triangles would need 1 MB at once); a fan with
// more than kHoistGroups groups hoists them kHoistGroups at a time, each
// ray swept in its own group's pass. Rows of -1 (candidate padding) are
// dropped while staging: a tile keeps its valid rows packed at the front
// through a shared counter, in whatever order the threads arrive. The
// nearest t is a minimum, which depends on neither the order nor the
// tiling, so the result stays bit-equal to the plain version's amin over
// the same rows.
#pragma once

#include "tri_math.cuh"

namespace mpenv {

constexpr int kFanTile = 128;  // rows staged per pass
constexpr int kFanThreads = 128;
constexpr int kHoistGroups = 8;  // z-groups hoisted per pass

__host__ __device__ inline int hoisted_groups(int G) {
  return G < kHoistGroups ? G : kHoistGroups;
}

__host__ __device__ inline size_t fan_sweep_smem(int G) {
  return (size_t)kFanTile * (7 + 7 * hoisted_groups(G)) * sizeof(float) +
         (size_t)kFanTile * sizeof(int);
}

// The runs of bitwise-equal z offsets among one fan's F rays (zoff: the
// fan's per-ray offsets), found with a warp-ballot prefix count: each
// ray's run goes to group_of_ray[f], each run's offset to zg[g]. Returns
// the number of runs. Every thread of the block (kFanThreads) calls it.
__device__ inline int find_runs(const float* __restrict__ zoff, int F, int* group_of_ray,
                                float* zg) {
  __shared__ int warp_total[kFanThreads / 32];
  __shared__ int runs;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) runs = 0;
  __syncthreads();
  for (int base = 0; base < F; base += kFanThreads) {
    const int f = base + threadIdx.x;
    const bool starts =
        f < F && (f == 0 || __float_as_uint(zoff[f]) != __float_as_uint(zoff[f - 1]));
    const unsigned m = __ballot_sync(0xffffffffu, starts);
    if (lane == 31) warp_total[warp] = __popc(m);
    __syncthreads();
    int g = runs - 1 + __popc(m & (0xffffffffu >> (31 - lane)));
    for (int w = 0; w < warp; ++w) g += warp_total[w];
    if (f < F) {
      group_of_ray[f] = g;
      if (starts) zg[g] = zoff[f];
    }
    __syncthreads();
    if (threadIdx.x == 0)
      for (int w = 0; w < kFanThreads / 32; ++w) runs += warp_total[w];
    __syncthreads();
  }
  return runs;
}

// One fan: its F rays start at (ox, oy, oz + zg[group_of_ray[f]]) along
// (dx, dy, dz)[DS * f] (pointers already at the fan's first ray; DS = 1
// for direction planes, 3 for stacked [F, 3] directions), G groups; row
// k of the sweep is cand[k] (cand == nullptr: row k itself), k < count.
// Writes the nearest t (inf on a miss) to out[0 .. F). zg and
// group_of_ray may point into shared memory beyond fan_sweep_smem(G).
template <int DS = 1>
__device__ inline void fan_sweep(float ox, float oy, float oz, const float* zg,
                                 const int* group_of_ray, int G, const float* __restrict__ dx,
                                 const float* __restrict__ dy, const float* __restrict__ dz,
                                 const float* __restrict__ rows, const int* __restrict__ cand,
                                 int count, int F, float* __restrict__ out) {
  extern __shared__ float s[];
  const int GH = hoisted_groups(G);
  float* e1s = s;                           // [kFanTile][3]
  float* e2s = e1s + 3 * kFanTile;          // [kFanTile][3]
  float* valid = e2s + 3 * kFanTile;        // [kFanTile]
  float* hoist = valid + kFanTile;          // [GH][kFanTile][7]: tvec qvec e2.qvec
  int* row_of = (int*)(hoist + 7 * GH * kFanTile);  // [kFanTile]
  __shared__ int n_staged;

  for (int f = threadIdx.x; f < F; f += blockDim.x) out[f] = CUDART_INF_F;
  for (int base = 0; base < count; base += kFanTile) {
    const int span = min(kFanTile, count - base);
    __syncthreads();  // the previous tile's sweep is done with shared memory
    if (threadIdx.x == 0) n_staged = 0;
    __syncthreads();
    for (int i = threadIdx.x; i < span; i += blockDim.x) {
      const int row = cand ? cand[base + i] : base + i;
      if (row < 0) continue;
      const int slot = atomicAdd(&n_staged, 1);
      const float* r = rows + (size_t)row * kRowCols;
      for (int k = 0; k < 3; ++k) {
        e1s[3 * slot + k] = r[kRowE1 + k];
        e2s[3 * slot + k] = r[kRowE2 + k];
      }
      valid[slot] = r[kRowValid];
      row_of[slot] = row;
    }
    __syncthreads();
    const int nt = n_staged;
    for (int g0 = 0; g0 < G; g0 += GH) {
      const int gn = min(GH, G - g0);
      if (g0 > 0) __syncthreads();  // the previous pass's sweep is done with hoist
      for (int j = threadIdx.x; j < gn * nt; j += blockDim.x) {
        const int g = j / nt, i = j % nt;
        // origins + (0, 0, zoff), as the plain version builds it
        V3 o = v3(ox + 0.0f, oy + 0.0f, oz + zg[g0 + g]);
        V3 tvec = o - load3(rows + (size_t)row_of[i] * kRowCols + kRowV0);
        V3 qvec = cross(tvec, load3(e1s + 3 * i));
        float* h = hoist + ((size_t)g * kFanTile + i) * 7;
        h[0] = tvec.x; h[1] = tvec.y; h[2] = tvec.z;
        h[3] = qvec.x; h[4] = qvec.y; h[5] = qvec.z;
        h[6] = dot(load3(e2s + 3 * i), qvec);
      }
      __syncthreads();
      for (int f = threadIdx.x; f < F; f += blockDim.x) {
        const int g = group_of_ray[f] - g0;
        if (g < 0 || g >= gn) continue;
        V3 d = v3(dx[DS * f], dy[DS * f], dz[DS * f]);
        const float* hg = hoist + (size_t)g * kFanTile * 7;
        float best = out[f];
        for (int i = 0; i < nt; ++i) {
          const float* h = hg + i * 7;
          V3 pvec = cross(d, load3(e2s + 3 * i));
          float det = dot(load3(e1s + 3 * i), pvec);
          bool det_ok = fabsf(det) > 1e-12f;
          float inv_det = det_ok ? 1.0f / det : 0.0f;
          float u = dot(load3(h), pvec) * inv_det;
          float v = dot(d, load3(h + 3)) * inv_det;
          float t = h[6] * inv_det;
          bool hit = det_ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > 0.0f &&
                     valid[i] > 0.0f;
          best = min2(best, sel_inf(hit, t));
        }
        out[f] = best;
      }
    }
  }
}

}  // namespace mpenv
