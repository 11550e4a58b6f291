// One sensor fan (one block) swept over a list of triangle rows, tiled.
//
// Shared by K2 (csrc/fan_tris.cu: every row of the soup) and K6
// (csrc/fan_culled.cu: the fan's PVS cell candidates). All rays of a
// z-group share their origin, so the origin terms of Moller-Trumbore
// (tvec = o - v0, qvec = tvec x e1 and e2 . qvec) are computed once per
// (group, row) into shared memory, as the TPU kernels hoist them; each
// thread then sweeps its rays over the tile with only the direction terms
// left. The rows are staged kFanTile at a time, so the shared memory is
// kFanTile * (7 + 7G) floats whatever the number of rows (a big map's
// 6,144 triangles would need 1 MB at once). Rows of -1 (candidate
// padding) are dropped while staging: a tile keeps its valid rows packed
// at the front through a shared counter, in whatever order the threads
// arrive. The nearest t is a minimum, which depends on neither the order
// nor the tiling, so the result stays bit-equal to the plain version's
// amin over the same rows.
#pragma once

#include "tri_math.cuh"

namespace mpenv {

constexpr int kFanTile = 128;  // rows staged per pass
constexpr int kFanThreads = 128;

__host__ inline size_t fan_sweep_smem(int G) {
  return (size_t)kFanTile * (7 + 7 * G) * sizeof(float) + (size_t)kFanTile * sizeof(int);
}

// Fan n: its F rays start at org[n] + (0, 0, zg[n, group_of_ray[f]]) along
// (dx, dy, dz)[n, f]; row k of the sweep is cand[k] (cand == nullptr: row
// k itself), k < count. Writes the nearest t (inf on a miss) to out[n, :].
__device__ inline void fan_sweep(int n, const float* __restrict__ org,
                                 const float* __restrict__ zg, const float* __restrict__ dx,
                                 const float* __restrict__ dy, const float* __restrict__ dz,
                                 const int* __restrict__ group_of_ray,
                                 const float* __restrict__ rows, const int* __restrict__ cand,
                                 int count, int F, int G, float* __restrict__ out) {
  extern __shared__ float s[];
  float* e1s = s;                           // [kFanTile][3]
  float* e2s = e1s + 3 * kFanTile;          // [kFanTile][3]
  float* valid = e2s + 3 * kFanTile;        // [kFanTile]
  float* hoist = valid + kFanTile;          // [G][kFanTile][7]: tvec qvec e2.qvec
  int* row_of = (int*)(hoist + 7 * G * kFanTile);  // [kFanTile]
  __shared__ int n_staged;

  const float ox = org[3 * n], oy = org[3 * n + 1], oz = org[3 * n + 2];
  for (int f = threadIdx.x; f < F; f += blockDim.x) out[(size_t)n * F + f] = CUDART_INF_F;
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
    for (int j = threadIdx.x; j < G * nt; j += blockDim.x) {
      const int g = j / nt, i = j % nt;
      // origins + (0, 0, zoff), as the plain version builds it
      V3 o = v3(ox + 0.0f, oy + 0.0f, oz + zg[(size_t)n * G + g]);
      V3 tvec = o - load3(rows + (size_t)row_of[i] * kRowCols + kRowV0);
      V3 qvec = cross(tvec, load3(e1s + 3 * i));
      float* h = hoist + ((size_t)g * kFanTile + i) * 7;
      h[0] = tvec.x; h[1] = tvec.y; h[2] = tvec.z;
      h[3] = qvec.x; h[4] = qvec.y; h[5] = qvec.z;
      h[6] = dot(load3(e2s + 3 * i), qvec);
    }
    __syncthreads();
    for (int f = threadIdx.x; f < F; f += blockDim.x) {
      const size_t ray = (size_t)n * F + f;
      V3 d = v3(dx[ray], dy[ray], dz[ray]);
      const float* hg = hoist + (size_t)group_of_ray[f] * kFanTile * 7;
      float best = out[ray];
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
      out[ray] = best;
    }
  }
}

}  // namespace mpenv
