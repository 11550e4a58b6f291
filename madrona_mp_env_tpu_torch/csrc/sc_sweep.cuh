// The culled sphere-cast sweeps: the lanes of a warp split one cell's
// candidate rows and take the nearest hit of each cast by a lexicographic
// minimum of (t, row).
//
// Two callers: K4 culled / K4' (csrc/sphere_cast.cu sc_culled_kernel: a
// warp per group of one agent's casts, sc_pairs_split) and the fused
// movement probe P3 (csrc/move_fused.cu: a warp per cast, warp_cast).
//
// Exactness: every (cast, row) pair is csrc/tri_math.cuh's sphere_tri
// (sc_pair's t_tri), the same operations on the same operands whatever
// the caller. A lane keeps the lexicographic minimum of (t, row) over the
// rows it swept, t < best || (t == best && row < best_row); lanes combine
// by __shfl_xor_sync under the same rule. t is never NaN (every term of
// sc_pair is guarded to inf), so the minimum ignores the order in which
// the rows are swept and how they are split over lanes: the result is the
// plain version's (nearest t, lowest global row among equal t), and a
// miss (t = inf) reports row 0.
#pragma once

#include <climits>

#include "tri_math.cuh"

namespace mpenv {

constexpr unsigned kFullMask = 0xffffffffu;

// (t, row) replaces (best, best_row) when it is nearer, or as near with a
// lower row
__device__ __forceinline__ void sc_take(float t, int row, float& best, int& best_row) {
  if (t < best || (t == best && row < best_row)) {
    best = t;
    best_row = row;
  }
}

// the lexicographic minimum over the warp; every lane ends with it
__device__ __forceinline__ void sc_combine(float& best, int& best_row) {
  for (int off = 16; off > 0; off >>= 1) {
    const float t2 = __shfl_xor_sync(kFullMask, best, off);
    const int r2 = __shfl_xor_sync(kFullMask, best_row, off);
    sc_take(t2, r2, best, best_row);
  }
}

struct Hit {
  float t;
  int row;
  int n;  // the valid rows this lane swept
};

// P3: the nearest hit of one sphere cast over the rows cand[0 .. count)
// (cand == nullptr: rows 0 .. count), every lane of the warp a stride-32
// share; each lane returns the warp's (t, row): the lowest row among
// equal t, row 0 on a miss. -1 candidates are padding.
__device__ __noinline__ Hit warp_cast(V3 o, V3 d, float r, const float* __restrict__ rows,
                                      const int* __restrict__ cand, int count) {
  const int lane = threadIdx.x & 31;
  const float rr = r * r;
  float best = CUDART_INF_F;
  int best_row = INT_MAX, n = 0;
  for (int k = lane; k < count; k += 32) {
    const int row = cand ? __ldg(cand + k) : k;
    if (row < 0) continue;
    const float* w = rows + (size_t)row * kRowCols;
    n += __ldg(w + kRowValid) > 0.0f;
    const float t = sphere_tri(o, d, r, rr, v3(__ldg(w), __ldg(w + 1), __ldg(w + 2)),
                               v3(__ldg(w + 3), __ldg(w + 4), __ldg(w + 5)),
                               v3(__ldg(w + 6), __ldg(w + 7), __ldg(w + 8)),
                               v3(__ldg(w + 9), __ldg(w + 10), __ldg(w + 11)),
                               __ldg(w + kRowValid) > 0.0f);
    sc_take(t, row, best, best_row);
  }
  sc_combine(best, best_row);
  return {best, isinf(best) ? 0 : best_row, n};
}

// K4 culled / K4': one cast o, d against one row of the soup's [T, 16]
// table, read as three 16-byte vectors ((v0, e1.x), (e1.y, e1.z, e2.x,
// e2.y), (e2.z, n)) and its valid flag (float 12)
__device__ __forceinline__ float sc_row_tri(V3 o, V3 d, float r, float rr,
                                            const float* __restrict__ rows, int row) {
  const float* p = rows + (size_t)row * kRowCols;
  const float4* q = reinterpret_cast<const float4*>(p);
  const float4 a = __ldg(q), b = __ldg(q + 1), c = __ldg(q + 2);
  return sphere_tri(o, d, r, rr, v3(a.x, a.y, a.z), v3(a.w, b.x, b.y), v3(b.z, b.w, c.x),
                    v3(c.y, c.z, c.w), __ldg(p + kRowValid) > 0.0f);
}

// K4 culled / K4': the warp's lanes take the group's (slot, cast) pairs p
// = lane, lane + 32, ... < span * nc, slot p / nc of one cell (cand: the
// cell's K slots, -1 padding) against cast p % nc, so that the lanes'
// shares differ by one pair test at most whatever the cell's count. The
// casts are o[3 j .. 3 j + 3), d[...]; the lane's (t, row) of cast j is at
// t[j * stride], best_row[j * stride]: shared memory, so that the cast
// loop stays one pair test a pass (on the H100 the L1 batch ran 1.4-1.9x
// slower with its 7 casts unrolled and the minima in registers: PERF.md).
__device__ __forceinline__ void sc_pairs_split(const float* o, const float* d, float* t,
                                               int* best_row, int stride, int nc, float r,
                                               const float* __restrict__ rows,
                                               const int* __restrict__ cand, int span, int lane) {
  const float rr = r * r;
  const int np = span * nc;
  for (int p = lane; p < np; p += 32) {
    const int k = p / nc;
    const int j = p - k * nc;
    const int row = __ldg(cand + k);
    if (row < 0) continue;
    sc_take(sc_row_tri(load3(o + 3 * j), load3(d + 3 * j), r, rr, rows, row), row,
            t[j * stride], best_row[j * stride]);
  }
}

}  // namespace mpenv
