// One sensor fan (one block) swept over a list of triangle rows, tiled.
//
// Shared by K9 (csrc/fan_v9.cu: the fan's sensor-ray table candidates),
// the probes P5 and P6 (csrc/fan_v9.cu: K9 on gathered tables, and its
// candidates staged 8 at a time) and P2 (csrc/fan_probe.cu: every row of
// the soup, the part variants below), and by the predecessors of K6 and
// K7 kept for timing, fan_culled_v1 (csrc/fan_culled.cu: the fan's PVS
// cell candidates) and fan_flat_v1 (csrc/fan_flat.cu: every row of the
// soup, stacked directions); K2, K6, K7 and K1 sweep on
// csrc/fan_sweep_rb.cuh. All rays of a z-group share their origin, so the origin terms of Moller-Trumbore
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
//
// The probes P2 and P6 (csrc/fan_probe.cu, csrc/fan_v9.cu) take the same
// sweep with a pair policy and a staging tile other than the default:
// FanExact (1 / det by IEEE division, the shipped kernels' arithmetic),
// FanRcpIeee (the correctly rounded reciprocal instruction: the same
// value), FanRcpApprox (rcp.approx), FanDotsOnly (the direction dots and
// a minimum, no epilogue) and FanEpilogueOnly (the epilogue on dots read
// per row from a [T, 4] buffer), and tiles of kTile rows (8: the
// candidates chunked eight at a time). K9, P5, fan_culled_v1 and
// fan_flat_v1 take the defaults.
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

// A pair policy's pair(d, e1, e2, h, valid, aux, row): the value whose
// minimum the sweep keeps for one (ray, row) pair; d the ray's direction,
// e1 e2 the row's edges, h its hoisted origin terms (tvec, qvec, e2 .
// qvec) for the ray's group, aux the probe buffer (FanEpilogueOnly), row
// the soup row. fan_pair_t: K2's Moller-Trumbore epilogue with 1 / det
// taken by Inv.
template <class Inv>
__device__ __forceinline__ float fan_pair_t(V3 d, V3 e1, V3 e2, const float* h, bool valid) {
  V3 pvec = cross(d, e2);
  float det = dot(e1, pvec);
  bool det_ok = fabsf(det) > 1e-12f;
  float inv_det = det_ok ? Inv::inv(det) : 0.0f;
  float u = dot(load3(h), pvec) * inv_det;
  float v = dot(d, load3(h + 3)) * inv_det;
  float t = h[6] * inv_det;
  bool hit = det_ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > 0.0f && valid;
  return sel_inf(hit, t);
}

struct FanExact {
  static __device__ __forceinline__ float inv(float det) { return 1.0f / det; }
  static __device__ __forceinline__ float pair(V3 d, V3 e1, V3 e2, const float* h, bool valid,
                                               const float*, int) {
    return fan_pair_t<FanExact>(d, e1, e2, h, valid);
  }
};

struct FanRcpIeee {
  static __device__ __forceinline__ float inv(float det) { return __frcp_rn(det); }
  static __device__ __forceinline__ float pair(V3 d, V3 e1, V3 e2, const float* h, bool valid,
                                               const float*, int) {
    return fan_pair_t<FanRcpIeee>(d, e1, e2, h, valid);
  }
};

struct FanRcpApprox {
  static __device__ __forceinline__ float inv(float det) {
    float y;
    asm("rcp.approx.f32 %0, %1;" : "=f"(y) : "f"(det));
    return y;
  }
  static __device__ __forceinline__ float pair(V3 d, V3 e1, V3 e2, const float* h, bool valid,
                                               const float*, int) {
    return fan_pair_t<FanRcpApprox>(d, e1, e2, h, valid);
  }
};

// the three direction dots of the pair (det, tvec . pvec, d . qvec), their
// minimum: no divide, no hit test
struct FanDotsOnly {
  static __device__ __forceinline__ float pair(V3 d, V3 e1, V3 e2, const float* h, bool,
                                               const float*, int) {
    V3 pvec = cross(d, e2);
    float det = dot(e1, pvec);
    float a = dot(load3(h), pvec);
    float b = dot(d, load3(h + 3));
    return min2(det, min2(a, b));
  }
};

// the epilogue of FanExact with (det, u numerator, v numerator) read from
// aux[4 row .. 4 row + 3) in place of the dots; t from the hoisted term
struct FanEpilogueOnly {
  static __device__ __forceinline__ float pair(V3, V3, V3, const float* h, bool valid,
                                               const float* aux, int row) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(aux) + row);
    bool det_ok = fabsf(q.x) > 1e-12f;
    float inv_det = det_ok ? 1.0f / q.x : 0.0f;
    float u = q.y * inv_det;
    float v = q.z * inv_det;
    float t = h[6] * inv_det;
    bool hit = det_ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > 0.0f && valid;
    return sel_inf(hit, t);
  }
};

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
// Writes the nearest t (inf on a miss; Pair's minimum) to out[0 .. F).
// zg and group_of_ray may point into shared memory beyond
// fan_sweep_smem(G). Rows are staged kTile <= kFanTile at a time.
template <int DS = 1, class Pair = FanExact, int kTile = kFanTile>
__device__ inline void fan_sweep(float ox, float oy, float oz, const float* zg,
                                 const int* group_of_ray, int G, const float* __restrict__ dx,
                                 const float* __restrict__ dy, const float* __restrict__ dz,
                                 const float* __restrict__ rows, const int* __restrict__ cand,
                                 int count, int F, float* __restrict__ out,
                                 const float* __restrict__ aux = nullptr) {
  static_assert(kTile <= kFanTile, "the shared memory holds kFanTile rows");
  extern __shared__ float s[];
  const int GH = hoisted_groups(G);
  float* e1s = s;                           // [kTile][3]
  float* e2s = e1s + 3 * kTile;             // [kTile][3]
  float* valid = e2s + 3 * kTile;           // [kTile]
  float* hoist = valid + kTile;             // [GH][kTile][7]: tvec qvec e2.qvec
  int* row_of = (int*)(hoist + 7 * GH * kTile);  // [kTile]
  __shared__ int n_staged;

  for (int f = threadIdx.x; f < F; f += blockDim.x) out[f] = CUDART_INF_F;
  for (int base = 0; base < count; base += kTile) {
    const int span = min(kTile, count - base);
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
        float* h = hoist + ((size_t)g * kTile + i) * 7;
        h[0] = tvec.x; h[1] = tvec.y; h[2] = tvec.z;
        h[3] = qvec.x; h[4] = qvec.y; h[5] = qvec.z;
        h[6] = dot(load3(e2s + 3 * i), qvec);
      }
      __syncthreads();
      for (int f = threadIdx.x; f < F; f += blockDim.x) {
        const int g = group_of_ray[f] - g0;
        if (g < 0 || g >= gn) continue;
        V3 d = v3(dx[DS * f], dy[DS * f], dz[DS * f]);
        const float* hg = hoist + (size_t)g * kTile * 7;
        float best = out[f];
        for (int i = 0; i < nt; ++i)
          best = min2(best, Pair::pair(d, load3(e1s + 3 * i), load3(e2s + 3 * i), hg + i * 7,
                                       valid[i] > 0.0f, aux, row_of[i]));
        out[f] = best;
      }
    }
  }
}

}  // namespace mpenv
