// P4: the sphere cast with its dot products on the tensor cores.
//
// Replaces the TPU probe tools/probes/sc_mxu_probe.py mxu_kernel, which
// takes, per (triangle row, cast) pair, 9 direction dots (DD = dirm^T d4)
// and 9 origin terms (AO = orgm^T o4) as two [9T, 8] x [8, BC] matrix
// products on the MXU, materialized in VMEM, and finishes the face, the
// three edge cylinders and the three vertex spheres from them on the
// vector units. Python: madrona_mp_env_tpu_torch/tools/probes/
// sc_mxu_probe.py sphere_cast_mxu, whose _sc_mxu_plain is the plain
// version.
//
// Design: nothing is materialized. One warp owns 8 casts (the n of
// mma.sync m16n8k8) and walks the rows 16 at a time (the m); K = 8 is the
// tables' 8 rows. Per 16-row tile a warp issues 18 groups x 3 mma: the
// TF32 operands are split into a big and a small TF32 part and the
// product is small.big + big.small + big.big (3xTF32), because the
// uncentered origin groups carry |v0|^2-sized constants (~1e6) against
// r^2 = 225 and one TF32 pass (10-bit mantissa) errs by ~1e3 there. All
// 18 accumulators share the m16n8 fragment layout, so each thread holds
// every term of its own four (row, cast) pairs and runs the epilogue in
// registers, in the plain version's operation order (built with
// --fmad=false). The minimum over rows: the thread's two rows, then warp
// shuffles across the eight lanes that share a cast, then a running
// minimum across tiles. The block stages 32 rows of both tables at a time
// in shared memory, split once into big and small parts (row stride 296
// words: conflict-free fragment loads), with those rows' epilogue
// constants (cons).
//
// Not bit-equal to the plain version: the tensor cores sum in their own
// order. It is held to it by the largest |t difference| where both hit
// and the share of casts whose hit or miss differs.
//
// Bound on the H100: N casts x T rows pairs of 432 TF32 multiply-adds
// (18 groups x K 8 x 3) and ~119 f32 epilogue operations, from ~1 MB of
// inputs: bound by operations (TF32 and f32 about equal at 24,576 x 256).
#include <stdint.h>

#include "tri_math.cuh"

using namespace mpenv;

namespace {

constexpr int kG = 9;                  // row groups of dirm / orgm
constexpr int kK = 8;                  // rows of dirm / orgm: the mma's k
constexpr int kChunk = 32;             // triangle rows staged per pass
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kCastsPerWarp = 8;       // the mma's n
constexpr int kCastsPerBlock = kWarps * kCastsPerWarp;
constexpr int kStride = kG * kChunk + 8;  // staged row stride, = 8 mod 32
constexpr int kConsCols = 16;

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;
}

// x = big + small with both parts TF32 (x - big is exact in f32)
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = tf32(x);
  small = tf32(x - __uint_as_float(big));
}

// c += a b, m16n8k8, TF32 operands, f32 accumulate
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// one (row, cast) pair of mxu_kernel's epilogue from its 18 terms: t of
// the nearest hit (0 on a start overlap, inf on a miss or invalid row)
__device__ __forceinline__ float sc_mxu_pair(const float (&D)[kG], const float (&A)[kG], float od,
                                             float oo, const float* cn, float r) {
  const bool valid = cn[0] > 0.0f;
  const float w1n = cn[7], w2n = cn[8];
  const float nd = D[0], w1d = D[1], w2d = D[2];
  const float h = A[0], u0 = A[1], v0b = A[2];
  const float sign = h >= 0.0f ? 1.0f : -1.0f;
  const bool nd_ok = fabsf(nd) > 1e-9f;
  float t_face = (sign * r - h) / (nd_ok ? nd : 1.0f);
  const float bv = u0 + t_face * w1d - sign * (r * w1n);
  const float bw = v0b + t_face * w2d - sign * (r * w2n);
  const bool face_ok =
      nd_ok && t_face >= 0.0f && bv >= 0.0f && bw >= 0.0f && bv + bw <= 1.0f;
  t_face = sel_inf(face_ok, t_face);
  const float pv = u0 - h * w1n;
  const float pw = v0b - h * w2n;
  bool overlap = fabsf(h) <= r && pv >= 0.0f && pw >= 0.0f && pv + pw <= 1.0f;
  const float rr = r * r;

  float t_edge = CUDART_INF_F;
#pragma unroll
  for (int i = 0; i < 3; ++i) {  // edges v0-v1, v0-v2, v1-v2
    const int p0g = i < 2 ? 6 : 7;
    const float p0d = D[p0g], sd = D[3 + i], ms = A[3 + i], qq = A[p0g];
    const float inv_l2 = cn[4 + i], len2 = cn[1 + i];
    const float md = od - p0d;
    const float mm = oo + qq;
    const float aa = 1.0f - sd * sd * inv_l2;
    const float bb = md - ms * sd * inv_l2;
    const float cc2 = mm - ms * ms * inv_l2 - rr;
    const bool start_in = cc2 <= 0.0f && ms >= 0.0f && ms <= len2;
    const float disc = bb * bb - aa * cc2;
    const float sq = sqrtf(fmaxf(disc, 0.0f));
    const bool a_ok = fabsf(aa) > 1e-12f;
    const float t_cyl = (-bb - sq) / (a_ok ? aa : 1.0f);
    const float s_hit = ms + t_cyl * sd;
    const bool ok = a_ok && disc >= 0.0f && t_cyl >= 0.0f && s_hit >= 0.0f && s_hit <= len2;
    t_edge = min2(t_edge, sel_inf(ok, t_cyl));
    overlap = overlap || start_in;
  }
#pragma unroll
  for (int c = 6; c < 9; ++c) {  // vertex spheres v0, v1, v2
    const float bb = od - D[c];
    const float cc2 = oo + A[c] - rr;
    const float disc = bb * bb - cc2;
    const float ts = -bb - sqrtf(fmaxf(disc, 0.0f));
    t_edge = min2(t_edge, sel_inf(disc >= 0.0f && ts >= 0.0f, ts));
    overlap = overlap || cc2 <= 0.0f;
  }
  float t = min2(t_face, t_edge);
  t = overlap ? 0.0f : t;
  return valid ? t : CUDART_INF_F;
}

// planes [8, N] (ox oy oz dx dy dz 0 0), dirm / orgm [8, 9T], cons [T, 16]
// -> out [N]: the nearest hit of each cast over the T rows
__global__ void __launch_bounds__(kThreads)
    sc_mxu_kernel(const float* __restrict__ planes, const float* __restrict__ dirm,
                  const float* __restrict__ orgm, const float* __restrict__ cons, float r, int N,
                  int T, float* __restrict__ out) {
  __shared__ uint32_t s_dir[2][kK * kStride];  // [big, small][k][group, row]
  __shared__ uint32_t s_org[2][kK * kStride];
  __shared__ float s_cons[kChunk * kConsCols];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;  // fragment row / column group
  const int n0 = blockIdx.x * kCastsPerBlock + warp * kCastsPerWarp;
  const size_t NN = (size_t)N;

  // B fragments: k = q (b0) and q + 4 (b1, rows 4-7: zero), cast n0 + g.
  // d4 = (dx dy dz 0 ...), o4 = (ox oy oz 1 0 ...)
  const int nb = n0 + g;
  const float bd = (q < 3 && nb < N) ? planes[(3 + q) * NN + nb] : 0.0f;
  const float bo = q == 3 ? 1.0f : (q < 3 && nb < N) ? planes[q * NN + nb] : 0.0f;
  uint32_t bd_big, bd_small, bo_big, bo_small;
  split(bd, bd_big, bd_small);
  split(bo, bo_big, bo_small);

  // the thread's casts (accumulator columns 2q, 2q + 1): o . d and o . o
  float od[2], oo[2], tmin[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int n = n0 + 2 * q + j;
    const bool in = n < N;
    const float ox = in ? planes[n] : 0.0f, oy = in ? planes[NN + n] : 0.0f;
    const float oz = in ? planes[2 * NN + n] : 0.0f, dx = in ? planes[3 * NN + n] : 0.0f;
    const float dy = in ? planes[4 * NN + n] : 0.0f, dz = in ? planes[5 * NN + n] : 0.0f;
    od[j] = ox * dx + oy * dy + oz * dz;
    oo[j] = ox * ox + oy * oy + oz * oz;
    tmin[j] = CUDART_INF_F;
  }

  const size_t GT = (size_t)kG * T;
  for (int c0 = 0; c0 < T; c0 += kChunk) {
    __syncthreads();  // the previous chunk's readers are done
    for (int i = threadIdx.x; i < kK * kG * kChunk; i += kThreads) {
      const int k = i / (kG * kChunk), rem = i - k * (kG * kChunk);
      const int grp = rem / kChunk, j = rem - grp * kChunk;
      const size_t src = k * GT + (size_t)grp * T + c0 + j;
      const int dst = k * kStride + rem;
      split(dirm[src], s_dir[0][dst], s_dir[1][dst]);
      split(orgm[src], s_org[0][dst], s_org[1][dst]);
    }
    for (int i = threadIdx.x; i < kChunk * kConsCols; i += kThreads)
      s_cons[i] = cons[(size_t)c0 * kConsCols + i];
    __syncthreads();

#pragma unroll 1
    for (int rt = 0; rt < kChunk; rt += 16) {
      // acc[grp][e]: e = 0, 1 row g, casts 2q, 2q+1; e = 2, 3 row g + 8
      float dd[kG][4], ao[kG][4];
#pragma unroll
      for (int grp = 0; grp < kG; ++grp) {
        const int base = grp * kChunk + rt;
        const int i0 = q * kStride + base + g, i1 = i0 + 8;
        const int i2 = i0 + 4 * kStride, i3 = i2 + 8;
        const uint32_t db[4] = {s_dir[0][i0], s_dir[0][i1], s_dir[0][i2], s_dir[0][i3]};
        const uint32_t ds[4] = {s_dir[1][i0], s_dir[1][i1], s_dir[1][i2], s_dir[1][i3]};
        const uint32_t ob[4] = {s_org[0][i0], s_org[0][i1], s_org[0][i2], s_org[0][i3]};
        const uint32_t os[4] = {s_org[1][i0], s_org[1][i1], s_org[1][i2], s_org[1][i3]};
#pragma unroll
        for (int e = 0; e < 4; ++e) dd[grp][e] = ao[grp][e] = 0.0f;
        mma_tf32(dd[grp], ds, bd_big, 0u);
        mma_tf32(dd[grp], db, bd_small, 0u);
        mma_tf32(dd[grp], db, bd_big, 0u);
        mma_tf32(ao[grp], os, bo_big, 0u);
        mma_tf32(ao[grp], ob, bo_small, 0u);
        mma_tf32(ao[grp], ob, bo_big, 0u);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float D[kG], A[kG];
#pragma unroll
        for (int grp = 0; grp < kG; ++grp) {
          D[grp] = dd[grp][e];
          A[grp] = ao[grp][e];
        }
        const int row = rt + g + (e >> 1) * 8;
        const float t = sc_mxu_pair(D, A, od[e & 1], oo[e & 1], s_cons + row * kConsCols, r);
        tmin[e & 1] = min2(tmin[e & 1], t);
      }
    }
  }

  // the minimum over the eight lanes (rows) that share each cast
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int off = 4; off < 32; off <<= 1)
      tmin[j] = min2(tmin[j], __shfl_xor_sync(0xffffffffu, tmin[j], off));
  if (g == 0) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = n0 + 2 * q + j;
      if (n < N) out[n] = tmin[j];
    }
  }
}

}  // namespace

extern "C" int sc_mxu_launch(const float* planes, const float* dirm, const float* orgm,
                             const float* cons, float r, int N, int T, float* out, void* stream) {
  if (N <= 0) return 0;
  if (T <= 0 || T % kChunk) return (int)cudaErrorInvalidValue;
  const int blocks = (N + kCastsPerBlock - 1) / kCastsPerBlock;
  sc_mxu_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(planes, dirm, orgm, cons, r, N,
                                                                T, out);
  return (int)cudaGetLastError();
}
