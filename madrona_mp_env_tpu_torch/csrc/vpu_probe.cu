// P1: issue-rate chains, the op rates the raycast kernels are built on.
//
// Replaces the TPU probe madrona_mp_env_tpu/tools/vpu_probe.py: _run's
// single-block kernel (a serially dependent fori_loop on a VMEM-resident
// 256 x 256 f32 tile) and main's mm_kernel (a chain of 64 bf16 matrix
// products, M 2048 x K 8 / 128 x N 768, f32 out). Python:
// madrona_mp_env_tpu_torch/tools/vpu_probe.py, which holds each chain's
// plain version.
//
// vpu_chain: one tile element per thread, its chain in registers, the
// dependence kept `loop` deep (a multiple of kUnroll). The loop is written
// out kUnroll links at a time and kept from further unrolling, so it is the
// kernel's only loop and its SASS body is kUnroll links
// (tools/vpu_probe.py loop_sass divides by it). The chains:
//   0 fma          acc * b + a       one FFMA (__fmaf_rn: --fmad=false
//                                    would otherwise give FMUL + FADD)
//   1 mul          acc * b
//   2 fma_lane     acc[:, 0:1] * b + acc (column 0 of the row)
//   3 fma_sublane  acc[0:1, :] * b + acc (row 0 of the column)
//   4 rcp          rcp.approx(acc + b)   (pl.reciprocal(..., approx=True))
//   5 div          b / (acc + b)         (IEEE divide)
//   6 sel          (acc > b ? acc : b) + a
//   7 epilogue     the fan epilogue: t = acc * rcp.approx(b), u = a + t b,
//                  v = b + t a, hit test, min(acc, hit ? t : inf) + a
// The broadcast chains reach across threads. A block holds one whole row
// (lane broadcast) or one whole column (sublane broadcast) of the tile, one
// element per thread; the row's column 0 (the column's row 0) is passed
// through shared memory, double-buffered, with one barrier per link.
//
// vpu_mma: the bf16 chain, mma.sync m16n8k16, f32 accumulate. A warp owns
// 16 rows x 32 columns; a block four warps down the rows, so every warp's
// first column is its block's. Each link reads the block's first column of
// the previous product (a lane shuffle within the warp) as the TPU chain
// reads acc[:, 0:1]: A = a + bf16(acc[row, first]) * 0, then A b. K = 8 is
// padded to k16 with zeros.
//
// Bound on the H100: 65,536 chains x `loop` links on 0.8 MB: bound by
// operations (f32 at 67 TFLOP/s; the reciprocal and divide chains by the
// special-function units); the mma chains by the bf16 tensor-core rate at
// K = 128 and by the 6.3 MB output at K = 8.
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kUnroll = 8;  // links per main-loop iteration
enum Chain { kFma, kMul, kFmaLane, kFmaSublane, kRcp, kDiv, kSel, kEpilogue };

__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

template <int C>
__device__ __forceinline__ float link(float acc, float a, float b) {
  if constexpr (C == kFma) {
    return __fmaf_rn(acc, b, a);
  } else if constexpr (C == kMul) {
    return acc * b;
  } else if constexpr (C == kRcp) {
    return rcp_approx(acc + b);
  } else if constexpr (C == kDiv) {
    return b / (acc + b);
  } else if constexpr (C == kSel) {
    return (acc > b ? acc : b) + a;
  } else {  // kEpilogue
    const float t = acc * rcp_approx(b);
    const float u = a + t * b;
    const float v = b + t * a;
    const bool hit = t > 0.0f && u >= 0.0f && v >= 0.0f && u + v <= 1.0f;
    const float th = hit ? t : CUDART_INF_F;
    return (th < acc ? th : acc) + a;
  }
}

// a, b, out [rows, cols]; block = one row (or, sublane, one column)
template <int C>
__global__ void vpu_chain_kernel(const float* __restrict__ a_in, const float* __restrict__ b_in,
                                 float* __restrict__ out, int cols, int loop) {
  constexpr bool kBcast = C == kFmaLane || C == kFmaSublane;
  const int r = C == kFmaSublane ? threadIdx.x : blockIdx.x;
  const int c = C == kFmaSublane ? blockIdx.x : threadIdx.x;
  const size_t i = (size_t)r * cols + c;
  const float a = a_in[i], b = b_in[i];
  float acc = a;
  if constexpr (kBcast) {
    __shared__ float src[2];  // the broadcast element, double-buffered
    const bool owner = (C == kFmaLane ? c : r) == 0;
    if (owner) src[0] = acc;
    __syncthreads();
#pragma unroll 1
    for (int k = 0; k < loop; k += kUnroll) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        acc = __fmaf_rn(src[u & 1], b, acc);
        if (owner) src[(u + 1) & 1] = acc;
        __syncthreads();
      }
    }
  } else {
#pragma unroll 1
    for (int k = 0; k < loop; k += kUnroll) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) acc = link<C>(acc, a, b);
    }
  }
  out[i] = acc;
}

template <int C>
int chain_run(const float* a, const float* b, float* out, int rows, int cols, int loop,
              cudaStream_t st) {
  const int blocks = C == kFmaSublane ? cols : rows;
  const int threads = C == kFmaSublane ? rows : cols;
  vpu_chain_kernel<C><<<blocks, threads, 0, st>>>(a, b, out, cols, loop);
  return (int)cudaGetLastError();
}

constexpr int kMmaWarps = 4;
constexpr int kMmaCols = 32;  // a warp's columns: four n8 tiles
constexpr int kMmaRows = 16 * kMmaWarps;

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// c = a b, m16n8k16, bf16 operands, f32 accumulate from zero or c
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a [M, K], b [K, N] bf16 -> out [M, N] f32 after `depth` links; KT k16
// tiles cover K (K = 8 padded with zeros)
template <int KT>
__global__ void __launch_bounds__(32 * kMmaWarps)
    vpu_mma_kernel(const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ b,
                   float* __restrict__ out, int N, int K, int depth) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int row0 = blockIdx.x * kMmaRows + warp * 16;
  const int col0 = blockIdx.y * kMmaCols;
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);
  auto A = [&](int m, int k) { return k < K ? a[(size_t)(row0 + m) * K + k] : zero; };
  auto B = [&](int k, int n) { return k < K ? b[(size_t)k * N + col0 + n] : zero; };

  // a pairs (row g | g + 8, k 2q + {0, 1} | + 8) and b pairs per k tile
  __nv_bfloat162 ap[KT][4];
  uint32_t bf[KT][4][2];
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
    const int k = 16 * kt + 2 * q;
    ap[kt][0] = __halves2bfloat162(A(g, k), A(g, k + 1));
    ap[kt][1] = __halves2bfloat162(A(g + 8, k), A(g + 8, k + 1));
    ap[kt][2] = __halves2bfloat162(A(g, k + 8), A(g, k + 9));
    ap[kt][3] = __halves2bfloat162(A(g + 8, k + 8), A(g + 8, k + 9));
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int n = 8 * nt + g;
      bf[kt][nt][0] = pack2(B(k, n), B(k + 1, n));
      bf[kt][nt][1] = pack2(B(k + 8, n), B(k + 9, n));
    }
  }

  float acc[4][4] = {};
#pragma unroll 1
  for (int s = 0; s < depth; ++s) {
    // acc[row, first column]: n tile 0's column 0, held by lane 4g
    const float f0 = __shfl_sync(0xffffffffu, acc[0][0], lane & ~3);
    const float f1 = __shfl_sync(0xffffffffu, acc[0][2], lane & ~3);
    const __nv_bfloat162 z0 = __bfloat162bfloat162(__hmul(__float2bfloat16(f0), zero));
    const __nv_bfloat162 z1 = __bfloat162bfloat162(__hmul(__float2bfloat16(f1), zero));
    float nacc[4][4] = {};
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      __nv_bfloat162 x[4] = {__hadd2(ap[kt][0], z0), __hadd2(ap[kt][1], z1),
                             __hadd2(ap[kt][2], z0), __hadd2(ap[kt][3], z1)};
      const uint32_t af[4] = {*reinterpret_cast<uint32_t*>(&x[0]),
                              *reinterpret_cast<uint32_t*>(&x[1]),
                              *reinterpret_cast<uint32_t*>(&x[2]),
                              *reinterpret_cast<uint32_t*>(&x[3])};
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) mma_bf16(nacc[nt], af, bf[kt][nt][0], bf[kt][nt][1]);
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = nacc[nt][e];
  }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int c = col0 + 8 * nt + 2 * q;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      out[(size_t)(row0 + g + (e >> 1) * 8) * N + c + (e & 1)] = acc[nt][e];
  }
}

}  // namespace

extern "C" int vpu_chain_launch(int chain, const float* a, const float* b, float* out, int rows,
                                int cols, int loop, void* stream) {
  if (rows <= 0 || cols <= 0) return 0;
  const int threads = chain == kFmaSublane ? rows : cols;
  if (threads > 1024 || loop % kUnroll) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (chain) {
    case kFma: return chain_run<kFma>(a, b, out, rows, cols, loop, st);
    case kMul: return chain_run<kMul>(a, b, out, rows, cols, loop, st);
    case kFmaLane: return chain_run<kFmaLane>(a, b, out, rows, cols, loop, st);
    case kFmaSublane: return chain_run<kFmaSublane>(a, b, out, rows, cols, loop, st);
    case kRcp: return chain_run<kRcp>(a, b, out, rows, cols, loop, st);
    case kDiv: return chain_run<kDiv>(a, b, out, rows, cols, loop, st);
    case kSel: return chain_run<kSel>(a, b, out, rows, cols, loop, st);
    case kEpilogue: return chain_run<kEpilogue>(a, b, out, rows, cols, loop, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int vpu_mma_launch(const void* a, const void* b, float* out, int M, int N, int K,
                              int depth, void* stream) {
  if (M % kMmaRows || N % kMmaCols || !(K == 8 || K == 128)) return (int)cudaErrorInvalidValue;
  const dim3 grid(M / kMmaRows, N / kMmaCols);
  cudaStream_t st = (cudaStream_t)stream;
  const auto* pa = static_cast<const __nv_bfloat16*>(a);
  const auto* pb = static_cast<const __nv_bfloat16*>(b);
  if (K == 8)
    vpu_mma_kernel<1><<<grid, 32 * kMmaWarps, 0, st>>>(pa, pb, out, N, K, depth);
  else
    vpu_mma_kernel<8><<<grid, 32 * kMmaWarps, 0, st>>>(pa, pb, out, N, K, depth);
  return (int)cudaGetLastError();
}
