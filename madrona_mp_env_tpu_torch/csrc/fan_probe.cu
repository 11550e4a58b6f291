// P2: the sensor-fan sweep (K2) split into its parts, at the sim's shape.
//
// Replaces the TPU probe madrona_mp_env_tpu/tools/fan_probe.py
// run_variant (kernels make_v8 and make_v9_chunked): the v8 fan fused
// with an approximate reciprocal, with an exact divide and with an exact
// reciprocal, its matrix product alone plus a minimum, its epilogue alone
// on stand-in dots, and the candidates chunked. Python:
// madrona_mp_env_tpu_torch/tools/fan_probe.py, which holds each variant's
// plain version.
//
// Every variant is K2's kernel (csrc/fan_tris.cu: one block per fan, the
// soup staged in tiles with the origin terms hoisted per (group, row);
// csrc/fan_sweep.cuh) with one template switched:
//   0 exact:      FanExact, K2's own arithmetic (1 / det by IEEE division)
//   1 rcp_ieee:   FanRcpIeee, the correctly rounded reciprocal: same bits
//   2 rcp_approx: FanRcpApprox, rcp.approx (no bit-equal plain version)
//   3 dots_only:  FanDotsOnly, the pair's three direction dots and their
//                 minimum, no divide and no hit test
//   4 epilogue:   FanEpilogueOnly, the divide, scales and hit test on dots
//                 read per row from aux [T, 4]
//   5 chunked:    FanExact with the rows staged 8 at a time
// The TPU probe's matrix product is its bf16 direction dots on the MXU;
// here the dots are the pair's own f32 cross and dot products.
//
// Bound on the H100: N fans x F rays x T rows pair tests of ~32 f32
// operations (exact), from N * (12 + 4G + 12F) bytes in and 4NF out:
// bound by operations.
#include "fan_sweep.cuh"

using namespace mpenv;

template <class Pair, int kTile>
__global__ void __launch_bounds__(kFanThreads)
    fan_probe_kernel(const float* __restrict__ org, const float* __restrict__ zg,
                     const float* __restrict__ dx, const float* __restrict__ dy,
                     const float* __restrict__ dz, const int* __restrict__ group_of_ray,
                     const float* __restrict__ rows, const float* __restrict__ aux, int F, int G,
                     int T, float* __restrict__ out) {
  const size_t n = blockIdx.x, ray0 = n * F;
  fan_sweep<1, Pair, kTile>(org[3 * n], org[3 * n + 1], org[3 * n + 2], zg + n * G,
                            group_of_ray, G, dx + ray0, dy + ray0, dz + ray0, rows, nullptr, T,
                            F, out + ray0, aux);
}

template <class Pair, int kTile>
static int fan_probe_run(const float* org, const float* zg, const float* dx, const float* dy,
                         const float* dz, const int* group_of_ray, const float* rows,
                         const float* aux, int N, int F, int G, int T, float* out,
                         cudaStream_t st) {
  size_t smem = fan_sweep_smem(G);
  cudaError_t e = allow_smem(fan_probe_kernel<Pair, kTile>, smem);
  if (e != cudaSuccess) return (int)e;
  fan_probe_kernel<Pair, kTile><<<N, kFanThreads, smem, st>>>(org, zg, dx, dy, dz, group_of_ray,
                                                               rows, aux, F, G, T, out);
  return (int)cudaGetLastError();
}

extern "C" int fan_probe_launch(int variant, const float* org, const float* zg, const float* dx,
                                const float* dy, const float* dz, const int* group_of_ray,
                                const float* rows, const float* aux, int N, int F, int G, int T,
                                float* out, void* stream) {
  if (N <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
#define MPENV_FAN_PROBE(P, TILE) \
  fan_probe_run<P, TILE>(org, zg, dx, dy, dz, group_of_ray, rows, aux, N, F, G, T, out, st)
  switch (variant) {
    case 0: return MPENV_FAN_PROBE(FanExact, kFanTile);
    case 1: return MPENV_FAN_PROBE(FanRcpIeee, kFanTile);
    case 2: return MPENV_FAN_PROBE(FanRcpApprox, kFanTile);
    case 3: return MPENV_FAN_PROBE(FanDotsOnly, kFanTile);
    case 4: return MPENV_FAN_PROBE(FanEpilogueOnly, kFanTile);
    case 5: return MPENV_FAN_PROBE(FanExact, 8);
    default: return (int)cudaErrorInvalidValue;
  }
#undef MPENV_FAN_PROBE
}
