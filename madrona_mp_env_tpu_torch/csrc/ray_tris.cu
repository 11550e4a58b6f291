// K1: nearest-hit rays vs the triangle soup (the hitscan of fire_system).
//
// Replaces the TPU kernel madrona_mp_env_tpu/ops/raycast_pallas.py
// _ray_kernel (via _ray_pallas_call / ray_vs_tris_pallas). Plain version:
// ops/raycast.py _ray_vs_tris_dense.
//
// Bound on the H100: the work is R rays x T triangles of ~40 f32 operations
// (two cross products, four dots, one divide), from R * 24 bytes in and
// R * 4 bytes out, so it is bound by operations, and at the slice's
// R = W * A = 12288 rays it is a few microseconds of work, so launch latency
// dominates. Design: one thread per ray; the block stages the triangles'
// v0/e1/e2/valid in shared memory kRayTile at a time (40 KB; a big map's
// 6,144 triangles would need 240 KB at once) and every thread of a warp
// reads the same triangle at once (a broadcast), keeping the running
// minimum in a register.
#include "tri_math.cuh"

using namespace mpenv;

constexpr int kRayTile = 1024;  // triangle rows staged per pass

__global__ void ray_tris_kernel(const float* __restrict__ o, const float* __restrict__ d,
                                const float* __restrict__ rows, int T, int R,
                                float* __restrict__ out) {
  extern __shared__ float s[];  // [kRayTile][10]: v0 e1 e2 valid
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = r < R;
  V3 org = live ? load3(o + 3 * (size_t)r) : v3(0.0f, 0.0f, 0.0f);
  V3 dir = live ? load3(d + 3 * (size_t)r) : v3(0.0f, 0.0f, 0.0f);
  float best = CUDART_INF_F;
  for (int base = 0; base < T; base += kRayTile) {
    const int nt = min(kRayTile, T - base);
    __syncthreads();  // the previous tile's sweep is done with shared memory
    for (int i = threadIdx.x; i < nt; i += blockDim.x) {
      const float* row = rows + (size_t)(base + i) * kRowCols;
      for (int k = 0; k < 9; ++k) s[i * 10 + k] = row[kRowV0 + k];
      s[i * 10 + 9] = row[kRowValid];
    }
    __syncthreads();
    if (!live) continue;
    for (int i = 0; i < nt; ++i) {
      const float* t = s + i * 10;
      float ti = ray_tri(org, dir, load3(t), load3(t + 3), load3(t + 6), t[9] > 0.0f);
      best = min2(best, ti);
    }
  }
  if (live) out[r] = best;
}

extern "C" int ray_tris_launch(const float* o, const float* d, const float* rows, int T, int R,
                               float* out, void* stream) {
  if (R <= 0) return 0;
  const int threads = 128;
  size_t smem = (size_t)min(T, kRayTile) * 10 * sizeof(float);
  cudaError_t e = allow_smem(ray_tris_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  ray_tris_kernel<<<(R + threads - 1) / threads, threads, smem, (cudaStream_t)stream>>>(
      o, d, rows, T, R, out);
  return (int)cudaGetLastError();
}
