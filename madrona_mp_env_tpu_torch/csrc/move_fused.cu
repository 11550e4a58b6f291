// P3: the movement contact pipeline (applyVelocitySystem + fallSystem) in
// one launch.
//
// Replaces the TPU kernel tools/probes/movement_fused_probe.py
// _make_move_kernel (via _get_move_fused, dense, and _get_move_fused_culled,
// culled; entry apply_velocity_fall_fused). Plain version: the port's own
// split chain, sim/movement.py apply_velocity_system -> fall_system, under
// the same CastRoute with the plain sweeps (tools/probes/
// movement_fused_probe.py _apply_velocity_fall_fused_plain). Per agent:
// L1 (slope, low and high forward casts, 4 unstick probes), the winner
// normals of casts 0-2, the slide / unstick selection, L2 (slide and
// unstick ground check), L3 (ground snap), the velocity commit from the
// pre-fall position, then the fall cast.
//
// What is not carried over: the TPU kernel's reassociated forms (the hb
// half-buffer origins, the slide direction through an inverse length,
// unstick directions as component swaps), its own normal rule (|edge_n .
// n| > 0.999), its agents-on-lanes layout and sorted cell blocks, and the
// velocity commit on any(to_new != 0). Here every line repeats the split
// chain's tensor operation on the card: ATen's own forms of torch.clamp
// (fmaxf / fminf after a NaN test), torch.minimum, division by a Python
// scalar (multiplication by its float reciprocal: the velocity), the
// unstick directions' sin / cos read from the tensors the chain computes,
// and csrc/tri_math.cuh for every (cast, triangle) pair and normal. Built
// with --fmad=false and IEEE divide and square root, the two agree bit for
// bit.
//
// Routes (the plain chain's CastRoute): "culled", the step's own (L1
// against the agent's short-table cell of its start position, K
// candidates; L2, L3 and fall against the MOVE_MARGIN tables, the fall
// at the cell of the post-move position), and "dense" (every cast over
// the whole soup). A miss reports row 0; ties take the lowest row, as the
// plain sweeps' argmin does.
//
// Design: one warp per agent. The 32 lanes split the cast's candidate rows
// (rows read from the soup's [T, 16] table through the read-only cache:
// 16 KB on simple_map, 393 KB on town_map, both L2-resident), and the
// nearest hit is a warp reduction of (t, row) taken lexicographically
// (csrc/sc_sweep.cuh warp_cast, whose reduction K4 culled and K4' share).
// Every per-agent branch is warp-uniform, so the phases whose results the
// chain would discard are skipped: a still agent or a slope-blocked one
// goes straight to the fall cast, the slide cast runs only where the
// forward cast stops short of move_dist, the unstick probes and their
// ground check only where the agent is stuck or has no ground.
//
// Bound on the H100: per agent up to 11 casts x the candidates each
// sweeps (culled simple_map: 7 x 56 + 4 x 48 = 584 pairs; dense: 11 x
// 256) of ~330 f32 operations (tri_math.cuh sc_pair), from 36 bytes in
// and 24 out per agent: bound by operations.
#include "sc_sweep.cuh"
#include "tri_math.cuh"

using namespace mpenv;

// field order = tools/probes/movement_fused_probe.py _MoveArgs
struct MoveArgs {
  const float* pos;    // [N, 3]
  const float* vel;    // [N, 3]
  const int* cur;      // [N] Pose
  const float* alive;  // [N]
  const float* rows;   // [T, 16] soup
  const float* trig;   // [8]: sin, cos of k pi / 2, k = 0..3 (rotate_z)
  const int* cand1;    // L1 short tables [C1 * K1], nullptr: the whole soup
  const int* cand2;    // MOVE_MARGIN tables [C2 * K2], nullptr: the soup
  float* pos_out;      // [N, 3]
  float* vel_out;      // [N, 3]
  // nullptr, or [2] += the (cast, valid triangle) pairs swept and the
  // normals taken: the work this run's data needs (for the bound)
  unsigned long long* work;
  int N, T;
  int K1, nx1, ny1;
  int K2, nx2, ny2;
  int pose_crouch, pose_prone;
  float x0_1, y0_1, cs1;
  float x0_2, y0_2, cs2;
  float r;
  float hb;           // buf * 0.5
  float two_r;        // 2 r
  float buf, neg_buf;
  float top_crouch, top_prone, top_stand, low_prone, low_other;
  float dt, inv_dt;   // delta_t, float 1 / delta_t
  float unstick_range, unstick_big;
  float slope_max;    // 0.7
  float tiny;         // 1e-30 (clamps of norms)
  float fall_cast_up;  // r + cast_offset
  float fall_max;     // fall_rate * delta_t
};

constexpr int kMoveWarps = 4;  // agents per block

// torch.clamp(v, min=lo) / torch.clamp(v, max=hi) / torch.minimum on the
// card: the NaN passes, else fmaxf / fminf
__device__ __forceinline__ float at_clamp_lo(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float at_clamp_hi(float v, float hi) {
  return isnan(v) ? v : fminf(v, hi);
}
__device__ __forceinline__ float at_minimum(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}
__device__ __forceinline__ V3 sel3(bool c, V3 a, V3 b) { return c ? a : b; }
__device__ __forceinline__ V3 neg3(V3 a) { return {-a.x, -a.y, -a.z}; }
// v * s for a vector tensor times a per-agent scalar [..., None]
__device__ __forceinline__ V3 mul3(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
// up * s with up = (0, 0, 1)
__device__ __forceinline__ V3 up_times(float s) { return {0.0f * s, 0.0f * s, 1.0f * s}; }
__device__ __forceinline__ float norm3(V3 a) { return sqrtf(dot(a, a)); }
// v / torch.clamp(n, min=tiny) where n > 0, else 0 (geom.normalize form)
__device__ __forceinline__ V3 unit_or_zero(V3 v, float n, float tiny) {
  if (!(n > 0.0f)) return v3(0.0f, 0.0f, 0.0f);
  const float c = at_clamp_lo(n, tiny);
  return v3(v.x / c, v.y / c, v.z / c);
}

// ops/culling.py short_cell_index: float math, the cell size a tensor
__device__ __forceinline__ int short_cell(V3 p, float x0, float y0, float cs, int nx, int ny) {
  int ix = (int)((p.x - x0) / cs);
  int iy = (int)((p.y - y0) / cs);
  ix = min(max(ix, 0), nx - 1);
  iy = min(max(iy, 0), ny - 1);
  return iy * nx + ix;
}

// sc_normals_from_idx of the winner row (any row: a miss reads row 0)
__device__ __noinline__ V3 winner_normal(V3 o, V3 d, float r, const float* __restrict__ rows,
                                         int row) {
  const float* w = rows + (size_t)row * kRowCols;
  return sc_normal(o, d, r, r * r, load3(w + kRowV0), load3(w + kRowE1), load3(w + kRowE2),
                   load3(w + kRowN), w[kRowValid] > 0.0f);
}

__global__ void __launch_bounds__(32 * kMoveWarps) move_fused_kernel(const MoveArgs a) {
  const int n = blockIdx.x * kMoveWarps + (threadIdx.x >> 5);
  if (n >= a.N) return;  // warp-uniform
  const float r = a.r;
  const V3 x = load3(a.pos + 3 * (size_t)n);
  const V3 vin = load3(a.vel + 3 * (size_t)n);
  const int cur = a.cur[n];
  unsigned long long pairs = 0, normals = 0;
  auto cast = [&](V3 o, V3 d, const int* c, int k) {
    const Hit h = warp_cast(o, d, r, a.rows, c, k);
    pairs += h.n;
    return h;
  };
  auto normal_of = [&](V3 o, V3 d, int row) {
    ++normals;
    return winner_normal(o, d, r, a.rows, row);
  };

  // the cast tables: L1 at x's short cell, L2 / L3 at x's MOVE_MARGIN cell
  const int* c1 = a.cand1;
  int k1 = a.T;
  if (c1) {
    c1 += (size_t)short_cell(x, a.x0_1, a.y0_1, a.cs1, a.nx1, a.ny1) * a.K1;
    k1 = a.K1;
  }
  const int* c2 = a.cand2;
  int k2 = a.T;
  if (c2) {
    c2 += (size_t)short_cell(x, a.x0_2, a.y0_2, a.cs2, a.nx2, a.ny2) * a.K2;
    k2 = a.K2;
  }

  // ---- apply_velocity_system ----
  const V3 down = v3(-0.0f, -0.0f, -1.0f);
  const V3 v = v3(vin.x * 1.0f, vin.y * 1.0f, vin.z * 0.0f);
  const float v_len = norm3(v);
  const bool moving = v_len > 0.0f;
  const V3 v_norm = unit_or_zero(v, v_len, a.tiny);
  const float move_dist = v_len * a.dt;
  const float top = cur == a.pose_crouch ? a.top_crouch
                                         : (cur == a.pose_prone ? a.top_prone : a.top_stand);
  const float low = cur == a.pose_prone ? a.low_prone : a.low_other;
  const bool is_prone = cur == a.pose_prone;

  V3 out_pos = x;
  V3 out_vel = v3(0.0f, 0.0f, 0.0f);
  // a still agent keeps x and gets zero velocity whatever its casts say
  if (moving) {
    // L1 slope cast and its normal
    const V3 o_slope = x + up_times(top);
    const Hit h_s = cast(o_slope, down, c1, k1);
    const V3 n_s = normal_of(o_slope, down, h_s.row);
    const bool slope_block =
        n_s.z > 0.0f && n_s.z < a.slope_max && dot(n_s, v_norm) < 0.0f;
    if (!slope_block) {
      // L1 low and high forward casts and their normals
      const V3 o_low = (x + mul3(v_norm, a.hb)) + up_times(low);
      const V3 o_high = (x + mul3(v_norm, a.hb)) + up_times(top);
      const Hit h_low = cast(o_low, v_norm, c1, k1);
      const V3 n_low = normal_of(o_low, v_norm, h_low.row);
      const float t_low = h_low.t;
      // a prone agent takes the low cast's result for the high one
      float t_high = t_low;
      V3 n_high = n_low;
      if (!is_prone) {
        const Hit h_high = cast(o_high, v_norm, c1, k1);
        t_high = h_high.t;
        n_high = normal_of(o_high, v_norm, h_high.row);
      }

      const bool high_closer = t_high < t_low;
      const float low_dist_raw = high_closer ? t_high : t_low;
      const V3 normal = sel3(high_closer, n_high, n_low);
      const bool stuck = t_low == 0.0f || t_high == 0.0f;
      const float low_dist = at_clamp_lo(low_dist_raw - a.buf, 0.0f);
      V3 hit_pos = x + mul3(v_norm, at_minimum(low_dist, move_dist));

      // L2 slide cast, where the forward cast stops short of move_dist
      const bool slide_needed = move_dist > low_dist;
      if (slide_needed) {
        const V3 c = cross(v3(0.0f, 0.0f, 1.0f), normal);
        V3 slide_dir = unit_or_zero(c, norm3(c), a.tiny);
        if (dot(slide_dir, v_norm) < 0.0f) slide_dir = neg3(slide_dir);
        const V3 o_slide =
            (x + mul3(v_norm, low_dist)) + up_times(high_closer ? top : low);
        const float t_slide = cast(o_slide, slide_dir, c2, k2).t;
        float slide_dist = at_clamp_lo(t_slide - a.buf, 0.0f);
        slide_dist = at_minimum(slide_dist, at_clamp_lo(move_dist - low_dist, 0.0f));
        if (slide_dist > 0.0f) hit_pos = hit_pos + mul3(slide_dir, slide_dist);
      }

      // L3 ground snap
      V3 gc_pos = hit_pos + up_times(top);
      float t_ground = cast(gc_pos, down, c2, k2).t;

      // unstick: the 4 L1 probes, then the L2 ground check at the escape
      if (t_ground <= 0.0f || stuck) {
        float furthest = 0.0f;
        V3 best_dir = v3(0.0f, 0.0f, 0.0f);
        for (int k = 0; k < 4; ++k) {
          const float s = a.trig[2 * k], co = a.trig[2 * k + 1];
          const V3 u = v3(co * v_norm.x - s * v_norm.y, s * v_norm.x + co * v_norm.y, v_norm.z);
          const V3 o_un = (x - mul3(u, a.two_r)) + up_times(low);
          float t = cast(o_un, u, c1, k1).t;
          t = t > a.unstick_range ? a.unstick_big : t;
          if (k == 0 || t > furthest) {  // the first maximum, as max(dim=-1)
            furthest = t;
            best_dir = u;
          }
        }
        if (furthest > 0.0f) {
          const float un_step = at_clamp_hi(furthest - a.two_r, a.neg_buf);
          const V3 un_pos = x + mul3(best_dir, un_step);
          const V3 un_gc = un_pos + up_times(top);
          hit_pos = un_pos;
          gc_pos = un_gc;
          t_ground = cast(un_gc, down, c2, k2).t;
        }
      }
      const bool no_ground = isinf(t_ground);
      const float fall_dist = at_minimum(t_ground, top) + r;
      const V3 new_pos = gc_pos - up_times(fall_dist);
      const V3 to_new = new_pos - x;
      const bool valid_move = norm3(to_new) > 0.0f;
      if (!no_ground && valid_move) {
        out_pos = new_pos;
        out_vel = mul3(to_new, a.inv_dt);
      }
    }
  }

  // ---- fall_system, at the post-move position's MOVE_MARGIN cell ----
  const int* cf = a.cand2;
  if (cf) cf += (size_t)short_cell(out_pos, a.x0_2, a.y0_2, a.cs2, a.nx2, a.ny2) * a.K2;
  const V3 o_fall = out_pos + up_times(a.fall_cast_up);
  const float t_fall = cast(o_fall, down, cf, k2).t;
  const bool no_fall = isinf(t_fall) || t_fall < r;
  const float fall_dist = at_clamp_hi(t_fall - r, a.fall_max);
  const bool keep = no_fall || !(a.alive[n] > 0.0f);
  const V3 fpos = keep ? out_pos : out_pos - up_times(fall_dist);

  if (a.work) {
    atomicAdd(a.work, pairs);
    if ((threadIdx.x & 31) == 0) atomicAdd(a.work + 1, normals);
  }
  if ((threadIdx.x & 31) == 0) {
    float* p = a.pos_out + 3 * (size_t)n;
    float* q = a.vel_out + 3 * (size_t)n;
    p[0] = fpos.x;
    p[1] = fpos.y;
    p[2] = fpos.z;
    q[0] = out_vel.x;
    q[1] = out_vel.y;
    q[2] = out_vel.z;
  }
}

extern "C" int move_fused_launch(const MoveArgs* args, void* stream) {
  if (args->N <= 0) return 0;
  const unsigned blocks = (unsigned)((args->N + kMoveWarps - 1) / kMoveWarps);
  move_fused_kernel<<<blocks, 32 * kMoveWarps, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
