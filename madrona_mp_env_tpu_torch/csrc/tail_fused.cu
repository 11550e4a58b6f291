// K5: the fused scalar tail of the Zone step.
//
// autoheal -> zone rotation, membership and control -> match info (step
// counter, team kills, points, win) -> zone reward (breadcrumb, reload,
// kill, shot, explore, zone-distance, in-zone and control terms, team-area
// spread bonus; in a LearnShooting world of the world curriculum the
// shooting reward instead) -> dead agents' flags cleared -> team mean and
// team-spirit blend -> done -> per-zone stats.
//
// Replaces the TPU kernel madrona_mp_env_tpu/ops/tail_pallas.py
// _make_kernel (via _get_tail_call / tail_fused_system). Plain version:
// ops/tail_fused.py tail_fused_plain, which both kernels here repeat
// operation for operation (built with --fmad=false, IEEE divide and
// sqrt), so they agree with it bit for bit; team sums and the spread
// polygon add in agent order.
//
// Bound on the H100: a few dozen float operations per agent against ~126
// bytes moved per agent and ~300 per world, so it is bound by bytes, and
// at the slice's 1024 worlds x 12 agents that is ~1.9 MB, well under a
// microsecond at 3.35 TB/s: latency dominates. The TPU version packed the
// state into [rows, W] tiles (~40 concatenates and transposes in, ~30
// slices out, each a launch of its own on a host-bound step); here a
// kernel reads the WorldState tensors where they lie through a struct of
// device pointers and writes fresh output tensors: the whole tail is one
// launch.
//
// tail_fused_kernel<L> (the step's): a group of L lanes per world (16 when
// A <= 16, else the warp), lane i owning agent i, so per-agent fields are
// read by adjacent lanes and 1024 worlds fill 256 blocks. Each lane
// computes the world's scalars itself (the same broadcast loads); counts
// of agents in the zone and of team kills are ballots of the group; the
// spread polygon and the team sums gather teammates' values by
// __shfl_sync and add them in index order, as the plain version does.
// tail_fused_v1_kernel, the predecessor: one thread per world walking its
// agents serially (8 blocks of 128 threads at 1024 worlds); timed beside
// it, launched by no path. It has no LearnShooting override and refuses
// arguments that ask for one.
//
// The LearnShooting override (SimFlags.EnableCurriculum; the TPU kernel's
// tail_pallas.py:330-337) is a second instantiation,
// tail_fused_kernel<L, true>: after the spread bonus, a lane of a world
// whose world_curriculum is LearnShooting (0) takes the shooting reward
// (+0.5 landed, else -0.05 fired, minus 0.5 reloaded) for its task reward
// and keeps the zone system's distance; the flags' clearing and the team
// blend follow as before. tail_fused_kernel<L, false>, the step's without
// the flag, is the code it was.
#include <cuda_runtime.h>
#include <math_constants.h>

// field order = ops/tail_fused.py _TailArgs
struct TailArgs {
  // inputs, per agent [W, A, ...]
  const float* pos;
  const float* hp;
  const float* alive;
  const int* autoheal;
  const float* min_dist;
  const float* crumb;
  const float* fired_t;
  const bool* kill;
  const int* landed;
  const int* wsc;
  const bool* wkilled;
  const bool* reloaded;
  const bool* has_died;
  const int* new_cells;
  const float* rc;
  // inputs, per world [W, ...]
  const int* cur_step;
  const int* win;
  const int* team_kills;
  const int* team_points;
  const int* zone_cur;
  const int* zone_ctrl;
  const bool* zone_captured;
  const int* zone_rem;
  const int* zone_sup;
  const int* zone_stats;
  const int* world_curr;  // [W] WorldCurriculum (LearnShooting = 0)
  const void* force_reset;  // [W] bool or integer, read as != 0
  // map constants
  const float* zone_frames;  // [max_zones, kZoneCols]
  const float* world_min;    // [3]
  const float* world_max;
  // outputs, per agent
  float* o_hp;
  int* o_autoheal;
  bool* o_in_zone;
  float* o_min_dist;
  float* o_reward;
  bool* o_kill;
  int* o_landed;
  bool* o_wkilled;
  int* o_wsc;
  float* o_fired_t;
  int* o_done;
  int* o_new_cells;
  // outputs, per world
  int* o_cur_step;
  bool* o_finished;
  int* o_win;
  int* o_team_kills;
  int* o_team_points;
  int* o_zone_cur;
  int* o_zone_ctrl;
  bool* o_contested;
  bool* o_captured;
  bool* o_earned;
  int* o_zone_rem;
  int* o_zone_sup;
  float* o_team_rewards;
  int* o_zone_stats;
  bool* o_new_captured;
  int W, A, team_size, num_zones, max_zones, episode_len, steps_per_zone,
      point_interval, win_points;
  int force_reset_bytes;  // force_reset's element size: 1, 2, 4 or 8
  int curriculum;         // SimFlags.EnableCurriculum: read world_curr
  float autoheal_amount, lift;
};

namespace {

constexpr int kMaxAgents = 32;  // ops/tail_fused.py MAX_AGENTS
constexpr int kZoneCols = 11;   // assets/map_data.py ZONE_FRAME_COLS
constexpr int kCenter = 0, kCos = 3, kSin = 4, kMin = 5, kMax = 8;
constexpr int kNumCoefs = 9;    // config.py NUM_REWARD_COEFS and RC_* below
constexpr int kSpirit = 0, kShot = 1, kExplore = 2, kInZone = 3, kCtrl = 5,
              kZoneDist = 6, kPoint = 7, kCrumb = 8;

// force_reset[w] != 0, in its own dtype
__device__ __forceinline__ bool forced(const TailArgs& a, int w) {
  switch (a.force_reset_bytes) {
    case 1: return static_cast<const unsigned char*>(a.force_reset)[w] != 0;
    case 2: return static_cast<const short*>(a.force_reset)[w] != 0;
    case 4: return static_cast<const int*>(a.force_reset)[w] != 0;
    default: return static_cast<const long long*>(a.force_reset)[w] != 0;
  }
}

__global__ void tail_fused_v1_kernel(const TailArgs a) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= a.W) return;
  const int A = a.A, ts = a.team_size;
  const size_t base = (size_t)w * A;

  // ---- autoHealSystem ----
  for (int i = 0; i < A; ++i) {
    const size_t k = base + i;
    const bool alive = a.alive[k] > 0.0f;
    const int ah = a.autoheal[k];
    float hp = a.hp[k];
    if (alive && ah == 0 && hp < 100.0f) hp = fminf(hp + a.autoheal_amount, 100.0f);
    a.o_hp[k] = hp;
    a.o_autoheal[k] = (alive && ah > 0) ? ah - 1 : ah;
  }

  // ---- zoneSystem ----
  int ctrl = a.zone_ctrl[w];
  int zrem = a.zone_rem[w] - (ctrl != -1 ? 1 : 0);
  const bool rotate = zrem == 0;
  int zcur = a.zone_cur[w];
  if (rotate) zcur = (zcur + 1 == a.num_zones) ? 0 : zcur + 1;
  bool captured = a.zone_captured[w] && !rotate;
  if (rotate) zrem = a.steps_per_zone;
  int zsup = rotate ? a.point_interval : a.zone_sup[w];
  const float* f = a.zone_frames + (size_t)zcur * kZoneCols;

  float dist[kMaxAgents], mind[kMaxAgents];
  bool inz[kMaxAgents];
  int num_a = 0, num_b = 0;
  for (int i = 0; i < A; ++i) {
    const size_t k = base + i;
    const float px = a.pos[3 * k], py = a.pos[3 * k + 1], pz = a.pos[3 * k + 2];
    const float dx = px - f[kCenter], dy = py - f[kCenter + 1], dz = pz - f[kCenter + 2];
    dist[i] = sqrtf(dx * dx + dy * dy + dz * dz);
    mind[i] = rotate ? dist[i] : a.min_dist[k];
    const float c = f[kCos], s = f[kSin];
    const float x = c * px - s * py;
    const float y = s * px + c * py;
    const float z = pz + a.lift;
    inz[i] = (x >= f[kMin]) && (x <= f[kMax]) && (y >= f[kMin + 1]) && (y <= f[kMax + 1]) &&
             (z >= f[kMin + 2]) && (z <= f[kMax + 2]);
    if (inz[i]) {
      if (i / ts == 1) ++num_b; else ++num_a;
    }
  }
  zsup = zsup - 1;
  const bool contested = num_a > 0 && num_b > 0;
  const bool nobody = num_a == 0 && num_b == 0;
  const bool a_takes = num_a > 0 && num_b == 0 && ctrl != 0;
  const bool b_takes = num_b > 0 && num_a == 0 && ctrl != 1;
  ctrl = (contested || nobody) ? -1 : a_takes ? 0 : b_takes ? 1 : ctrl;
  const bool changed = contested || nobody || a_takes || b_takes;
  captured = captured && !changed;
  if (changed) zsup = a.point_interval;

  // ---- zoneMatchInfoSystem ----
  const int cur_step = a.cur_step[w] + 1;
  bool finished = cur_step >= a.episode_len || forced(a, w);
  const bool first = cur_step == 1;
  int tk0 = first ? 0 : a.team_kills[2 * w], tk1 = first ? 0 : a.team_kills[2 * w + 1];
  int tp0 = first ? 0 : a.team_points[2 * w], tp1 = first ? 0 : a.team_points[2 * w + 1];
  int win = first ? -1 : a.win[w];
  for (int i = 0; i < A; ++i) {
    if (a.wkilled[base + i]) {
      if (i / ts == 1) ++tk0; else ++tk1;
    }
  }
  const bool earned = zsup == 0;
  if (earned) zsup = a.point_interval;
  const bool new_captured = earned && !captured;
  captured = captured || earned;
  const int ctrl_cl = ctrl < 0 ? 0 : (ctrl > 1 ? 1 : ctrl);
  if (earned && ctrl_cl == 0) ++tp0;
  if (earned && ctrl_cl == 1) ++tp1;
  finished = finished || tp0 >= a.win_points || tp1 >= a.win_points;
  const int result = tp0 > tp1 ? 0 : (tp1 > tp0 ? 1 : 2);
  if (finished) win = result;

  // ---- zoneRewardSystem ----
  const float area2 = 2.0f * ((a.world_max[0] - a.world_min[0]) * (a.world_max[1] - a.world_min[1]));
  float r[kMaxAgents];
  for (int i = 0; i < A; ++i) {
    const size_t k = base + i;
    const float* rc = a.rc + k * kNumCoefs;
    const bool dead = a.alive[k] == 0.0f;
    const int team = i / ts;
    float v = -rc[kCrumb] * a.crumb[k];
    v = v - (a.reloaded[k] ? 0.5f : 0.0f);
    v = v + (a.kill[k] ? 1.0f : 0.0f);
    v = v + (a.landed[k] >= 0 ? rc[kShot] : 0.0f);
    v = v - (a.wkilled[k] ? 1.5f : 0.0f);
    v = v - (a.wsc[k] > 0 ? rc[kShot] : 0.0f);
    v = v + (float)a.new_cells[k] * rc[kExplore];
    const bool closer = !inz[i] && dist[i] < mind[i];
    const float scale = rc[kZoneDist] * (a.has_died[k] ? 1.0f : 10.0f);
    const float approach = closer ? scale * (mind[i] - dist[i]) : 0.0f;
    if (closer) mind[i] = dist[i];
    v = v + (inz[i] ? rc[kInZone] : 0.0f);
    v = v + approach;
    const bool mine = ctrl == team;
    const bool other = ctrl != -1 && !mine;
    float rz = mine ? rc[kCtrl] : 0.0f;
    rz = rz + ((mine && earned) ? rc[kPoint] : 0.0f);
    rz = rz - (other ? rc[kCtrl] : 0.0f);
    rz = rz - ((other && earned) ? rc[kPoint] : 0.0f);
    v = v + rz;
    // team-area spread: |cross| of consecutive teammate pairs (index order)
    float poly = 0.0f, ex0 = 0.0f, ey0 = 0.0f;
    bool have = false;
    for (int j = team * ts; j < (team + 1) * ts; ++j) {
      if (j == i) continue;
      const float ex = a.pos[3 * (base + j)] - a.pos[3 * k];
      const float ey = a.pos[3 * (base + j) + 1] - a.pos[3 * k + 1];
      if (have) poly = poly + fabsf(ex0 * ey - ey0 * ex);
      ex0 = ex;
      ey0 = ey;
      have = true;
    }
    const float spread = poly / area2 * 0.01f;
    v = v + (dead ? 0.0f : spread);
    r[i] = v;

    // dead agents: clear transient combat flags
    a.o_kill[k] = a.kill[k] && !dead;
    a.o_landed[k] = dead ? -1 : a.landed[k];
    a.o_wkilled[k] = a.wkilled[k] && !dead;
    a.o_wsc[k] = dead ? 0 : a.wsc[k];
    a.o_fired_t[k] = dead ? -CUDART_INF_F : a.fired_t[k];
    a.o_in_zone[k] = inz[i];
    a.o_min_dist[k] = mind[i];
    a.o_done[k] = finished ? 1 : 0;
    a.o_new_cells[k] = 0;
  }

  // team mean (members in index order) + team-spirit blend
  float mean[2];
  for (int t = 0; t < 2; ++t) {
    float s = 0.0f;
    for (int j = t * ts; j < (t + 1) * ts; ++j) s = s + r[j];
    mean[t] = s / (float)ts;
  }
  for (int i = 0; i < A; ++i) {
    const size_t k = base + i;
    const float sp = a.rc[k * kNumCoefs + kSpirit];
    a.o_reward[k] = r[i] * (1.0f - sp) + mean[i / ts] * sp;
  }

  a.o_cur_step[w] = cur_step;
  a.o_finished[w] = finished;
  a.o_win[w] = win;
  a.o_team_kills[2 * w] = tk0;
  a.o_team_kills[2 * w + 1] = tk1;
  a.o_team_points[2 * w] = tp0;
  a.o_team_points[2 * w + 1] = tp1;
  a.o_zone_cur[w] = zcur;
  a.o_zone_ctrl[w] = ctrl;
  a.o_contested[w] = contested;
  a.o_captured[w] = captured;
  a.o_earned[w] = earned;
  a.o_zone_rem[w] = zrem;
  a.o_zone_sup[w] = zsup;
  a.o_team_rewards[2 * w] = mean[0];
  a.o_team_rewards[2 * w + 1] = mean[1];
  a.o_new_captured[w] = new_captured;
  // zone stats columns [swaps, capturedA, capturedB, contested, active]
  for (int z = 0; z < a.max_zones; ++z) {
    const bool mz = z == zcur;
    const int inc[5] = {mz && new_captured, mz && captured && ctrl_cl == 0,
                        mz && captured && ctrl_cl == 1, mz && contested, mz};
    for (int c = 0; c < 5; ++c) {
      const size_t k = ((size_t)w * a.max_zones + z) * 5 + c;
      a.o_zone_stats[k] = a.zone_stats[k] + inc[c];
    }
  }
}

// zone stats column c of world w's active zone: [swaps, capturedA,
// capturedB, contested, active]
__device__ __forceinline__ int zone_inc(int c, bool new_captured, bool captured, int ctrl_cl,
                                        bool contested) {
  switch (c) {
    case 0: return new_captured;
    case 1: return captured && ctrl_cl == 0;
    case 2: return captured && ctrl_cl == 1;
    case 3: return contested;
    default: return 1;
  }
}

template <int L, bool LS>
__global__ void tail_fused_kernel(const TailArgs a) {
  constexpr unsigned kFull = 0xffffffffu;
  const int gw = (int)((blockIdx.x * blockDim.x + threadIdx.x) / L);
  const int i = threadIdx.x % L;        // this lane's agent
  const int base = threadIdx.x % 32 - i;  // the group's first lane in the warp
  const int A = a.A, ts = a.team_size;
  // every lane of the warp runs every shuffle and ballot: a group past the
  // last world works on the last one and stores nothing, a lane past the
  // last agent on the world's last agent and counts for nothing
  const bool mine = gw < a.W && i < A;
  const int w = gw < a.W ? gw : a.W - 1;
  const int ag = i < A ? i : A - 1;
  const int team = ag / ts;
  const size_t k = (size_t)w * A + ag;
  const unsigned group_bits = (L == 32 ? kFull : ((1u << L) - 1u)) << base;
  const unsigned team0 = (1u << ts) - 1u, team1 = team0 << ts;

  // ---- autoHealSystem ----
  const float alive_f = a.alive[k];
  const bool alive = alive_f > 0.0f;
  const int ah = a.autoheal[k];
  float hp = a.hp[k];
  if (alive && ah == 0 && hp < 100.0f) hp = fminf(hp + a.autoheal_amount, 100.0f);

  // ---- zoneSystem ----
  int ctrl = a.zone_ctrl[w];
  int zrem = a.zone_rem[w] - (ctrl != -1 ? 1 : 0);
  const bool rotate = zrem == 0;
  int zcur = a.zone_cur[w];
  if (rotate) zcur = (zcur + 1 == a.num_zones) ? 0 : zcur + 1;
  bool captured = a.zone_captured[w] && !rotate;
  if (rotate) zrem = a.steps_per_zone;
  int zsup = rotate ? a.point_interval : a.zone_sup[w];
  const float* f = a.zone_frames + (size_t)zcur * kZoneCols;

  const float px = a.pos[3 * k], py = a.pos[3 * k + 1], pz = a.pos[3 * k + 2];
  const float dx = px - f[kCenter], dy = py - f[kCenter + 1], dz = pz - f[kCenter + 2];
  const float dist = sqrtf(dx * dx + dy * dy + dz * dz);
  float mind = rotate ? dist : a.min_dist[k];
  const float c = f[kCos], s = f[kSin];
  const float x = c * px - s * py;
  const float y = s * px + c * py;
  const float z = pz + a.lift;
  const bool inz = (x >= f[kMin]) && (x <= f[kMax]) && (y >= f[kMin + 1]) &&
                   (y <= f[kMax + 1]) && (z >= f[kMin + 2]) && (z <= f[kMax + 2]);
  const unsigned in_bits = (__ballot_sync(kFull, mine && inz) & group_bits) >> base;
  const int num_a = __popc(in_bits & team0), num_b = __popc(in_bits & team1);
  zsup = zsup - 1;
  const bool contested = num_a > 0 && num_b > 0;
  const bool nobody = num_a == 0 && num_b == 0;
  const bool a_takes = num_a > 0 && num_b == 0 && ctrl != 0;
  const bool b_takes = num_b > 0 && num_a == 0 && ctrl != 1;
  ctrl = (contested || nobody) ? -1 : a_takes ? 0 : b_takes ? 1 : ctrl;
  const bool changed = contested || nobody || a_takes || b_takes;
  captured = captured && !changed;
  if (changed) zsup = a.point_interval;

  // ---- zoneMatchInfoSystem ----
  const int cur_step = a.cur_step[w] + 1;
  bool finished = cur_step >= a.episode_len || forced(a, w);
  const bool first = cur_step == 1;
  int tk0 = first ? 0 : a.team_kills[2 * w], tk1 = first ? 0 : a.team_kills[2 * w + 1];
  int tp0 = first ? 0 : a.team_points[2 * w], tp1 = first ? 0 : a.team_points[2 * w + 1];
  int win = first ? -1 : a.win[w];
  const bool wk = a.wkilled[k];
  const unsigned wk_bits = (__ballot_sync(kFull, mine && wk) & group_bits) >> base;
  tk0 += __popc(wk_bits & team1);  // team 0 scores the kills of team 1
  tk1 += __popc(wk_bits & team0);
  const bool earned = zsup == 0;
  if (earned) zsup = a.point_interval;
  const bool new_captured = earned && !captured;
  captured = captured || earned;
  const int ctrl_cl = ctrl < 0 ? 0 : (ctrl > 1 ? 1 : ctrl);
  if (earned && ctrl_cl == 0) ++tp0;
  if (earned && ctrl_cl == 1) ++tp1;
  finished = finished || tp0 >= a.win_points || tp1 >= a.win_points;
  const int result = tp0 > tp1 ? 0 : (tp1 > tp0 ? 1 : 2);
  if (finished) win = result;

  // ---- zoneRewardSystem ----
  const float area2 =
      2.0f * ((a.world_max[0] - a.world_min[0]) * (a.world_max[1] - a.world_min[1]));
  const float* rc = a.rc + k * kNumCoefs;
  const bool dead = alive_f == 0.0f;
  float v = -rc[kCrumb] * a.crumb[k];
  v = v - (a.reloaded[k] ? 0.5f : 0.0f);
  v = v + (a.kill[k] ? 1.0f : 0.0f);
  v = v + (a.landed[k] >= 0 ? rc[kShot] : 0.0f);
  v = v - (wk ? 1.5f : 0.0f);
  v = v - (a.wsc[k] > 0 ? rc[kShot] : 0.0f);
  v = v + (float)a.new_cells[k] * rc[kExplore];
  [[maybe_unused]] const float mind_zone = mind;
  const bool closer = !inz && dist < mind;
  const float scale = rc[kZoneDist] * (a.has_died[k] ? 1.0f : 10.0f);
  const float approach = closer ? scale * (mind - dist) : 0.0f;
  if (closer) mind = dist;
  v = v + (inz ? rc[kInZone] : 0.0f);
  v = v + approach;
  const bool mine_zone = ctrl == team;
  const bool other = ctrl != -1 && !mine_zone;
  float rz = mine_zone ? rc[kCtrl] : 0.0f;
  rz = rz + ((mine_zone && earned) ? rc[kPoint] : 0.0f);
  rz = rz - (other ? rc[kCtrl] : 0.0f);
  rz = rz - ((other && earned) ? rc[kPoint] : 0.0f);
  v = v + rz;
  // team-area spread: |cross| of consecutive teammate pairs (index order)
  float poly = 0.0f, ex0 = 0.0f, ey0 = 0.0f;
  bool have = false;
  for (int q = 0; q < ts; ++q) {
    const int j = team * ts + q;
    const float xj = __shfl_sync(kFull, px, base + j);
    const float yj = __shfl_sync(kFull, py, base + j);
    if (j == ag) continue;
    const float ex = xj - px;
    const float ey = yj - py;
    if (have) poly = poly + fabsf(ex0 * ey - ey0 * ex);
    ex0 = ex;
    ey0 = ey;
    have = true;
  }
  const float spread = poly / area2 * 0.01f;
  v = v + (dead ? 0.0f : spread);
  if constexpr (LS) {
    // a LearnShooting world: the shooting reward replaces the task's (its
    // 0 + x is x: no term is -0) and the zone distance keeps its value
    if (a.world_curr[w] == 0) {
      v = (a.landed[k] >= 0 ? 0.5f : (a.fired_t[k] >= 0.0f ? -0.05f : 0.0f)) -
          (a.reloaded[k] ? 0.5f : 0.0f);
      mind = mind_zone;
    }
  }

  // team mean (members in index order) + team-spirit blend
  float s0 = 0.0f, s1 = 0.0f;
  for (int j = 0; j < ts; ++j) s0 = s0 + __shfl_sync(kFull, v, base + j);
  for (int j = ts; j < A; ++j) s1 = s1 + __shfl_sync(kFull, v, base + j);
  const float mean0 = s0 / (float)ts, mean1 = s1 / (float)ts;
  const float sp = rc[kSpirit];

  if (mine) {
    a.o_hp[k] = hp;
    a.o_autoheal[k] = (alive && ah > 0) ? ah - 1 : ah;
    // dead agents: clear transient combat flags
    a.o_kill[k] = a.kill[k] && !dead;
    a.o_landed[k] = dead ? -1 : a.landed[k];
    a.o_wkilled[k] = wk && !dead;
    a.o_wsc[k] = dead ? 0 : a.wsc[k];
    a.o_fired_t[k] = dead ? -CUDART_INF_F : a.fired_t[k];
    a.o_in_zone[k] = inz;
    a.o_min_dist[k] = mind;
    a.o_done[k] = finished ? 1 : 0;
    a.o_new_cells[k] = 0;
    a.o_reward[k] = v * (1.0f - sp) + (team == 0 ? mean0 : mean1) * sp;
  }
  if (gw >= a.W) return;
  if (i == 0) {
    a.o_cur_step[w] = cur_step;
    a.o_finished[w] = finished;
    a.o_win[w] = win;
    a.o_team_kills[2 * w] = tk0;
    a.o_team_kills[2 * w + 1] = tk1;
    a.o_team_points[2 * w] = tp0;
    a.o_team_points[2 * w + 1] = tp1;
    a.o_zone_cur[w] = zcur;
    a.o_zone_ctrl[w] = ctrl;
    a.o_contested[w] = contested;
    a.o_captured[w] = captured;
    a.o_earned[w] = earned;
    a.o_zone_rem[w] = zrem;
    a.o_zone_sup[w] = zsup;
    a.o_team_rewards[2 * w] = mean0;
    a.o_team_rewards[2 * w + 1] = mean1;
    a.o_new_captured[w] = new_captured;
  }
  const int n = a.max_zones * 5;
  for (int e = i; e < n; e += L) {
    const size_t kz = (size_t)w * n + e;
    const int inc = e / 5 == zcur ? zone_inc(e % 5, new_captured, captured, ctrl_cl, contested) : 0;
    a.o_zone_stats[kz] = a.zone_stats[kz] + inc;
  }
}

// threads per block of tail_fused_kernel: 4 worlds of 16 lanes, 2 of 32
constexpr int kTailThreads = 64;

bool tail_args_ok(const TailArgs* args) {
  return args->A <= kMaxAgents && args->team_size > 0 && args->A == 2 * args->team_size &&
         (args->force_reset_bytes == 1 || args->force_reset_bytes == 2 ||
          args->force_reset_bytes == 4 || args->force_reset_bytes == 8);
}

}  // namespace

extern "C" int tail_fused_launch(const TailArgs* args, void* stream) {
  if (args->W <= 0) return 0;
  if (!tail_args_ok(args)) return (int)cudaErrorInvalidValue;
  const int lanes = args->A <= 16 ? 16 : 32;
  const unsigned blocks = (unsigned)(((size_t)args->W * lanes + kTailThreads - 1) / kTailThreads);
  cudaStream_t st = (cudaStream_t)stream;
  if (lanes == 16 && args->curriculum)
    tail_fused_kernel<16, true><<<blocks, kTailThreads, 0, st>>>(*args);
  else if (lanes == 16)
    tail_fused_kernel<16, false><<<blocks, kTailThreads, 0, st>>>(*args);
  else if (args->curriculum)
    tail_fused_kernel<32, true><<<blocks, kTailThreads, 0, st>>>(*args);
  else
    tail_fused_kernel<32, false><<<blocks, kTailThreads, 0, st>>>(*args);
  return (int)cudaGetLastError();
}

extern "C" int tail_fused_v1_launch(const TailArgs* args, void* stream) {
  if (args->W <= 0) return 0;
  if (!tail_args_ok(args) || args->curriculum) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  tail_fused_v1_kernel<<<(args->W + threads - 1) / threads, threads, 0,
                         (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
