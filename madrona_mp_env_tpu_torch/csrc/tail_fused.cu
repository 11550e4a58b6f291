// K5: the fused scalar tail of the Zone step, one thread per world.
//
// autoheal -> zone rotation, membership and control -> match info (step
// counter, team kills, points, win) -> zone reward (breadcrumb, reload,
// kill, shot, explore, zone-distance, in-zone and control terms, team-area
// spread bonus) -> dead agents' flags cleared -> team mean and team-spirit
// blend -> done -> per-zone stats.
//
// Replaces the TPU kernel madrona_mp_env_tpu/ops/tail_pallas.py
// _make_kernel (via _get_tail_call / tail_fused_system). Plain version:
// ops/tail_fused.py tail_fused_plain, which this kernel repeats operation
// for operation (built with --fmad=false, IEEE divide and sqrt), so the two
// agree bit for bit; team sums and the spread polygon add in agent order.
//
// Bound on the H100: a few dozen float operations per agent against ~126
// bytes moved per agent and ~300 per world, so it is bound by bytes, and
// at the slice's 1024 worlds x 12 agents that is ~1.9 MB, well under a
// microsecond at 3.35 TB/s: launch latency dominates. Design: the TPU
// version packed the state into [rows, W] tiles (~40 concatenates and
// transposes in, ~30 slices out, each a launch of its own on a host-bound
// step); here the kernel reads the WorldState tensors where they lie
// through a struct of device pointers and writes fresh output tensors, so
// the whole tail is one launch. One thread per world keeps the per-world
// chain and its 12-wide team reductions sequential in agent order.
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
  const int* force_reset;
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
  float autoheal_amount, lift;
};

namespace {

constexpr int kMaxAgents = 32;  // ops/tail_fused.py MAX_AGENTS
constexpr int kZoneCols = 11;   // assets/map_data.py ZONE_FRAME_COLS
constexpr int kCenter = 0, kCos = 3, kSin = 4, kMin = 5, kMax = 8;
constexpr int kNumCoefs = 9;    // config.py NUM_REWARD_COEFS and RC_* below
constexpr int kSpirit = 0, kShot = 1, kExplore = 2, kInZone = 3, kCtrl = 5,
              kZoneDist = 6, kPoint = 7, kCrumb = 8;

__global__ void tail_fused_kernel(const TailArgs a) {
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
  bool finished = cur_step >= a.episode_len || a.force_reset[w] != 0;
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

}  // namespace

extern "C" int tail_fused_launch(const TailArgs* args, void* stream) {
  if (args->W <= 0) return 0;
  if (args->A > kMaxAgents || args->team_size <= 0 || args->A != 2 * args->team_size)
    return (int)cudaErrorInvalidValue;
  const int threads = 128;
  tail_fused_kernel<<<(args->W + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
      *args);
  return (int)cudaGetLastError();
}
