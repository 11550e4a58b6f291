#!/usr/bin/env python3
"""Drive the PyTorch port (madrona_mp_env_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run loudly:

1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build every CUDA kernel from csrc/ (one nvcc per source, all at once);
3. each kernel against its plain PyTorch version on the card, on the
   inputs of every launch that one real step makes at 1024 worlds of Zone
   6v6 (captured where the sim calls each entry), with its time, the plain
   version's time and its bound, each summed over the step's launches of
   that entry. On data/simple_map: K1 hitscan rays, K2 sensor fans, K3
   sensor rays vs capsules, K4 culled (the L1 casts), K4' packed (the L2,
   L3 and fall casts), K5 the fused scalar tail, K4 dense on the same
   step taken with MPENV_SC_PACK=0, and K9 (the sensor fans over the
   sensor-ray tables) on the same step taken with MPENV_FAN_V9=1, with
   how often its t equals K2's on the same rays (hits and misses must
   agree on >= 99.5%); then the unfused system chain against the fused
   order through tail_fused_plain, bit for bit, on the step's tail
   inputs. Before each map's rows, build_sensor_rays on its default fan
   route under torch.cuda.set_sync_debug_mode("warn"): each host sync it
   makes is logged with its line (one from repeat_interleave fails).
   On data/town_map (6,144 triangles, PVS tables): K1, K3, K4
   culled, K4', K5, K6 the cell-culled sensor fans, and K2 over the whole
   soup on K6's fans, with how often the two agree (the PVS's quality at
   full width). K1, K2, K6 and K7 (the register-blocked sweep,
   csrc/fan_sweep_rb.cuh), K4 culled and K4' (a warp per group of
   casts, csrc/sc_sweep.cuh), K4 dense and K8 (the rows split over a
   cluster, csrc/sphere_cast.cu sc_dense_kernel), K3 (a block per fan,
   the (z-group, capsule) terms hoisted) and K5 (a group of lanes per
   world) are held bit for bit (K4: t and winner row; K8: t and normal;
   K3: t and capsule index; K5 every output) against their plain
   versions and their predecessors (ray_tris_v1, P2's exact entry,
   fan_culled_v1, fan_flat_v1, sphere_cast_culled_v1, sphere_cast_v1,
   sphere_cast_vs_tris_v1, fan_capsules_v1, tail_fused_v1), timed
   beside them in turns (new, old, old, new), with
   their device time (torch.profiler), ptxas' registers and spills, the
   floor at one f32 instruction per operation, K1's, K7's, K4 dense's
   and K8's row split,
   K6's helper launches (the cell order), K3's share of pairs that reach
   a square root and K5's host us per call. Every check_equal row
   compares int32 views of its float outputs, -0 against +0 too, but K4
   culled on town_map against its plain version, held as values (the
   sign of 0 of its directionless casts); float outputs equal as values
   but not as bits are counted and logged. P3, which shares K4's pair
   arithmetic, with its registers and spills. Zone 3v3
   (team size 3: a LOS run of 12 rays, not a multiple of 8) on each map:
   K1, K7, the stacked-direction fan over the whole soup, and K5 on one
   real step's launches; K8 on that step's L1
   casts over the whole soup (also against its predecessor, the two
   timed in turns) and K3x on its sensor rays with explicit
   origins (equal to K3's hits too), and the unfused tail chain at team
   size 3. The kernel bench's shapes (tools/kernel_bench.py make_inputs,
   1024 worlds, team sizes 6 and 3, each map): K7 (at team size 3 also
   with a z offset per ray), K8 with and without normals and K4 dense,
   each on the JAX bench's casts (all start overlapping) and on the
   moving ones (none does), and K3x, each bit-equal to its plain version
   (K8 and K4 dense also to their predecessors, timed in turns), then
   the kernel
   bench itself, whose launches those rows count. The probes: P3, the
   fused movement (csrc/move_fused.cu), on each map under both cast
   routes on the state a step hands the movement pair (reset + 5 steps at
   1024 worlds), bit-equal to its plain version and (culled) to the
   step's own split pair on the kernels, with the split pair's time and
   CUDA launches beside the fused launch's; P5 (K9 through cand_idx, on
   tables gathered beforehand with and without the gather), P6 (K9's
   candidates staged all at once or 8 at a time, the dense fan and the
   v9 end-to-end path beside them) and P2 (K2's sweep with an exact
   divide, an IEEE reciprocal, rcp.approx, the direction dots alone, the
   epilogue alone and 8-row chunks; one torch.matmul of the direction
   dots beside them) at 12,288 fans x 104 rays on simple_map, each
   bit-equal to its plain version (rcp.approx: its error printed); P4
   (the sphere cast with its dot products as 3xTF32 mma.sync, 24,576
   casts on simple_map) within its bars of its plain version, with K4
   dense's time and the TPU probe's parity against it, and the two
   products as torch.matmul beside it; P1 (the issue-rate chains on a
   256 x 256 tile, 2048 links deep: mul, divide and select bit-equal, the
   fma and rcp.approx chains within their bars; the bf16 mma.sync chains,
   64 links of 2048 x 8 / 128 x 768, with 64 torch.matmul calls beside
   them); then each probe's main, whose launches those rows count (P1's
   main prints each kernel's loop body from cuobjdump -sass);
4. the simple_map path: Env(device="cuda") at 1024 worlds, reset + 100
   steps of bench.py's run-and-shoot action mix, every launch counter
   zeroed before and read after: K1, K2, K3, K4 culled, K4' and K5 must
   launch (K2 and K3 101 times, K1, K4 culled and K5 100, K4' 300), K4
   dense, K6,
   K9, the fused movement P3 and the predecessors (on every path) must
   not; env-steps/s beside the card's name and limit; then CUDA
   launches per step from
   torch.profiler, with the fused tail and, for comparison in the same
   process, with the unfused chain it replaced; then the same path with
   MPENV_FAN_V9=1, where K9 must launch and K2 must not (K3 101, K5
   100);
5. the crossplay eval: EvalManager on the card at 1024 worlds with P = 2
   policies at full width (weights made from seeds: the trained
   checkpoint needs JAX to read), 100 sampled steps, every counter zeroed
   before and read after; agent-steps/s, env-steps/s and the policy
   forward's ms per step;
6. K4 dense's own path: 10 simple_map steps with MPENV_SC_PACK=0, K4
   dense launched 3 times a step;
7. the town_map path: reset + 100 steps at 1024 worlds: K1, K3, K4
   culled, K4', K5 and K6 must launch (K6 and K3 101 times, K1, K4
   culled and K5 100, K4' 300), K2 and K4
   dense must not; then 10 steps of the forced-dense fan route
   (MPENV_FAN_CULL=0), where K2 runs 11 times over the 6,144-triangle
   soup; then Zone 3v3 on each map, reset + 50
   steps at 1024 worlds: K1, K7 and K5 must launch (K7 and K3 51 times,
   K1 and K5 50), K2, K6 and K9 must not;
8. the training path: the train CLI's TrainingManager at 1024 worlds x
   40 steps per update, the LSTM-512 policy, E = 1: 1 update of Zone 6v6
   on the default fan route (K2), 1 with MPENV_FAN_V9=1 (K9), 1 of
   Zone 3v3 (K7) on each map, then 1 each of Zone 6v6 with --bf16 and
   --fp16 (the policy's compute dtype; no float32 fallback: the stored
   observations and BPTT start states must come out in it); updates/s,
   samples/s and each update's rollout and PPO-update ms (CUDA events);
   finite losses, parameters that move, the fan's launches; then the PBT
   population through the CLI's build at 1024 worlds, Zone 6v6, E = 2,
   P = 2, play portions 0.25 / 0.5 / 0.25, --pbt-update-frequency 1, 1
   update followed by eval_elo, store_past_policy,
   update_population and resample_matchmaking (CUDA events each), with
   episode_len 40 and 50 eval steps (reductions of EnvConfig's default
   and the CLI's 1000, so that eval matches end): each kernel of the 6v6
   path launched once per rollout and eval step (K4' three times) and
   no other kernel, the past params bit-unchanged by each update, every
   slot's actor count kept by each rotation, more finished eval matches
   than the 1024 the eval's step-0 reset ends, finite ELOs and losses;
   then the trainer's ELO fold (TrainingManager._match_elo) on planted
   decided matches at that size, the rotated assignment and unequal
   ratings, on "cuda" (index_add_'s atomics) against "cpu" (index order)
   within the worst-case rounding bound of the two sums;
9. the kernel path against the plain path: the same 4-world, 16-step env
   rollout on both maps for Zone 6v6 and Zone 3v3, the same 4-world,
   16-step eval rollout, and the trainer's 4-world, 8-step rollout and
   one PPO update, on "cuda" and on "cpu" from one seed, in float32 and
   in bfloat16 (PARITY_BARS); then the PBT population at 8 worlds (Zone
   2v2): one update's actions, train and past actors, eval_elo's best
   actions and ratings (within ELO_BAR, or 32 per match finished after
   the actions part), and store, population and rotation (donors, lr,
   pointer, tables exact);
10. the scripted A* bot: tools/golden.py's 100-step golden rollout (Zone
   2v2, every agent a bot) on the card against the committed golden and
   against the port's CPU rollout (hp and team points exact, pos within
   1e-4 relative, for as long as the CPU rollout holds; each first
   divergence printed); the vs-bot eval (EvalManager(vs_bot=True), team
   1 the bot) at 1024 worlds x 100 steps in chunks of 10 on each map,
   every counter zeroed before and read after, each kernel of the map's
   path held to its count (K1, K2 or K6, K3, K4 culled, K4' and K5, and
   K6's cell order), with agent-steps/s, ms per step, the planner's ms
   per step (CUDA events) and CUDA launches per step with bots and
   without; then 4 worlds x 8 steps with team 1 as bots on "cuda"
   against "cpu" on each map, to the bars of phase 9;
11. every game mode and flag (modes_phase): TDM, ZoneCaptureDefend +
   HardcodedSpawns, Turret, Explore + NavmeshSpawn, Zone + Flank, Zone +
   SubZones, TDM + highlevel_move and Zone + RandomizeHPMagazine at 1024
   worlds of team size 6 on simple_map: K1 at each new shape (the
   turret's and hl_battle's LOS, W x A x ts rays; Flank's LOS refresh,
   W x A x 8 ts) and, on Flank, K2 and K3 on the 48-ray LOS run, each
   bit-equal to its plain version with its time and bound; reset + 20
   steps (the configurations with the same map inputs sharing one loaded
   map) with every counter zeroed before and read after, each kernel
   held to its count (K1 once a step, twice with a turret or a Flank
   refresh, hl_battle's in place of the hitscan; K5 only on the flags
   configuration), env-steps/s and CUDA launches per step; Zone + Flank
   on town_map for 20 steps (K6 on the 48-ray run, held to its plain
   version); each configuration's 4-world, 16-step rollout on "cuda"
   against "cpu" to phase 9's bars; one train-CLI update at 1024 worlds
   x 8 steps of each --game-mode (TDM, ZoneCaptureDefend, Turret,
   Explore): finite losses, parameters that move. SpawnInMiddle is not
   driven: the bundled maps' mid-map spawn boxes overflow the spawn-usage
   tables, and Env refuses it as the JAX package's spawn fails there;
12. the world curriculum, the full-team interface and the spawn
   curriculum (curriculum_phase), 1024 worlds of Zone 6v6:
   SimFlags.EnableCurriculum on simple_map (40-step episodes), reset +
   50 steps held to their counts, the share of LearnShooting worlds,
   then K5's LearnShooting instantiation bit-equal (int32 views) to its
   plain version on the next step's tail (both curricula present),
   timed with its bound and its device time (first in the phase: late
   in a whole run torch.profiler has traced no CUDA event);
   SimFlags.FullTeamPolicy on simple_map (reset + 50 steps) and town_map
   (20), every counter zeroed before and read after, each kernel of the
   6v6 path held to its count and no other launched, the team reward the
   sum of its members', env-steps/s and CUDA launches per step; the
   full-team policy (FullTeamActorCriticNet at full width, seeded
   weights) driving that env for 40 steps on 2048 teams, its forward ms
   per step and one sequence forward + backward over the 40 steps (4
   minibatches of 512 teams), in float32 and bfloat16, by CUDA events,
   gradients finite; the spawn curriculum on each map: the tables'
   build time cold and cached, and each tier's mean team separation at a
   reset of 1024 worlds; each configuration's 4-world, 16-step rollout
   on "cuda" against "cpu" on simple_map (phase 9's bars, the full-team
   observations within 1e-3) and the full-team network's outputs cuda
   against cpu within FT_NET_BAR;
13. record and replay (record_phase), 1024 worlds of Zone 6v6 on each
   map: the logging step (Env(collect_log=True), reset + 20 steps, its
   exports through the record and event-log writers a chunk of 10 steps
   at a time) with every counter zeroed before and read after: K1, K4
   culled and 3 K4' a step, K2 (simple_map) or K6 and its cell order
   (town_map) and K3 once a step and at the reset, K5 never (the step
   log is read inside the unfused tail); env-steps/s, CUDA launches per
   step and the writers' host ms and bytes per step beside the same
   steps without logging; then Env.replay_step over that record: K2 and
   K3 on its first step's launches bit-equal to their plain versions
   (the replay sweeps the whole soup on town_map too, as the JAX
   replay), each once a replayed step, K3 and the reset's fan (K2, or K6
   and its cell order on town_map) at the reset, no other kernel, the
   replayed match-state stream equal to the recorded snapshots'; a 4-world,
   16-step logging rollout and the replay of its cpu record on "cuda"
   against "cpu" (step log, snapshot and events exact but floats, to
   phase 9's bars; an int16 snapshot field one count off only where its
   float sits within the pos bar of a truncation edge, counted); the
   eval CLI's --record and --event-log over 20 steps and --bc-dump-dir
   over 5 (a whole chunk of 10 runs) at 1024 worlds, host ms and bytes
   per step; build_db -> select_windows -> build_curriculum on the
   simple_map event log (host seconds), then Env(curriculum_path,
   trajectory_curriculum_prob 0.5): the share of restored worlds within
   4 sigma of 0.5, reset + 20 steps held to the 6v6 counts (K5 too), and
   the restored reset at 4 worlds bit-equal cuda against cpu. The phase
   logs its own seconds;
14. behaviour cloning end to end and the attention backbone (bc_phase),
   1024 worlds of Zone 6v6 on simple_map: the eval CLI over 20 steps with
   --event-log and --bc-dump-dir in one run (the DB's join needs both),
   every counter zeroed before and read after and held to the logging
   step's counts (K1 20, K2 21, K3 21, K4 culled 20, K4' 60, K5 0), its
   writers' host ms and bytes per step; build_db -> tokenize_steps ->
   ngrams -> select_windows -> build_trajectory_training_dataset (host
   seconds, the BC and KL sets' trajectories and bytes); train/bc.py's
   CLI (1 epoch, minibatch 2048, lr 1e-4) from a TrainingManager
   checkpoint of 2 seeded policies, on the step-block dump and on the
   sequences set, in float32 and --bf16, each with kl_coef 0 and 0.1: ms
   per minibatch update, the losses finite, each policy's loss on the
   epoch's first minibatch lower after the epoch; restore_ckpt of BC's
   output and one PPO update at 1024 worlds x 10 steps, finite losses;
   ActorCriticNet(use_attention=True) beside ActorCriticNet() on the
   dump's observations: a forward step of 12,288 agents and a 40 x 2,048
   sequence forward + backward in float32 and bfloat16 (CUDA events),
   and the attention policy cuda against cpu at 4 worlds x 8 steps within
   FT_NET_BAR. The phase logs its own seconds;
15. data parallelism (parallel_phase), Zone 6v6 on simple_map at 1024
   worlds x 40 steps: (a) the train CLI with --num-devices 1 (a one-rank
   NCCL group) against the plain CLI from the same seed, one update
   bit-equal (int32 views: params, Adam state, normalizer, env state,
   key), every counter zeroed before the --num-devices 1 run and read
   after (K1 40, K2 41, K3 41, K4 culled 40, K4' 120, K5 40); (b) two
   ranks on the one card (gloo over CUDA tensors, each given cuda:0, 512
   worlds each), E = 2 in cross play, a rotation then one update of 20
   steps, against
   the same update in one process: actions equal where the one-process
   Gumbel margin exceeds 1e-4 and match results exact up to the first
   step an action differs, params within 2.5 lr (the share beyond 0.5 lr
   and the sign flips logged), loss terms within 1e-4 and the normalizer
   within 1e-6 where every action agreed, each rank's env state bit-equal
   to the one-process slice in every world whose actions all agreed, the
   replicated state bit-equal across the ranks, and each rank's launches
   of the six main-path kernels (20 each, K4' 60) on their rows
   (``dp_launches``); (c) tools/scaling_bench.py at one device (512
   worlds): env-steps/s and train env-steps/s with the card's name and
   power limit; (d) --num-devices beyond the visible cards raising. The
   phase logs its own seconds;
16. the offline asset tools (asset_tools_phase): (a) make_town_map at its
   defaults, its four .bin files byte-equal to data/town_map's; (b)
   build_ray_tables for simple_map at a cut battery (ASSET_RAY_KW) on
   cuda and on cpu: equal tables and per-round bits; (c)
   build_cell_tables for town_map on cuda at a cut battery
   (ASSET_CELL_KW, k_max 1152), then verify_tables on it: every counter
   zeroed before, K4 dense the build's only launches, K4 dense and K1
   the check's; the bits only in this build and only in the committed
   table and the mismatch counts logged, with each build's seconds, its
   battery chunks and its host share; (d) K4 dense on one chunk of the
   cast battery and K1 on one chunk of the check's rays against their
   plain versions and their predecessors (int32 views), timed in turns,
   rows tagged "town_map tables";
   (e) golden --generate (ASSET_GOLDEN_STEPS steps) into a temporary
   path (the CPU), then --check on the card against it. The phase logs
   its own seconds;
17. the viewing tools and the weight export (viz_phase): (a) the viz
   server (tools/viz_server.py serve) on an ephemeral 127.0.0.1 port
   over a 10-step logging run of its own (4 worlds of Zone 6v6 on
   simple_map: record, event log, build_db): the page's bytes, the map,
   the replay's meta and frames (one past the record 400), each world's
   events, each JSON equal to ViewerData's own; the canned queries and a
   free-form one held to the same SQL on sqlite, a DELETE refused; then
   the live session on cuda (one world, every agent the A* bot) at
   simple_map 6v6, simple_map 3v3 (the CLI's default team size) and
   town_map 6v6, 20 requests of one step each, every counter zeroed
   before and read after: K1, K3, K4 culled and K5 once a step, K4' 3,
   the fan (K2; K7 at 3v3; K6 and its cell order on town) once, no other
   kernel, each row getting the path on its "live" list; every frame
   held to a CPU session of the same seed (step, hp, alive, cur_zone,
   controller and team points exact, pos and yaw within 1e-4 relative),
   /api/live/reset and one request of 3 steps too; wall ms per request,
   a step's ms in process and CUDA launches per step (torch.profiler)
   beside the card's name and limit; (b) tools/convert_weights.py on
   phase 14's seeded checkpoint (2 LSTM-512 policies written on the
   card): each file read back bit-equal to params_to_jax of the
   loaded state_dicts, and params_from_jax(params_to_jax(sd)) bit-equal
   to sd; (c) tools/viewer.py's frame readers on the card's record and
   event log: the record's frames equal to replay_frame's fields, the
   snapshots' frames at every event's step and within the int16
   truncation of the record's positions; nothing rendered (matplotlib is
   not on the card's machine; rendering is tested on the CPU), as the
   phase prints. The phase logs its own seconds;
18. a line of kernel results (JSON, one row per kernel and map, each with
   the path whose launches it counts, and for the rows of the vs-bot
   eval's paths its launches there; K2's and K6's rows with the keys of
   REDESIGN_KEYS; the six main-path rows their launches on each rank of
   phase 15; the live paths' rows their launches there), then the card
   line, then the last line {"ok": true, "device": {...}}.

``python3 chip_smoke.py --tables`` runs tables_phase alone: the culling
table builders at their full defaults (load_map(build_culling=True) on
simple_map, tools/build_culling.py --verify on town_map), minutes.

``python3 chip_smoke.py --cards`` on a machine of several cards runs
cards_phase alone: the scaling bench across the cards, one NCCL rank a
card against one process, and the train CLI's --num-devices over them.

Exits non-zero with no result line when there is no CUDA device or when
the port's package is not beside this script.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
from unittest import mock

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SCENE = os.path.join(REPO, "data", "simple_map")
TOWN = os.path.join(REPO, "data", "town_map")
NUM_WORLDS = 1024
NUM_STEPS = 100
FORCED_STEPS = 10  # the forced-gate paths (K4 dense, K2 on town_map)
TEAM3_STEPS = 50  # the Zone 3v3 paths
TEAM_SIZE = 6

# H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores, HBM3
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
# the data sheet's dense tensor-core rates (flops, a multiply-add is 2)
PEAK_TF32 = 495e12
PEAK_BF16 = 989e12
# f32 instructions per second (an FMA is one): 67 TFLOP/s / 2, i.e. 132
# SMs x 128 lanes x 1.98 GHz; special-function results (MUFU: rcp) at 16
# per SM per clock (CUDA C++ Programming Guide, compute capability 9.0)
PEAK_F32_INSNS = PEAK_F32 / 2
PEAK_SFU = 132 * 16 * 1.98e9

# f32 arithmetic operations (add, sub, mul, div, sqrt, min) per pair as the
# kernels write them (csrc/tri_math.cuh); comparisons and selects not counted
OPS_RAY_TRI = 47  # two crosses (18), four dots (20), divide, 3 scales, u+v, min
OPS_FAN_PAIR = 32  # K2 after hoisting: cross, 2 dots, divide, 3 scales, u+v, min
OPS_FAN_HOIST = 20  # per (fan, group, triangle): tvec, cross, dot
OPS_CAPSULE = 75  # 5 dots, cylinder quadratic (~20), two cap spheres (~30)
# K3 after hoisting (csrc/fan_capsules.cu): per (ray, live capsule) pair two
# dots, three discriminants and two minima; a cylinder root (max, sqrt,
# sub, divide, s_hit) and a cap-sphere root (max, sqrt, sub, divide) only
# where the discriminant lets it hit; per (fan, z-group, capsule) the
# origin and capsule terms (lift, m, ms, mm, c, cc0, m1, cc1); per ray dd,
# ds, a and the sphere divisor
OPS_CAP_PAIR = 24
OPS_CAP_CYL = 6
OPS_CAP_SPHERE = 4
OPS_CAP_HOIST = 33
OPS_CAP_RAY = 14
OPS_SPHERE_TRI = 330  # closest point (~80), face test (~45), 3 capsules
# K8's normal per cast, after recomputing the winner's pair terms: the
# closest point at the hit (~80), the hit centre (6), a norm and three
# divides (~9)
OPS_SC_NORMAL = 95
# K5 per agent (csrc/tail_fused.cu): autoheal 2, zone distance 9,
# membership frame 7, reward terms 19, blend 4, spread 2 per teammate and
# 5 per teammate pair
OPS_TAIL_AGENT = 41
# the redesigned kernels' rows (K1, K2, K6, K7, K4 culled, K4', K3, K5)
# also carry: their predecessor's time in the same call, their device time
# (torch.profiler, null where no window of it holds the kernel's events;
# K1's, K7's, K4's, K3's and K5's predecessors' too), the
# floor at one f32 instruction per operation (--fmad=false: 33.5 T/s),
# ptxas -v's registers and spill bytes, the launches of any helper per
# call, the blocks of a cluster that split the rows (K1, K7), on the
# bench's Zone 3v3 rows K7 and its predecessor with a z offset per ray,
# K3's share of (ray, live capsule) pairs that reach a square root and
# K5's host us per call (with its predecessor's, on the same host path);
# the rows of K4 dense and K8 (redesigned in one kernel, csrc/sphere_cast.cu
# sc_dense_kernel) also their predecessor's registers and spill bytes, the
# share of casts that start overlapping (t = 0) and K8's times without
# normals; P3's rows ptxas -v's registers and spill bytes; the six simple_map main-path rows
# their launches on each rank of phase 15 and that path; the rows of the
# viz server's live paths (phase 17) a "live" list of {"path", "launches"}
REDESIGN_KEYS = ("before_ms", "device_ms", "before_device_ms",
                 "fmad_floor_ms", "registers", "spill_bytes",
                 "helper_launches", "helper_device_ms", "split",
                 "per_ray_ms", "per_ray_before_ms", "per_ray_plain_ms",
                 "per_ray_bound_ms", "root_share",
                 "host_us", "before_host_us", "vs_bot_launches",
                 "vs_bot_path", "ls_share", "dp_launches", "dp_path",
                 "live", "before_registers", "before_spill_bytes",
                 "no_normal_ms", "no_normal_before_ms",
                 "start_overlap_share")
# the predecessors, which no path may launch
PREDECESSORS = ("ray_vs_tris_v1", "ray_fans_vs_tris_flat_v1",
                "ray_fans_culled_v1", "sphere_cast_culled_v1",
                "tail_fused_v1", "fan_capsules_v1", "sphere_cast_v1",
                "sphere_cast_vs_tris_v1")
EVAL_WORLDS = 1024
EVAL_STEPS = 100
EVAL_POLICIES = 2


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps):
    """Mean ms per call over ``reps`` calls after a warm-up, CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed_once(fn):
    """(fn(), ms of that one call by CUDA events): for the plain versions,
    whose ATen kernels need no build and no warm-up."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def max_abs_err(got, want):
    """max |got - want| over the float values finite in both (0 if none,
    or for integer and boolean outputs)."""
    import torch

    if not got.dtype.is_floating_point:
        return 0.0
    both = torch.isfinite(got) & torch.isfinite(want)
    return float((got - want).abs()[both].max()) if bool(both.any()) else 0.0


def check_equal(name, *pairs, bits=True):
    """(kernel, plain) output pairs bit-equal (the kernels repeat their
    plain versions op for op, built with --fmad=false): int32 views of the
    float outputs, so -0 differs from +0; with ``bits=False`` as values
    (torch.equal), for the one row that needs it (K4 culled on town_map,
    k4_launches). Float outputs equal as values but not as
    bits are counted and logged. Returns the max abs error over the
    finite values of the first pair."""
    import torch

    torch.cuda.synchronize()
    err = max_abs_err(*pairs[0])
    for i, (g, w) in enumerate(pairs):
        if g.dtype == torch.float32 and w.dtype == torch.float32:
            n_bits = int(((g == w) & (g.view(torch.int32)
                                      != w.view(torch.int32))).sum())
            if n_bits:
                log(f"[bits] {name}: output {i} equal but bit-different at "
                    f"{n_bits} of {w.numel()}")
            if bits:
                g, w = g.view(torch.int32), w.view(torch.int32)
        if not torch.equal(g, w):
            n = int((g != w).sum())
            raise AssertionError(f"{name}: output {i} differs from its "
                                 f"plain version at {n} of {w.numel()}")
    return err


def bound_ms(nbytes, nops, peak=PEAK_F32, more=()):
    """The least time for ``nbytes`` moved and ``nops`` operations at
    ``peak`` per second, plus (ops, peak) pairs ``more`` on other units
    (which may overlap it): (ms, what bounds it)."""
    b = nbytes / PEAK_BYTES
    o = max([nops / peak] + [n / p for n, p in more])
    return max(b, o) * 1e3, ("bytes" if b >= o else "operations")


def check_t(name, t_k, t_p, rel=1e-4, miss_frac=1e-5):
    """t within rel * max(1, |t|) where both hit; hit/miss disagreements at
    most miss_frac of the rays. Returns the max abs error over common
    hits."""
    import torch

    hk, hp = torch.isfinite(t_k), torch.isfinite(t_p)
    disagree = int((hk != hp).sum())
    n = t_k.numel()
    both = hk & hp
    err = (t_k - t_p).abs()[both]
    tol = rel * torch.clamp(t_p.abs()[both], min=1.0)
    bad = int((err > tol).sum())
    max_err = float(err.max()) if err.numel() else 0.0
    if bad or disagree > miss_frac * n:
        raise AssertionError(
            f"{name}: {bad} t beyond {rel}*max(1,|t|), {disagree}/{n} "
            f"hit/miss disagreements (max err {max_err})"
        )
    return max_err


def check_tail(name, got, want):
    """K5's outputs (state, new_captured) against another run's: every
    leaf of the same dtype and shape, bit-equal (int32 views of the float
    leaves). Returns the max abs float error (0)."""
    (sk, ck), (sp, cp) = got, want
    pairs = []
    for leaf, w in sp.leaves().items():
        g = getattr(sk, leaf)
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"{name} {leaf}: {g.dtype} {tuple(g.shape)}"
                                 f" vs {w.dtype} {tuple(w.shape)}")
        pairs.append((g, w))
    check_equal(name, *pairs, (ck, cp))
    return max(max_abs_err(g, w) for g, w in pairs)


def turns_ms(new, old, reps):
    """(new ms, old ms): CUDA-event means of two functions timed in turns
    (new, old, old, new), each turn ``reps`` calls after a warm-up."""
    t = [cuda_time_ms(f, reps) for f in (new, old, old, new)]
    return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2


def device_ms(fn, kernel, reps=10, digits=4):
    """Device ms per call (rounded to ``digits``) of the CUDA kernels of
    ``fn`` whose name holds ``kernel``, without the host's gaps between
    calls: torch.profiler's times (kernel_bench.device_ms), else those of
    a window that traces the device alone, else None (logged with what
    that window held)."""
    import torch
    from madrona_mp_env_tpu_torch.tools import kernel_bench

    ms, how = kernel_bench.device_ms(fn, kernel, reps)
    if how == "profiler":
        return round_or_none(ms, digits)
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    mine = [e.device_time_total for e in dev
            if kernel in e.name and e.device_time_total > 0]
    names = sorted({e.name[:60] for e in dev})[:4]
    log(f"[profiler] no {kernel} event in 3 windows of host and device; "
        f"a window of the device alone held {len(dev)} CUDA events, "
        f"{len(mine)} of it (names {names})")
    return round_or_none(sum(mine) / 1e3 / len(mine) if mine else None,
                         digits)


def round_or_none(x, digits=4):
    return x if x is None or digits is None else round(x, digits)


def add_or_none(a, b):
    return None if a is None or b is None else a + b


# where the step calls each kernel's entry: (sim module, name)
ENTRY_SITES = (
    ("combat", "ray_vs_tris"), ("observations", "ray_fans_vs_tris"),
    ("observations", "ray_fans_culled"),
    ("observations", "ray_fans_vs_tris_flat"),
    ("observations", "ray_fans_culled_v9"), ("observations", "fan_capsules"),
    ("movement", "sphere_cast"), ("movement", "sphere_cast_culled"),
    ("movement", "sphere_cast_packed"), ("step", "tail_fused"),
)


def _clone(x):
    import torch
    from madrona_mp_env_tpu_torch.sim.types import WorldState

    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, tuple):
        return tuple(_clone(v) for v in x)
    if isinstance(x, WorldState):
        return x.replace(**{k: v.clone() for k, v in x.leaves().items()})
    return x


def capture_step_calls(env, state, actions, expect, step=None):
    """Run one env.step (or ``step``, e.g. env.replay_step with a step
    log for ``actions``) with every kernel entry wrapped where the sim
    calls it; returns {entry name: [args of each call, in order]} (tensors
    cloned), so the kernels can be checked and timed on the main path's
    own launches at its own shapes. ``expect``: the entries this path
    must call (and only those)."""
    import importlib

    calls = {name: [] for _, name in ENTRY_SITES}
    saved = []
    for mod_name, name in ENTRY_SITES:
        mod = importlib.import_module(
            f"madrona_mp_env_tpu_torch.sim.{mod_name}")
        fn = getattr(mod, name)

        def rec(*args, _fn=fn, _name=name):
            calls[_name].append(_clone(args))
            return _fn(*args)

        saved.append((mod, name, fn))
        setattr(mod, name, rec)
    try:
        (step or env.step)(state, actions)
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    called = sorted(n for n, c in calls.items() if c)
    if called != sorted(expect):
        raise AssertionError(f"the step called {called}, expected "
                             f"{sorted(expect)}")
    return calls


def chunks(n, size):
    return [slice(i, min(i + size, n)) for i in range(0, n, size)]


def chunked(fn, n, size):
    """fn(slice) over chunks of the leading axis, outputs concatenated."""
    import torch

    outs = [fn(s) for s in chunks(n, size)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(o) for o in zip(*outs))
    return torch.cat(outs)


def sc_normal_plain(o, d, r, soup):
    """K8's plain version over chunks of the leading axis of o, d [N, ...,
    3], each chunk ~2^23 (cast, triangle) pairs."""
    from madrona_mp_env_tpu_torch.ops import raycast

    per = o[..., 0].numel() // o.shape[0]
    return chunked(lambda s: raycast._sphere_cast_normal_plain(
        o[s], d[s], r, soup), o.shape[0],
        max(1, 2 ** 23 // soup.num_tris // per))


def sc_dense_plain(o, d, r, soup):
    from madrona_mp_env_tpu_torch.ops import raycast

    return chunked(lambda s: raycast._sphere_cast_dense(o[s], d[s], r, soup),
                   o.shape[0], max(64, 2 ** 19 // soup.num_tris))


def sc_dense_usage(normal):
    """ptxas -v's registers and spill bytes of K4 dense's (or, with
    ``normal``, K8's) kernel and of its predecessor."""
    from madrona_mp_env_tpu_torch.ops import cuda_build

    b = "ILb1E" if normal else "ILb0E"
    regs, spill = cuda_build.ptxas_usage("sphere_cast",
                                         f"sc_dense_kernel{b}")
    before = cuda_build.ptxas_usage("sphere_cast",
                                    f"sphere_cast_dense_kernel{b}")
    return dict(registers=regs, spill_bytes=spill,
                before_registers=before[0], before_spill_bytes=before[1])


def sc_dense_extra(kernel, before, nops, normal, T, R, reps):
    """The redesign keys of a K4 dense or K8 row of one launch: device
    times of the kernel and its predecessor, the floor, registers, the
    split."""
    from madrona_mp_env_tpu_torch.ops import raycast

    import torch

    return dict(
        device_ms=device_ms(kernel, "sc_dense_kernel", reps),
        before_device_ms=device_ms(before, "sphere_cast_dense_kernel", reps),
        fmad_floor_ms=round(nops / PEAK_F32_INSNS * 1e3, 4),
        helper_launches=0, **sc_dense_usage(normal),
        split=raycast.sc_split(T, R, raycast._sm_count(
            torch.device("cuda"))))


def kernel_row(scene, name, source, replaces, entry, err, ms, pms, nbytes,
               nops, shapes, peak=PEAK_F32, more=(), **extra):
    """One row of the kernels line, its bound from ``nbytes`` and ``nops``
    (bound_ms), logged; ``scene`` tags it."""
    bms, by = bound_ms(nbytes, nops, peak, more)
    row = dict(name=f"{name} [{scene}]", route="cuda", source=source,
               replaces=replaces, entry=entry, max_abs_err=err, ms=ms,
               plain_ms=pms, bound_ms=bms, bound_by=by, shapes=shapes,
               scene=scene, **extra)
    log(f"[kernel] {row['name']} at {shapes}: max_abs_err {err:.3g} "
        f"kernel {ms:.4f} ms/step plain {pms:.4f} ms/step bound "
        f"{bms:.4f} ms ({by})"
        + "".join(f" {k} {v}" for k, v in extra.items()))
    return row


class KernelPhase:
    """Each kernel against its plain version on the card, on the inputs of
    every launch one real step makes (captured from the main path at 1024
    worlds). ms, plain_ms and bound_ms are per step: the sum over that
    step's launches of the entry. ``scene`` tags every row."""

    def __init__(self, soup, scene):
        self.scene, self.results = scene, []
        self.soup = soup
        self.T_real = int(self.soup.valid.sum())

    def record(self, *args, **kw):
        row = kernel_row(self.scene, *args, **kw)
        self.results.append(row)
        return row

    def k1(self, calls):
        """K1 over the whole soup, bit-equal to its plain version and to
        its earlier kernel (ray_tris_v1, timed with it in turns)."""
        from madrona_mp_env_tpu_torch.ops import cuda_build, raycast

        soup = self.soup
        (o1, d1, _), = calls["ray_vs_tris"]
        R1 = o1[..., 0].numel()

        def kernel():
            return raycast.ray_vs_tris(o1, d1, soup)

        def plain():
            return raycast._ray_vs_tris_dense(o1, d1, soup)

        def before():
            return raycast.ray_vs_tris_v1(o1, d1, soup)

        t = kernel()
        err = check_equal("K1 ray_vs_tris", (t, plain()))
        check_equal("K1 against its predecessor", (t, before()))
        ms, before_ms = turns_ms(kernel, before, 200)
        regs, spill = cuda_build.ptxas_usage(
            "ray_tris", f"ray_tris_rb_kernelILi{raycast.RAY_RAYS}E")
        nops = R1 * self.T_real * OPS_RAY_TRI
        self.record(
            "K1 ray_vs_tris", "madrona_mp_env_tpu_torch/csrc/ray_tris.cu",
            "madrona_mp_env_tpu/ops/raycast_pallas.py:111",
            raycast.ray_vs_tris, err, ms, cuda_time_ms(plain, 20),
            R1 * 28 + self.T_real * 40, nops, [list(o1.shape[:-1])],
            before_ms=round(before_ms, 4),
            device_ms=device_ms(kernel, "ray_tris_rb_kernel"),
            before_device_ms=device_ms(before, "ray_tris_v1_kernel"),
            fmad_floor_ms=round(nops / PEAK_F32_INSNS * 1e3, 4),
            registers=regs, spill_bytes=spill, helper_launches=0,
            split=raycast.ray_split(soup.num_tris, R1,
                                    raycast._sm_count(o1.device)))

    def k2(self, org, zgf, dirf, zgroups):
        """K2 over the whole soup, bit-equal to its plain version and to its
        earlier kernel (P2's exact entry), the two timed in turns; returns
        its t for the PVS comparison."""
        from madrona_mp_env_tpu_torch.ops import cuda_build, raycast
        from madrona_mp_env_tpu_torch.tools import fan_probe

        soup = self.soup
        N, G = zgf.shape
        F = dirf[0].shape[-1]

        def fan_kernel():
            return raycast.ray_fans_vs_tris(org, zgf, dirf, zgroups, soup)

        def fan_plain():
            return chunked(lambda s: raycast._ray_fans_dense(
                org[s], zgf[s], tuple(c[s] for c in dirf), zgroups, soup), N,
                max(16, 2 ** 18 // soup.num_tris))

        def fan_before():
            return fan_probe.ENTRIES["exact"](org, zgf, dirf, zgroups, soup)

        t = fan_kernel()
        err = check_equal("K2 ray_fans_vs_tris", (t, fan_plain()))
        check_equal("K2 against its predecessor", (t, fan_before()))
        reps = 10 if soup.num_tris <= 1024 else 3
        ms, before = turns_ms(fan_kernel, fan_before, reps)
        regs, spill = cuda_build.ptxas_usage("fan_tris",
                                             "fan_tris_rb_kernel")
        nops = (N * F * self.T_real * OPS_FAN_PAIR
                + N * G * self.T_real * OPS_FAN_HOIST)
        self.record(
            "K2 ray_fans_vs_tris", "madrona_mp_env_tpu_torch/csrc/fan_tris.cu",
            "madrona_mp_env_tpu/ops/raycast_pallas.py:383",
            raycast.ray_fans_vs_tris, err, ms, cuda_time_ms(fan_plain, 1),
            N * (12 + 4 * G) + 3 * N * F * 4 + self.T_real * 40 + N * F * 4,
            nops, [[N, F, soup.num_tris]], before_ms=round(before, 4),
            device_ms=device_ms(fan_kernel, "fan_tris_rb_kernel", reps),
            fmad_floor_ms=round(nops / PEAK_F32_INSNS * 1e3, 4),
            registers=regs, spill_bytes=spill,
            helper_launches=0)
        return t

    def k6(self, calls):
        """K6 over each fan's PVS cell, bit-equal to its plain version and
        to its earlier kernel (fan_culled_v1, timed with it in turns); its
        helper, the cell order; then K2 on the same fans (the soup of a
        big map), and how often the two agree."""
        import torch
        from madrona_mp_env_tpu_torch.ops import cuda_build, raycast
        from madrona_mp_env_tpu_torch.tools import kernel_bench

        soup = self.soup
        (org, zgf, dirf, zgroups, cells, tables, _), = calls[
            "ray_fans_culled"]
        N, G = zgf.shape
        F = dirf[0].shape[-1]

        def kernel():
            return raycast.ray_fans_culled(org, zgf, dirf, zgroups, cells,
                                           tables, soup)

        def plain():
            return chunked(lambda s: raycast._ray_fans_culled_plain(
                org[s], zgf[s], tuple(c[s] for c in dirf), zgroups, cells[s],
                tables, soup), N, 256)

        def before():
            return raycast.ray_fans_culled_v1(org, zgf, dirf, zgroups, cells,
                                              tables, soup)

        cl, C = cells.to(torch.int32), tables.cand_idx.shape[0]
        rank = tables.heavy_rank

        def order_kernel():
            return raycast.fan_cell_order(cl, C, rank)

        def order_plain():
            return raycast._fan_cell_order_plain(cl, rank)

        def order_library():
            return torch.sort(rank[cl.long()], stable=True)

        t6 = kernel()
        err = check_equal("K6 ray_fans_culled", (t6, plain()))
        check_equal("K6 against its predecessor", (t6, before()))
        ms, before_ms = turns_ms(kernel, before, 10)
        regs, spill = cuda_build.ptxas_usage("fan_culled",
                                             "fan_culled_rb_kernel")
        reps = 10
        events = kernel_bench.profiled(kernel, reps, "fan_culled_rb_kernel")
        if events is None:
            raise AssertionError("K6: the profiler saw no "
                                 "fan_culled_rb_kernel in 3 windows")
        launches, dev_us = {}, {}
        for e in events:
            launches[e.name] = launches.get(e.name, 0) + 1 / reps
            dev_us[e.name] = dev_us.get(e.name, 0.0) + e.device_time_total
        mine = [k for k in launches if "fan_culled_rb_kernel" in k]
        if len(mine) != 1 or round(launches[mine[0]]) != 1:
            raise AssertionError(f"K6: launches per call {launches}")
        helpers = {k: v for k, v in launches.items() if k not in mine}
        helper_us = sum(v for k, v in dev_us.items() if k not in mine)
        log(f"[kernel] K6 ray_fans_culled [{self.scene}]: CUDA launches per "
            f"call {launches}; the helpers' device time "
            f"{helper_us / 1e3 / reps:.4f} ms")
        n_valid = (tables.cand_idx >= 0).sum(-1)[cells.long()]  # [N]
        pairs = int(n_valid.sum()) * F
        nops = pairs * OPS_FAN_PAIR + int(n_valid.sum()) * G * OPS_FAN_HOIST
        row = self.record(
            "K6 ray_fans_culled",
            "madrona_mp_env_tpu_torch/csrc/fan_culled.cu",
            "madrona_mp_env_tpu/ops/raycast_pallas.py:465",
            raycast.ray_fans_culled, err, ms, cuda_time_ms(plain, 1),
            N * (16 + 4 * G) + 3 * N * F * 4 + tables.cand_idx.numel() * 4
            + self.T_real * 40 + N * F * 4,
            nops, [[N, F, tables.K]],
            mean_valid_candidates=round(float(n_valid.float().mean()), 1),
            before_ms=round(before_ms, 4),
            device_ms=round(dev_us[mine[0]] / 1e3 / reps, 4),
            helper_device_ms=round(helper_us / 1e3 / reps, 4),
            fmad_floor_ms=round(nops / PEAK_F32_INSNS * 1e3, 4),
            registers=regs, spill_bytes=spill,
            helper_launches=round(sum(helpers.values())),
            helpers=sorted(helpers))
        # its helper: the fans grouped by cell, heaviest cell first, in an
        # order free within a cell (a permutation with the stable sort's
        # cells); the library call sorts the gathered keys
        got, want = order_kernel(), order_plain()
        check_equal("K6 cell order", (torch.sort(got).values,
                                      torch.sort(want).values),
                    (cl[got.long()], cl[want.long()]))
        self.record(
            "K6 cell order", "madrona_mp_env_tpu_torch/csrc/fan_culled.cu",
            "madrona_mp_env_tpu/ops/culling.py:1214",
            raycast.fan_cell_order, 0.0, cuda_time_ms(order_kernel, 50),
            cuda_time_ms(order_plain, 50), 2 * N * 4 + C * 4, 2 * N,
            [[N, C]], library_ms=cuda_time_ms(order_library, 50),
            device_ms=device_ms(order_kernel, "fan_cell_order"))
        t2 = self.k2(org, zgf, dirf, zgroups)
        torch.cuda.synchronize()
        same = float(((t6 == t2) | (torch.isinf(t6) & torch.isinf(t2)))
                     .float().mean())
        hitmiss = float((torch.isfinite(t6) == torch.isfinite(t2))
                        .float().mean())
        row["pvs_t_equal"] = same
        row["pvs_hit_agree"] = hitmiss
        log(f"[pvs] {self.scene}: K6 t equals K2's dense t on {same:.6f} of "
            f"{t6.numel()} rays; hit/miss agree on {hitmiss:.6f}")

    def k9(self, calls, t2):
        """K9 over each fan's sensor-ray table cell (a step taken with
        MPENV_FAN_V9=1), bit-equal to its plain version; then how often
        it agrees with K2's whole-soup t (``t2``) on the same rays."""
        import torch
        from madrona_mp_env_tpu_torch.ops import raycast

        soup = self.soup
        (org, zoff, dirf, cells, rt, _), = calls["ray_fans_culled_v9"]
        N, F = zoff.shape

        def kernel():
            return raycast.ray_fans_culled_v9(org, zoff, dirf, cells, rt,
                                              soup)

        def plain():
            return chunked(lambda s: raycast._ray_fans_v9_plain(
                org[s], zoff[s], tuple(c[s] for c in dirf), cells[s], rt,
                soup), N, 1024)

        t9, tp = kernel(), plain()
        torch.cuda.synchronize()
        if not bool(((t9 == tp) | (torch.isinf(t9) & torch.isinf(tp)))
                    .all()):
            raise AssertionError("K9 differs from its plain version")
        err = check_t("K9 ray_fans_culled_v9", t9, tp)
        n_valid = (rt.cand_idx >= 0).sum(-1)[cells.long()]  # [N]
        # z-groups of each fan: runs of equal z offsets (the kernel's own)
        runs = int((zoff[:, 1:] != zoff[:, :-1]).sum()) + N
        nops = (int(n_valid.sum()) * F * OPS_FAN_PAIR
                + int((n_valid * runs / N).sum()) * OPS_FAN_HOIST)
        row = self.record(
            "K9 ray_fans_culled_v9",
            "madrona_mp_env_tpu_torch/csrc/fan_v9.cu",
            "madrona_mp_env_tpu/ops/raycast_pallas.py:743",
            raycast.ray_fans_culled_v9, err, cuda_time_ms(kernel, 50),
            cuda_time_ms(plain, 2),
            N * (12 + 4) + 4 * N * F * 4 + rt.cand_idx.numel() * 4
            + self.T_real * 40 + N * F * 4, nops,
            [[N, F, rt.K]],
            mean_valid_candidates=round(float(n_valid.float().mean()), 1),
            fmad_floor_ms=round(nops / PEAK_F32_INSNS * 1e3, 4))
        same = float(((t9 == t2) | (torch.isinf(t9) & torch.isinf(t2)))
                     .float().mean())
        hitmiss = float((torch.isfinite(t9) == torch.isfinite(t2))
                        .float().mean())
        row["tables_t_equal"] = same
        row["tables_hit_agree"] = hitmiss
        log(f"[ray tables] {self.scene}: K9 t equals K2's whole-soup t on "
            f"{same:.6f} of {t9.numel()} rays; hit/miss agree on "
            f"{hitmiss:.6f}")
        if hitmiss < 0.995:
            raise AssertionError(f"K9 hit/miss agreement {hitmiss} < 0.995")

    def k7(self, org, zoff, dirs, per_ray=False):
        """K7 over the whole soup: stacked directions, per-ray z offsets.
        Bit-equal to its plain version and to its earlier kernel
        (fan_flat_v1, timed with it in turns); returns the row. With
        ``per_ray``, the same fans with a z offset of its own for every
        ray (the per-ray origin fallback) too, into the row's per_ray_*
        keys."""
        import torch
        from madrona_mp_env_tpu_torch.ops import cuda_build, raycast

        soup = self.soup
        N, F = zoff.shape
        reps = 10 if soup.num_tris <= 1024 else 3

        def kernel(z=zoff):
            return raycast.ray_fans_vs_tris_flat(org, z, dirs, soup)

        def plain(z=zoff):
            return chunked(lambda s: raycast._ray_fans_flat_plain(
                org[s], z[s], dirs[s], soup), N,
                max(16, 2 ** 18 // soup.num_tris))

        def before(z=zoff):
            return raycast.ray_fans_vs_tris_flat_v1(org, z, dirs, soup)

        t, (tp, pms) = kernel(), timed_once(plain)
        err = check_equal("K7 ray_fans_vs_tris_flat", (t, tp))
        check_equal("K7 against its predecessor", (t, before()))
        ms, before_ms = turns_ms(kernel, before, reps)
        regs, spill = cuda_build.ptxas_usage(
            "fan_flat", f"fan_flat_rb_kernelILi{raycast.FLAT_RAYS}E")
        runs = int((zoff[:, 1:] != zoff[:, :-1]).sum()) + N
        nops = (N * F * self.T_real * OPS_FAN_PAIR
                + runs * self.T_real * OPS_FAN_HOIST)
        extra = {}
        if per_ray:
            g = torch.Generator(device=zoff.device).manual_seed(7)
            zr = 20.0 + 40.0 * torch.rand(zoff.shape, generator=g,
                                          device=zoff.device)
            tr, (tpr, pms_r) = kernel(zr), timed_once(lambda: plain(zr))
            extra["per_ray_max_abs_err"] = check_equal(
                "K7 with per-ray z offsets", (tr, tpr))
            check_equal("K7 with per-ray z offsets against its predecessor",
                        (tr, before(zr)))
            new, old = turns_ms(lambda: kernel(zr), lambda: before(zr), reps)
            # every ray its own origin: the origin terms per (ray, row)
            extra.update(per_ray_ms=round(new, 4),
                         per_ray_before_ms=round(old, 4),
                         per_ray_plain_ms=round(pms_r, 4),
                         per_ray_bound_ms=round(bound_ms(
                             N * 12 + N * F * 16 + self.T_real * 40
                             + N * F * 4, N * F * self.T_real
                             * (OPS_FAN_PAIR + OPS_FAN_HOIST))[0], 4))
        return self.record(
            "K7 ray_fans_vs_tris_flat",
            "madrona_mp_env_tpu_torch/csrc/fan_flat.cu",
            "madrona_mp_env_tpu/ops/raycast_pallas.py:265",
            raycast.ray_fans_vs_tris_flat, err, ms, pms,
            N * 12 + N * F * 16 + self.T_real * 40 + N * F * 4, nops,
            [[N, F, soup.num_tris]], runs_per_fan=round(runs / N, 3),
            hit_share=round(float(torch.isfinite(t).float().mean()), 4),
            before_ms=round(before_ms, 4),
            device_ms=device_ms(kernel, "fan_flat_rb_kernel", reps),
            before_device_ms=device_ms(before, "fan_flat_v1_kernel", reps),
            fmad_floor_ms=round(nops / PEAK_F32_INSNS * 1e3, 4),
            registers=regs, spill_bytes=spill, helper_launches=0,
            split=raycast.flat_split(soup.num_tris), **extra)

    def k8(self, o, d, r, reps=10, label=""):
        """K8 over the whole soup with the winner's contact normal: t and
        normal bit-equal to the plain version and to its earlier kernel
        (sphere_cast_vs_tris_v1, timed with it in turns); without
        normals, the same t and zero normals. ``label`` names the casts in
        the row's name."""
        import torch
        from madrona_mp_env_tpu_torch.ops import raycast

        soup = self.soup
        R = o[..., 0].numel()

        def kernel(with_normal=True):
            return raycast.sphere_cast_vs_tris(o, d, r, soup,
                                               with_normal=with_normal)

        def before(with_normal=True):
            return raycast.sphere_cast_vs_tris_v1(o, d, r, soup,
                                                  with_normal=with_normal)

        (tk, nk), ((tp, np_), pms) = kernel(), timed_once(
            lambda: sc_normal_plain(o, d, r, soup))
        err = check_equal(f"K8 sphere_cast_vs_tris{label}", (tk, tp),
                          (nk, np_))
        check_equal(f"K8{label} against its predecessor",
                    *zip((tk, nk), before()))
        t0, n0 = kernel(False)
        check_equal(f"K8{label} without normals against its predecessor",
                    *zip((t0, n0), before(False)))
        if not torch.equal(t0, tk) or bool(n0.any()):
            raise AssertionError("K8 without normals: t differs or a "
                                 "normal is not 0")
        ms, before_ms = turns_ms(kernel, before, reps)
        nn_ms, nn_before = turns_ms(lambda: kernel(False),
                                    lambda: before(False), reps)
        nops = (R * self.T_real * OPS_SPHERE_TRI
                + R * (OPS_SPHERE_TRI + OPS_SC_NORMAL))
        self.record(
            f"K8 sphere_cast_vs_tris{label}",
            "madrona_mp_env_tpu_torch/csrc/sphere_cast.cu",
            "madrona_mp_env_tpu/ops/raycast_pallas.py:1364",
            raycast.sphere_cast_vs_tris, err, ms, pms,
            R * 24 + R * 16 + self.T_real * 52, nops, [list(o.shape[:-1])],
            **sc_dense_extra(kernel, before, nops, True, soup.num_tris, R,
                             reps),
            before_ms=round(before_ms, 4),
            no_normal_ms=round(nn_ms, 4),
            no_normal_before_ms=round(nn_before, 4),
            hit_share=round(float(torch.isfinite(tk).float().mean()), 4),
            start_overlap_share=round(float((tk == 0).float().mean()), 4))

    def k4_bench(self, o, d, r, reps=10, label=""):
        """K4 dense on the kernel bench's casts: t and winner row bit-equal
        to the plain version and to its earlier kernel (sphere_cast_v1),
        the two timed in turns."""
        import torch
        from madrona_mp_env_tpu_torch.ops import raycast

        soup = self.soup
        R = o[..., 0].numel()

        def kernel():
            return raycast.sphere_cast(o, d, r, soup)

        def before():
            return raycast.sphere_cast_v1(o, d, r, soup)

        (tk, ik), ((tp, ip), pms) = kernel(), timed_once(
            lambda: sc_dense_plain(o.reshape(R, 3), d.reshape(R, 3), r,
                                   soup))
        name = f"K4 sphere_cast (dense){label}"
        err = check_equal(name, (tk, tp.reshape(tk.shape)),
                          (ik, ip.reshape(ik.shape)))
        check_equal(f"{name} against its predecessor",
                    *zip((tk, ik), before()))
        ms, before_ms = turns_ms(kernel, before, reps)
        nops = R * self.T_real * OPS_SPHERE_TRI
        self.record(
            name, "madrona_mp_env_tpu_torch/csrc/sphere_cast.cu",
            "madrona_mp_env_tpu/ops/raycast_pallas.py:1384",
            raycast.sphere_cast, err, ms, pms, R * 32 + self.T_real * 52,
            nops, [list(o.shape[:-1])],
            **sc_dense_extra(kernel, before, nops, False, soup.num_tris, R,
                             reps),
            before_ms=round(before_ms, 4),
            hit_share=round(float(torch.isfinite(tk).float().mean()), 4),
            start_overlap_share=round(float((tk == 0).float().mean()), 4))

    def k3x(self, o, d, self_idx, pos, alive, reps=50):
        """K3x: explicit origins, a capsule to skip per ray; t and hit
        index bit-equal to the plain version."""
        import torch
        from madrona_mp_env_tpu_torch.ops import raycast_cull

        W, A, F = self_idx.shape

        def kernel():
            return raycast_cull.fan_capsules_explicit(o, d, self_idx, pos,
                                                      alive)

        def plain():
            return chunked(lambda s: raycast_cull._fan_capsules_explicit_plain(
                o[s], d[s], self_idx[s], pos[s], alive[s]), W, 128)

        (tk, ik), ((tp, ip), pms) = kernel(), timed_once(plain)
        err = check_equal("K3x fan_capsules_explicit", (tk, tp), (ik, ip))
        # capsules each ray tests: its world's live ones but the skipped
        al = alive.to(torch.int64)
        skipped_live = torch.gather(al, 1, self_idx.long().reshape(W, A * F))
        tested = int((al.sum(-1, keepdim=True) - skipped_live).sum())
        self.record(
            "K3x fan_capsules_explicit",
            "madrona_mp_env_tpu_torch/csrc/fan_capsules.cu",
            "madrona_mp_env_tpu/ops/raycast_cull.py:120",
            raycast_cull.fan_capsules_explicit, err,
            cuda_time_ms(kernel, reps), pms,
            W * A * F * 28 + W * A * 13 + W * A * F * 8,
            tested * OPS_CAPSULE, [[W, A, F]])
        return tk, ik

    def k3(self, calls):
        """K3 on the step's sensor fans: t and capsule index bit-equal
        (int32 views) to the plain version and to its predecessor
        (fan_capsules_v1, on per-ray offsets and boolean alive made
        beforehand), the two timed in turns with their device times; the
        share of (ray, live capsule) pairs that reach a square root, which
        the bound counts."""
        import torch
        from madrona_mp_env_tpu_torch.ops import cuda_build, raycast_cull

        (pos, zg, dirs, zgroups, alive), = calls["fan_capsules"]
        W, A, G = zg.shape
        F = dirs[0].shape[-1]
        zoff = torch.repeat_interleave(
            zg, torch.tensor(zgroups, device=zg.device), dim=-1)
        alive_b = alive > 0.0

        def kernel():
            return raycast_cull.fan_capsules(pos, zg, dirs, zgroups, alive)

        def plain():
            return chunked(lambda s: raycast_cull._fan_capsules_plain(
                pos[s], zg[s], tuple(c[s] for c in dirs), zgroups, alive[s]),
                W, 128)

        def before():
            return raycast_cull.fan_capsules_v1(pos, zoff, dirs, alive_b)

        (tk, ik), ((tp, ip), pms) = kernel(), timed_once(plain)
        err = check_equal("K3 fan_capsules", (tk, tp), (ik, ip))
        tb, ib = before()
        check_equal("K3 against its predecessor", (tk, tb), (ik, ib))
        ms, before_ms = turns_ms(kernel, before, 50)
        regs, spill = cuda_build.ptxas_usage("fan_capsules",
                                             "fan_capsules_kernel")
        pairs, cyl, sph = (sum(x) for x in zip(*(
            cap_roots(pos[s], zg[s], tuple(c[s] for c in dirs), zgroups,
                      alive[s]) for s in chunks(W, 64))))
        nops = (pairs * OPS_CAP_PAIR + cyl * OPS_CAP_CYL
                + sph * OPS_CAP_SPHERE + W * A * G * A * OPS_CAP_HOIST
                + W * A * F * OPS_CAP_RAY)
        log(f"[kernel] K3 fan_capsules [{self.scene}]: {pairs} (ray, live "
            f"capsule) pairs, {cyl} cylinder and {sph} cap-sphere roots "
            f"({(cyl + sph) / (3 * pairs):.4f} of the predecessor's 3 a "
            f"pair)")
        self.record(
            "K3 fan_capsules", "madrona_mp_env_tpu_torch/csrc/fan_capsules.cu",
            "madrona_mp_env_tpu/ops/raycast_cull.py:120",
            raycast_cull.fan_capsules, err, ms, pms,
            W * A * 16 + W * A * G * 4 + W * A * F * 12 + F * 4
            + W * A * F * 8, nops, [[W, A, F, G]],
            before_ms=round(before_ms, 4),
            device_ms=device_ms(kernel, "fan_capsules_kernel", 20),
            before_device_ms=device_ms(before, "fan_capsules_v1_kernel", 20),
            fmad_floor_ms=round(nops / PEAK_F32_INSNS * 1e3, 4),
            registers=regs, spill_bytes=spill, helper_launches=0,
            root_share=round((cyl + sph) / (3 * pairs), 4))

    def k4_dense(self, calls):
        """The L2 pair, the L3 snap and the fall cast over the whole soup
        (a step with MPENV_SC_PACK=0): t and winner row bit-equal to the
        plain version and to its earlier kernel (sphere_cast_v1), the two
        timed in turns, summed over the three launches."""
        from madrona_mp_env_tpu_torch.ops import raycast

        soup = self.soup
        sc_calls = calls["sphere_cast"]
        if len(sc_calls) != 3:
            raise AssertionError(f"step made {len(sc_calls)} dense casts")
        err = ms = before_ms = pms = 0.0
        dev = dev_before = 0.0
        R4, shapes, splits = 0, [], []
        for i, (o4, d4, r, _) in enumerate(sc_calls):
            def sc_plain(o4=o4, d4=d4, r=r):
                return sc_dense_plain(o4, d4, r, soup)

            def sc_kernel(o4=o4, d4=d4, r=r):
                return raycast.sphere_cast(o4, d4, r, soup)

            def sc_before(o4=o4, d4=d4, r=r):
                return raycast.sphere_cast_v1(o4, d4, r, soup)

            (tk, ik), ((tp, ip), p_ms) = sc_kernel(), timed_once(sc_plain)
            name = f"K4 sphere_cast launch {i} {list(o4.shape[:-1])}"
            err = max(err, check_equal(name, (tk, tp), (ik, ip)))
            check_equal(f"{name} against its predecessor",
                        *zip((tk, ik), sc_before()))
            new, old = turns_ms(sc_kernel, sc_before, 50)
            ms, before_ms, pms = ms + new, before_ms + old, pms + p_ms
            dev = add_or_none(dev, device_ms(sc_kernel, "sc_dense_kernel",
                                             20, None))
            dev_before = add_or_none(dev_before, device_ms(
                sc_before, "sphere_cast_dense_kernel", 20, None))
            R = o4[..., 0].numel()
            R4 += R
            shapes.append(list(o4.shape[:-1]))
            splits.append(raycast.sc_split(soup.num_tris, R,
                                           raycast._sm_count(o4.device)))
        nops = R4 * self.T_real * OPS_SPHERE_TRI
        self.record(
            "K4 sphere_cast (dense)",
            "madrona_mp_env_tpu_torch/csrc/sphere_cast.cu",
            "madrona_mp_env_tpu/ops/raycast_pallas.py:1384",
            raycast.sphere_cast, err, ms, pms,
            R4 * 32 + 3 * self.T_real * 52, nops, shapes,
            **sc_dense_usage(False), split=splits,
            before_ms=round(before_ms, 4), device_ms=round_or_none(dev),
            before_device_ms=round_or_none(dev_before),
            fmad_floor_ms=round(nops / PEAK_F32_INSNS * 1e3, 4),
            helper_launches=0)

    def k4_launches(self, label, entry, calls):
        """K4 culled or K4' on each of the step's launches of ``entry``: t
        and winner row bit-equal to the plain version and to the
        predecessor (sphere_cast_culled_v1), the two timed in turns, their
        device times; -> (the row's arguments summed over the launches,
        the plain (t, row) of each launch)."""
        from madrona_mp_env_tpu_torch.ops import cuda_build, raycast

        soup = self.soup
        err = ms = before_ms = pms = dev = dev_before = 0.0
        nbytes = pairs = 0
        regs, spill = cuda_build.ptxas_usage("sphere_cast",
                                             "sc_culled_kernel")
        shapes, plains = [], []
        for i, (o, d, r, cells, short, _) in enumerate(calls):
            N, CPA = o.shape[:2]

            def kernel(o=o, d=d, r=r, cells=cells, short=short):
                return entry(o, d, r, cells, short, soup)

            def plain(o=o, d=d, r=r, cells=cells, short=short, N=N):
                return chunked(lambda s: raycast._sphere_cast_culled_plain(
                    o[s], d[s], r, cells[s], short, soup), N,
                    max(256, 2 ** 14 // CPA))

            def before(o=o, d=d, r=r, cells=cells, short=short):
                return raycast.sphere_cast_culled_v1(o, d, r, cells, short,
                                                     soup)

            (tk, ik), ((tp, ip), p_ms) = kernel(), timed_once(plain)
            name = f"{label} [{self.scene}] launch {i} {[N, CPA]}"
            # the one row held as values: on town_map K4 culled's t
            # differs from the plain version's in the sign of 0 on some
            # directionless casts, whose t the step never reads: the plain
            # version's torch.minimum and the kernel's min2 may keep
            # different zeros of a tie
            by_bits = not (label == "K4 sphere_cast_culled"
                           and self.scene == "town_map")
            err = max(err, check_equal(name, (tk, tp), (ik, ip),
                                       bits=by_bits))
            tb, ib = before()
            check_equal(f"{name} against its predecessor", (tk, tb), (ik, ib))
            new, old = turns_ms(kernel, before, 50)
            ms, before_ms, pms = ms + new, before_ms + old, pms + p_ms
            dev = add_or_none(dev, device_ms(kernel, "sc_culled_kernel",
                                             20, None))
            dev_before = add_or_none(dev_before, device_ms(
                before, "sphere_cast_culled_v1_kernel", 20, None))
            # casts in (24 B) and out (8 B), cells, the table and its
            # span, the rows
            nbytes += (N * CPA * 32 + N * 4 + short.cand.numel() * 4
                       + short.valid_span.numel() * 4 + self.T_real * 52)
            cand = short.cand.reshape(-1, short.K)[cells.long()]
            pairs += int((cand >= 0).sum()) * CPA
            shapes.append([N, CPA])
            plains.append((tp, ip))
        nops = pairs * OPS_SPHERE_TRI
        return dict(err=err, ms=ms, pms=pms, nbytes=nbytes, nops=nops,
                    shapes=shapes, before_ms=round(before_ms, 4),
                    device_ms=round_or_none(dev),
                    before_device_ms=round_or_none(dev_before),
                    fmad_floor_ms=round(nops / PEAK_F32_INSNS * 1e3, 4),
                    registers=regs, spill_bytes=spill,
                    helper_launches=0), plains

    def k4_culled(self, calls):
        """The L1 batch of 7 casts per agent against the short tables."""
        import torch
        from madrona_mp_env_tpu_torch.ops import raycast
        from madrona_mp_env_tpu_torch.sim import movement

        soup = self.soup
        (o7, d7, r, *_), = calls["sphere_cast_culled"]
        a, ((tp, ip),) = self.k4_launches(
            "K4 sphere_cast_culled", raycast.sphere_cast_culled,
            calls["sphere_cast_culled"])
        # the short tables are exact for the range the step consumes
        # (movement.UNSTICK_RANGE): equal t and row there, beyond it both
        # far. A standing agent's casts have no direction: they touch every
        # triangle at t = 0, each entry reports its lowest row, and the step
        # does not read them (no_move), so they are left out here.
        td, idd = sc_dense_plain(o7, d7, r, soup)
        swept = (d7 != 0.0).any(dim=-1)
        near = (td <= movement.UNSTICK_RANGE) & swept
        far = ~near & swept
        if not (torch.equal(td[near], tp[near])
                and torch.equal(idd[near], ip[near])
                and bool((tp[far] > movement.UNSTICK_RANGE).all())):
            raise AssertionError("culled plain cast differs from the dense")
        self.record(
            "K4 sphere_cast_culled",
            "madrona_mp_env_tpu_torch/csrc/sphere_cast.cu",
            "madrona_mp_env_tpu/ops/raycast_pallas.py:1549",
            raycast.sphere_cast_culled, a.pop("err"), a.pop("ms"),
            a.pop("pms"), a.pop("nbytes"), a.pop("nops"), a.pop("shapes"),
            **a)

    def k4_packed(self, calls):
        """K4': the L2 pair, the L3 snap and the fall cast against the
        MOVE_MARGIN short tables. Against the dense sweep: every down cast
        equal at any depth; no cast nearer than the dense one (a subset's
        minimum)."""
        import torch
        from madrona_mp_env_tpu_torch.ops import raycast

        soup = self.soup
        pk_calls = calls["sphere_cast_packed"]
        if len(pk_calls) != 3:
            raise AssertionError(f"step made {len(pk_calls)} packed casts")
        a, plains = self.k4_launches("K4' sphere_cast_packed",
                                     raycast.sphere_cast_packed, pk_calls)
        for i, ((o, d, r, *_), (tp, _)) in enumerate(zip(pk_calls, plains)):
            td, _ = sc_dense_plain(o, d, r, soup)
            down = (d[..., 0] == 0.0) & (d[..., 1] == 0.0) & (d[..., 2] < 0.0)
            if not (torch.equal(td[down], tp[down])
                    and bool((td <= tp).all())):
                raise AssertionError(f"K4' launch {i}: packed cast differs "
                                     "from the dense cast")
        self.record(
            "K4' sphere_cast_packed",
            "madrona_mp_env_tpu_torch/csrc/sphere_cast.cu",
            "madrona_mp_env_tpu/ops/raycast_pallas.py:2028",
            raycast.sphere_cast_packed, a.pop("err"), a.pop("ms"),
            a.pop("pms"), a.pop("nbytes"), a.pop("nops"), a.pop("shapes"),
            **a)

    def k5(self, calls):
        """K5 on the step's tail: every output bit-equal (int32 views) to
        the plain version and to its predecessor (tail_fused_v1, on the
        same host path), the two timed in turns with their device times
        and host us per call."""
        from madrona_mp_env_tpu_torch.ops import cuda_build, tail_fused
        from madrona_mp_env_tpu_torch.tools.tail_host_time import host_us

        (cfg5, m5, st5, fr5), = calls["tail_fused"]

        def kernel():
            return tail_fused.tail_fused(cfg5, m5, st5, fr5)

        def plain():
            return tail_fused.tail_fused_plain(cfg5, m5, st5, fr5)

        def before():
            return tail_fused.tail_fused_v1(cfg5, m5, st5, fr5)

        out, (want, pms) = kernel(), timed_once(plain)
        err = check_tail("K5 tail_fused", out, want)
        check_tail("K5 against its predecessor", out, before())
        ms, before_ms = turns_ms(kernel, before, 200)
        ins, outs = tail_fused.kernel_operands(cfg5, m5, st5, fr5)
        W5, A5 = st5.hp.shape
        ts5 = cfg5.team_size
        lanes = 16 if A5 <= 16 else 32
        regs, spill = cuda_build.ptxas_usage(
            "tail_fused", f"tail_fused_kernelILi{lanes}ELb0E")
        host, before_host = (host_us(f, 200) for f in (kernel, before))
        log(f"[kernel] K5 tail_fused [{self.scene}]: host {host:.1f} us "
            f"per call (predecessor on the same host path "
            f"{before_host:.1f}), device idle before each call")
        nops = W5 * A5 * (OPS_TAIL_AGENT + 2 * (ts5 - 1) + 5 * (ts5 - 2))
        self.record(
            "K5 tail_fused", "madrona_mp_env_tpu_torch/csrc/tail_fused.cu",
            "madrona_mp_env_tpu/ops/tail_pallas.py:143", tail_fused.tail_fused,
            err, ms, pms,
            k5_bytes(cfg5, ins, outs), nops,
            [[W5, A5]], before_ms=round(before_ms, 4),
            device_ms=device_ms(kernel, "tail_fused_kernel", 20),
            before_device_ms=device_ms(before, "tail_fused_v1_kernel", 20),
            fmad_floor_ms=round(nops / PEAK_F32_INSNS * 1e3, 4),
            registers=regs, spill_bytes=spill, helper_launches=0,
            host_us=round(host, 1), before_host_us=round(before_host, 1))


def k5_bytes(cfg, ins, outs):
    """The bytes K5 must move: each operand once, world_curriculum only
    where the kernel reads it (EnableCurriculum)."""
    from madrona_mp_env_tpu_torch.config import SimFlags

    skip = (() if cfg.has_flag(SimFlags.EnableCurriculum)
            else ("in_world_curriculum",))
    return sum(x.nbytes for k, x in (*ins.items(), *outs.items())
               if k not in skip)


def cap_roots(pos, zg, dirs, zgroups, alive):
    """(pairs, cylinder roots, cap-sphere roots) of K3's sweep: the (ray,
    capsule) pairs of each ray with its world's live capsules but its
    caster's, and how many of their cylinders (a != 0, disc >= 0) and cap
    spheres (dsc >= 0) reach a square root, in the plain version's
    arithmetic."""
    import torch
    from madrona_mp_env_tpu_torch import consts
    from madrona_mp_env_tpu_torch.ops import raycast, raycast_cull
    from madrona_mp_env_tpu_torch.ops.geom import dot

    W, A, _ = zg.shape
    r, sh = consts.agent_radius, raycast_cull.CAPSULE_SEG_H
    dev = zg.device
    up = torch.tensor([0.0, 0.0, 1.0], device=dev)
    zoff = zg[..., raycast._group_of_ray(tuple(zgroups), dev).long()]
    o = (pos[:, :, None, :] + zoff[..., None] * up)[:, :, :, None, :]
    d = torch.stack(dirs, -1)[:, :, :, None, :]
    m = o - (pos + up * r)[:, None, None]  # [W, A, F, A, 3]
    seg = up * sh
    inv_l2 = 1.0 / torch.tensor(sh * sh, device=dev)
    dd, ds, md, ms, mm = (dot(d, d), dot(d, seg), dot(m, d), dot(m, seg),
                          dot(m, m))
    a = dd - ds * ds * inv_l2
    b = md - ms * ds * inv_l2
    c = mm - ms * ms * inv_l2 - r * r
    cyl = (torch.abs(a) > 1e-12) & (b * b - a * c >= 0.0)
    s0 = md * md - dd * (mm - r * r) >= 0.0
    m1 = m - seg
    b1 = dot(m1, d)
    s1 = b1 * b1 - dd * (dot(m1, m1) - r * r) >= 0.0
    me = torch.arange(A, device=dev)
    live = ((alive > 0.0)[:, None, :] & (me[:, None] != me[None, :])
            )[:, :, None, :].expand(cyl.shape)
    return (int(live.sum()), int((cyl & live).sum()),
            int((s0 & live).sum() + (s1 & live).sum()))


SIMPLE_ENTRIES = ("ray_vs_tris", "ray_fans_vs_tris", "fan_capsules",
                  "sphere_cast_culled", "sphere_cast_packed", "tail_fused")
TOWN_ENTRIES = ("ray_vs_tris", "ray_fans_culled", "fan_capsules",
                "sphere_cast_culled", "sphere_cast_packed", "tail_fused")
V9_ENTRIES = ("ray_vs_tris", "ray_fans_culled_v9", "fan_capsules",
              "sphere_cast_culled", "sphere_cast_packed", "tail_fused")


def tail_chain_check(env, state, actions):
    """The unfused system chain (the reference's order) on the card
    equals the fused order through tail_fused_plain bit for bit, from the
    tail's inputs of one real step (captured where the step calls
    fused_tail)."""
    import torch
    from madrona_mp_env_tpu_torch.ops import tail_fused
    from madrona_mp_env_tpu_torch.sim import step as step_mod

    seen = []
    fused = step_mod.fused_tail

    def rec(*args, **kw):
        seen.append(_clone(args))
        return fused(*args, **kw)

    step_mod.fused_tail = rec
    try:
        env.step(state, actions)
    finally:
        step_mod.fused_tail = fused
    (cfg, m, st, victims, fr), = seen
    sf, cf = fused(cfg, m, _clone(st), victims, fr,
                   tail=tail_fused.tail_fused_plain)
    su, cu = step_mod.unfused_tail(cfg, m, _clone(st), victims, fr)
    torch.cuda.synchronize()
    bad = [k for k, v in su.leaves().items()
           if not bool(((v == getattr(sf, k)) | (
               v.isnan() & getattr(sf, k).isnan()
               if v.dtype.is_floating_point else False)).all())]
    if bad or not torch.equal(cf, cu):
        raise AssertionError(f"unfused chain differs from tail_fused_plain "
                             f"on the card: {bad}")
    log(f"[tail chain] {st.hp.shape[0]} worlds: the unfused chain equals "
        f"tail_fused_plain bit for bit on the card "
        f"({len(su.leaves())} leaves)")


def sensor_syncs(env, state, label):
    """observations.build_sensor_rays on ``env``'s default fan route, once
    to warm up and once under torch.cuda.set_sync_debug_mode("warn"):
    every host sync it makes, logged with the line that made it. A sync
    from repeat_interleave (the per-ray z offsets the default routes no
    longer build) fails the run."""
    import linecache
    import warnings

    import torch
    from madrona_mp_env_tpu_torch.sim import observations

    cfg, m = env.cfg, env.map_data
    observations.build_sensor_rays(cfg, m, state)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            observations.build_sensor_rays(cfg, m, state)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [(f"{os.path.relpath(w.filename, REPO)}:{w.lineno}",
              linecache.getline(w.filename, w.lineno).strip())
             for w in seen if "synchroniz" in str(w.message)]
    log(f"[syncs] build_sensor_rays on {label}: {len(syncs)} host syncs"
        + "".join(f"; {where} `{line}`" for where, line in syncs))
    if any("repeat_interleave" in line for _, line in syncs):
        raise AssertionError(f"{label}: repeat_interleave syncs the host")


def simple_kernels(env, state, actions):
    """simple_map: K1, K2, K3, K4 culled, K4' and K5 on one default step;
    K4 dense on the same step with MPENV_SC_PACK=0."""
    ph = KernelPhase(env.map_data.tris, "simple_map")
    calls = capture_step_calls(env, state, actions, SIMPLE_ENTRIES)
    ph.k1(calls)
    (org, zgf, dirf, zgroups, _), = calls["ray_fans_vs_tris"]
    t2 = ph.k2(org, zgf, dirf, zgroups)
    ph.k3(calls)
    ph.k4_culled(calls)
    ph.k4_packed(calls)
    ph.k5(calls)
    with mock.patch.dict(os.environ, MPENV_SC_PACK="0"):
        dense = capture_step_calls(
            env, state, actions,
            tuple(e for e in SIMPLE_ENTRIES if e != "sphere_cast_packed")
            + ("sphere_cast",))
    ph.k4_dense(dense)
    # the same step on the sensor-ray tables: the same fans, K9 for K2
    with mock.patch.dict(os.environ, MPENV_FAN_V9="1"):
        v9 = capture_step_calls(env, state, actions, V9_ENTRIES)
    ph.k9(v9, t2)
    tail_chain_check(env, state, actions)
    return ph.results


def town_kernels(env, state, actions):
    """town_map: K1, K3, K4 culled, K4', K5 and K6 on one default step, and
    K2 over the 6,144-triangle soup on K6's fans (the forced-dense
    route's launch)."""
    ph = KernelPhase(env.map_data.tris, "town_map")
    calls = capture_step_calls(env, state, actions, TOWN_ENTRIES)
    ph.k1(calls)
    ph.k6(calls)
    ph.k3(calls)
    ph.k4_culled(calls)
    ph.k4_packed(calls)
    ph.k5(calls)
    return ph.results


TEAM3_ENTRIES = ("ray_vs_tris", "ray_fans_vs_tris_flat", "fan_capsules",
                 "sphere_cast_culled", "sphere_cast_packed", "tail_fused")


def team3_kernels(env, state, actions, scene):
    """Zone 3v3 (a LOS run of 12 rays, not a multiple of 8): K1, K7 and K5
    on one step's launches; K8 on the step's L1 casts over the whole soup
    and K3x on its sensor rays with the origins made explicit (K3x's t and
    hit indices must equal K3's on the same rays); the unfused tail chain
    at team size 3."""
    import torch
    from madrona_mp_env_tpu_torch.ops import raycast, raycast_cull

    ph = KernelPhase(env.map_data.tris, f"{scene} Zone 3v3")
    calls = capture_step_calls(env, state, actions, TEAM3_ENTRIES)
    ph.k1(calls)
    (org, zoff, dirs, _), = calls["ray_fans_vs_tris_flat"]
    ph.k7(org, zoff, dirs)
    ph.k5(calls)
    soup = ph.soup
    (o7, d7, r, *_), = calls["sphere_cast_culled"]

    def k8():
        return raycast.sphere_cast_vs_tris(o7, d7, r, soup)

    def k8_before():
        return raycast.sphere_cast_vs_tris_v1(o7, d7, r, soup)

    (tk, nk), ((tp, np_), pms) = k8(), timed_once(
        lambda: sc_normal_plain(o7, d7, r, soup))
    check_equal("K8 on the step's L1 casts", (tk, tp), (nk, np_))
    check_equal("K8 on the step's L1 casts against its predecessor",
                *zip((tk, nk), k8_before()))
    ms, before_ms = turns_ms(k8, k8_before, 20)
    log(f"[kernel] K8 sphere_cast_vs_tris [{ph.scene}] on the step's L1 "
        f"casts {list(o7.shape[:-1])}: bit-equal to its plain version and "
        f"its predecessor, kernel {ms:.4f} ms (split "
        f"{raycast.sc_split(soup.num_tris, o7[..., 0].numel(), raycast._sm_count(o7.device))}) "
        f"predecessor {before_ms:.4f} ms plain {pms:.4f} ms")
    (pos, zg, df, zgroups, alive_f), = calls["fan_capsules"]
    zf = torch.repeat_interleave(
        zg, torch.tensor(zgroups, device=zg.device), dim=-1)
    alive = alive_f > 0.0
    W, A, F = zf.shape
    zero = torch.zeros_like(zf)
    o = pos[:, :, None, :] + torch.stack([zero, zero, zf], dim=-1)
    d = torch.stack(df, dim=-1)
    own = torch.arange(A, dtype=torch.int32, device=pos.device)
    self_idx = own[None, :, None].expand(W, A, F).contiguous()

    def k3x():
        return raycast_cull.fan_capsules_explicit(o, d, self_idx, pos, alive)

    (tx, ix), ((tp, ip), pms) = k3x(), timed_once(
        lambda: raycast_cull._fan_capsules_explicit_plain(o, d, self_idx,
                                                          pos, alive))
    check_equal("K3x on the step's sensor rays", (tx, tp), (ix, ip))
    t3, i3 = raycast_cull.fan_capsules(pos, zg, df, zgroups, alive_f)
    check_equal("K3x against K3 on the step's sensor rays", (tx, t3),
                (ix, i3))
    log(f"[kernel] K3x fan_capsules_explicit [{ph.scene}] on the step's "
        f"sensor rays {[W, A, F]}: bit-equal to its plain version and to "
        f"K3, kernel {cuda_time_ms(k3x, 50):.4f} ms plain {pms:.4f} ms")
    tail_chain_check(env, state, actions)
    return ph.results


BENCH_ITERS = 5


def bench_kernels(mt, scene, team_size, card):
    """K7, K8, K4 dense and K3x at the kernel bench's own shapes and inputs
    (tools/kernel_bench.py make_inputs) at NUM_WORLDS worlds, each
    bit-equal to its plain version and timed (K7 also with a z offset per
    ray at team size 3; K8 and K4 dense on the JAX bench's casts, which
    all start overlapping, and on the moving casts, beside their
    predecessors in turns); then the kernel bench
    itself (its main, as the command line runs it) with every launch
    counter zeroed just before and read just after: its launches are
    these rows'."""
    import torch
    from madrona_mp_env_tpu_torch import consts
    from madrona_mp_env_tpu_torch.assets.map_data import load_map
    from madrona_mp_env_tpu_torch.tools import kernel_bench

    name = os.path.basename(scene)
    m = load_map(scene, mt.EnvConfig(team_size=team_size), device="cuda")
    x = kernel_bench.make_inputs(NUM_WORLDS, team_size, "cuda", soup=m.tris)
    ph = KernelPhase(m.tris, f"{name} bench ts{team_size}")
    ph.k7(x["origins"], x["zoff"], x["dirs"], per_ray=team_size == 3)
    reps = 10 if m.tris.num_tris <= 1024 else 3
    for o_key, label in (("o_sc", ""), ("o_mv", ", moving casts")):
        ph.k8(x[o_key], x["d_sc"], consts.agent_radius, reps, label)
        ph.k4_bench(x[o_key], x["d_sc"], consts.agent_radius, reps, label)
    ph.k3x(x["o_caps"], x["d_caps"], x["self_idx"], x["cap_pos"],
           x["alive"])
    del x, m
    entries = all_entries()
    for f in entries.values():
        f.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = kernel_bench.main(["--worlds", str(NUM_WORLDS), "--team-size",
                             str(team_size), "--scene", scene, "--iters",
                             str(BENCH_ITERS)])
    torch.cuda.synchronize()
    label = f"kernel bench {name} ts {team_size}"
    for row in ph.results:
        row["launches"] = row["entry"].launches
        row["path"] = label
    missing = [r["name"] for r in ph.results if r["launches"] == 0]
    if missing or not all(np.isfinite(v) and v > 0 for v in res.values()):
        raise AssertionError(f"{label}: kernels not launched {missing} or "
                             f"a bad time {res}")
    log(f"[{label}] {time.perf_counter() - t0:.1f} s on {card}; launches "
        + ", ".join(f"{n}={f.launches}" for n, f in entries.items()))
    return ph.results


P3_STEPS = 5  # the fused movement's state: Env.reset + 5 steps
P3_SOURCE = "madrona_mp_env_tpu_torch/csrc/move_fused.cu"
P3_TPU = "tools/probes/movement_fused_probe.py:54"
FAN_PROBE_CHAIN = 50  # the TPU probe's scan length
# f32 operations per (ray, row) pair of P2's part variants (as the kernel
# writes them): the direction dots, two crosses' worth of products and
# sums and two minima; the epilogue's divide, three scales, u + v, min
OPS_FAN_DOTS = 26
OPS_FAN_EPILOGUE = 6
P2_TPU = {"exact": "madrona_mp_env_tpu/tools/fan_probe.py:129",
          "rcp_ieee": "madrona_mp_env_tpu/tools/fan_probe.py:129",
          "rcp_approx": "madrona_mp_env_tpu/tools/fan_probe.py:129",
          "dots_only": "madrona_mp_env_tpu/tools/fan_probe.py:129",
          "epilogue": "madrona_mp_env_tpu/tools/fan_probe.py:129",
          "chunked": "madrona_mp_env_tpu/tools/fan_probe.py:183"}


def p3_rows(cfg, scene):
    """P3, the fused movement, under both routes on the state a step
    hands the movement pair (Env.reset + P3_STEPS steps of bench.py's
    actions at NUM_WORLDS worlds, then the movement and aim systems):
    kernel against its plain version and, bit for bit, against the split
    pair on the step's own kernels; the fused launch's time, the split
    pair's and the plain version's; the CUDA launches of one split pair
    and of one fused call (torch.profiler); the bound over the (cast,
    valid triangle) pairs and normals the kernel took (its work
    counter)."""
    import torch
    from madrona_mp_env_tpu_torch.tools.probes import (
        movement_fused_probe as mf,
    )

    from madrona_mp_env_tpu_torch.ops import cuda_build

    regs, spill = cuda_build.ptxas_usage("move_fused", "move_fused_kernel")
    env, st = mf.bench_state(cfg, scene, NUM_WORLDS, P3_STEPS, "cuda")
    m = env.map_data
    ph = KernelPhase(m.tris, os.path.basename(scene))
    N = st.pos.shape[0] * st.pos.shape[1]
    for route in ("culled", "dense"):
        rt = dict(culled="L1 short tables, L2/L3/fall MOVE_MARGIN tables",
                  dense="every cast over the whole soup")[route]

        def fused(route=route):
            return mf.apply_velocity_fall_fused(cfg, m, st, route)

        def split(route=route):
            return mf.split_pair(cfg, m, st, route)

        got = fused()
        want, pms = timed_once(
            lambda: mf._apply_velocity_fall_fused_plain(cfg, m, st, route))
        name = f"P3 move_fused ({route})"
        err = check_equal(name, (got.pos, want.pos), (got.vel, want.vel))
        sp = split()
        check_equal(f"{name} against the split pair", (got.pos, sp.pos),
                    (got.vel, sp.vel))
        moved = float((got.pos != st.pos).any(-1).float().mean())
        work = torch.zeros(2, dtype=torch.int64, device="cuda")
        mf.apply_velocity_fall_fused(cfg, m, st, route, work=work)
        pairs, normals = (int(v) for v in work.tolist())
        tables = (m.short.cand.numel() + m.short_mv.cand.numel()) * 4 \
            if route == "culled" else 0
        ph.record(
            name, P3_SOURCE, P3_TPU, mf.apply_velocity_fall_fused, err,
            cuda_time_ms(fused, 20), pms,
            N * (32 + 24) + tables + ph.T_real * 52,
            pairs * OPS_SPHERE_TRI + normals * (OPS_SPHERE_TRI
                                                + OPS_SC_NORMAL),
            [list(st.pos.shape[:2])], route_casts=rt,
            split_ms=round(cuda_time_ms(split, 5), 4),
            split_launches=mf.cuda_launches(split),
            fused_launches=mf.cuda_launches(fused), pairs=pairs,
            normals=normals, moved_share=round(moved, 4),
            registers=regs, spill_bytes=spill)
    return ph.results


def fan_probe_rows():
    """P5, P6 and P2 at 12,288 fans x 104 rays on simple_map (the probes'
    make_fans): each kernel against its plain version (bit-equal; P2's
    rcp.approx: its largest error and share of rays beyond 1e-4 relative
    against the exact plain version), its time, the plain version's and
    the bound over the valid (ray, row) pairs."""
    import torch
    from madrona_mp_env_tpu_torch.ops import raycast
    from madrona_mp_env_tpu_torch.tools import fan_probe as p2
    from madrona_mp_env_tpu_torch.tools.probes import (
        v9_kernel_probe as p5, v9_scan_timing as p6,
    )
    from madrona_mp_env_tpu_torch.ops.culling import ray_cell_index

    m = p5.probe_map("cuda")
    x = p5.make_fans(m, p5.FANS, 0, "cuda")
    ph = KernelPhase(m.tris, "simple_map probes")
    rt, soup = m.ray_cells, m.tris
    N, F = x["zoff"].shape
    G = len(x["zgroups"])
    v9_args = (x["origins"], x["zoff"], x["dirs"], x["cells"])
    want, pms = timed_once(lambda: p5.by_fans(
        lambda f: raycast._ray_fans_v9_plain(
            f["origins"], f["zoff"], f["dirs"], f["cells"], rt, soup), x))
    n_valid = int((rt.cand_idx >= 0).sum(-1)[x["cells"].long()].sum())
    v9_bytes = (N * 16 + 4 * N * F * 4 + rt.cand_idx.numel() * 4
                + ph.T_real * 40 + N * F * 4)
    v9_ops = n_valid * F * OPS_FAN_PAIR + n_valid * G * OPS_FAN_HOIST
    table = p5.gather_tables(rt, soup)
    dense_ms = cuda_time_ms(lambda: raycast.ray_fans_vs_tris(
        x["origins"], x["zg"], x["dirs"], x["zgroups"], soup),
        FAN_PROBE_CHAIN)
    e2e_ms = cuda_time_ms(lambda: raycast.ray_fans_culled_v9(
        x["origins"], x["zoff"], x["dirs"], ray_cell_index(rt, x["origins"]),
        rt, soup), FAN_PROBE_CHAIN)
    v9_rows = (
        ("P5 fan_v9 indirect (as shipped)", "v9_kernel_probe.py:31",
         raycast.ray_fans_culled_v9,
         lambda: raycast.ray_fans_culled_v9(*v9_args, rt, soup), {}),
        ("P5 fan_v9_gathered + gather", "v9_kernel_probe.py:31",
         p5.ray_fans_v9_gathered,
         lambda: p5.ray_fans_v9_gathered(*v9_args,
                                         p5.gather_tables(rt, soup)), {}),
        ("P5 fan_v9_gathered", "v9_kernel_probe.py:48",
         p5.ray_fans_v9_gathered,
         lambda: p5.ray_fans_v9_gathered(*v9_args, table), {}),
        ("P6 fan_v9 full", "v9_scan_timing.py:38",
         raycast.ray_fans_culled_v9,
         lambda: raycast.ray_fans_culled_v9(*v9_args, rt, soup),
         dict(dense_fan_ms=round(dense_ms, 4),
              v9_end_to_end_ms=round(e2e_ms, 4))),
        ("P6 fan_v9_chunked", "v9_scan_timing.py:38",
         p6.ray_fans_v9_chunked,
         lambda: p6.ray_fans_v9_chunked(*v9_args, rt, soup),
         dict(dense_fan_ms=round(dense_ms, 4))),
    )
    for name, tpu, entry, fn, extra in v9_rows:
        err = check_equal(name, (fn(), want))
        ph.record(name, "madrona_mp_env_tpu_torch/csrc/fan_v9.cu",
                  f"tools/probes/{tpu}", entry, err,
                  cuda_time_ms(fn, FAN_PROBE_CHAIN), pms, v9_bytes, v9_ops,
                  [[N, F, rt.K]], **extra)

    aux = p2.make_aux(soup.num_tris, 0, "cuda")
    args = (x["origins"], x["zg"], x["dirs"], x["zgroups"], soup)
    k2_bytes = (N * (12 + 4 * G) + 3 * N * F * 4 + ph.T_real * 40
                + N * F * 4)
    pairs = N * F * ph.T_real
    hoist = N * G * ph.T_real * OPS_FAN_HOIST
    exact, exact_ms = timed_once(lambda: p5.by_fans(
        lambda f: p2._fan_probe_plain("exact", f["origins"], f["zg"],
                                      f["dirs"], f["zgroups"], soup), x))
    for v in p2.VARIANTS:
        fn = p2.ENTRIES[v]

        def kernel(fn=fn):
            return fn(*args, aux=aux)

        extra, ops = {}, pairs * OPS_FAN_PAIR + hoist
        if v in ("exact", "chunked", "rcp_approx"):
            want, vms = exact, exact_ms
        else:
            want, vms = timed_once(lambda v=v: p5.by_fans(
                lambda f: p2._fan_probe_plain(v, f["origins"], f["zg"],
                                              f["dirs"], f["zgroups"], soup,
                                              aux), x))
        name = f"P2 fan_probe {v}"
        got = kernel()
        if v == "rcp_approx":
            err, share = p2.approx_error(got, want)
            extra["share_beyond_1e-4"] = share
            log(f"[kernel] {name}: rcp.approx against the exact plain "
                f"version: max abs err {err:.6g}, {share:.6g} of "
                f"{got.numel()} rays beyond 1e-4 relative or with another "
                "hit/miss")
        else:
            err = check_equal(name, (got, want))
        if v == "dots_only":
            ops = pairs * OPS_FAN_DOTS + hoist
            extra["library_ms"] = cuda_time_ms(
                lambda: p2.direction_matmul(x, soup), 10)
        elif v == "epilogue":
            ops = pairs * OPS_FAN_EPILOGUE + hoist
        ph.record(name, "madrona_mp_env_tpu_torch/csrc/fan_probe.cu",
                  P2_TPU[v], fn, err, cuda_time_ms(kernel, 20), vms,
                  k2_bytes + (soup.num_tris * 16 if v == "epilogue" else 0),
                  ops, [[N, F, soup.num_tris]], **extra)
    del want, exact
    torch.cuda.empty_cache()
    return ph.results


P4_SOURCE = "madrona_mp_env_tpu_torch/csrc/sc_mxu.cu"
P4_TPU = "tools/probes/sc_mxu_probe.py:66"
# P4 per (cast, row) pair: 18 groups x K 8 x 3 (3xTF32) tensor-core
# multiply-adds; the epilogue's f32 operations (face 19, three edge
# cylinders 23 each, three vertex spheres 10 each, the minimum)
MACS_SC_MXU = 18 * 8 * 3
OPS_SC_MXU = 19 + 3 * 23 + 3 * 10 + 1
P1_SOURCE = "madrona_mp_env_tpu_torch/csrc/vpu_probe.cu"
P1_TPU = "madrona_mp_env_tpu/tools/vpu_probe.py:35"
P1_MM_TPU = "madrona_mp_env_tpu/tools/vpu_probe.py:101"
# P1 per link, as the kernels' algebra needs them: (f32 instructions,
# special-function results); the fan epilogue's reciprocal is one per
# element (loop-invariant), counted apart
P1_WORK = {"fma_full_tile": (1, 0), "mul_full_tile": (1, 0),
           "fma_lane_bcast": (1, 0), "fma_sublane_bcast": (1, 0),
           "recip_approx_add": (1, 1), "div_exact_add": (1, 1),
           "cmp_sel_add": (3, 0), "fan_epilogue": (8, 0)}


def sc_mxu_rows():
    """P4 at the TPU probe's shape (24,576 casts x simple_map's 256 rows):
    the kernel against its plain version within its bars (the largest
    |t difference| where both hit, the share of casts whose hit or miss
    differs), its time, the plain version's, K4 dense's on the same casts
    and the share of casts at the TPU probe's parity bar against it; the
    bound over the (cast, valid row) pairs; the library row: the two
    products as torch.matmul (f32, TF32 off)."""
    import torch
    from madrona_mp_env_tpu_torch.ops import raycast
    from madrona_mp_env_tpu_torch.tools.probes import sc_mxu_probe as p4

    m = p4.probe_map("cuda")
    o, d = p4.make_casts(p4.CASTS, 0, "cuda")
    dirm, orgm, cons = p4.probe_tables(m, "cuda")
    planes = p4.planes_of(o, d)
    ph = KernelPhase(m.tris, "simple_map probes")

    def kernel():
        return p4.sphere_cast_mxu(planes, dirm, orgm, cons)

    got = kernel()
    want, pms = timed_once(lambda: p4._sc_mxu_plain(planes, dirm, orgm,
                                                    cons))
    torch.cuda.synchronize()
    err, flips = p4.mxu_error(got, want)
    if err > p4.MAX_DT or flips > p4.MAX_FLIP:
        raise AssertionError(f"P4 sc_mxu: max |dt| {err} (bar {p4.MAX_DT}),"
                             f" hit/miss differ on {flips} (bar "
                             f"{p4.MAX_FLIP})")
    frac, diff = p4.parity(got, raycast.sphere_cast(o, d, p4.R, m.tris)[0])
    library = cuda_time_ms(
        lambda: p4.library_products(planes, dirm, orgm), 10)
    N, T = o.shape[0], m.tris.num_tris
    pairs = N * ph.T_real
    log(f"[kernel] P4 sc_mxu: max |dt| {err:.6g} where both hit, hit/miss "
        f"differ on {flips:.6g} of {N} casts; against K4 dense "
        f"{frac:.6g} within the TPU probe's bar, max diff {diff:.6g}")
    ph.record(
        "P4 sc_mxu (3xTF32 mma)", P4_SOURCE, P4_TPU, p4.sphere_cast_mxu,
        err, cuda_time_ms(kernel, p4.NSCAN), pms,
        # planes' 6 rows in, t out; dirm, orgm; cons
        N * 28 + 2 * 8 * p4.G * T * 4 + T * 16 * 4,
        pairs * OPS_SC_MXU, [[N, T]],
        more=[(pairs * MACS_SC_MXU * 2, PEAK_TF32)], library_ms=library,
        hit_miss_share=flips, parity_vs_k4=frac,
        k4_dense_ms=round(cuda_time_ms(
            lambda: raycast.sphere_cast(o, d, p4.R, m.tris), p4.NSCAN), 4))
    del want
    torch.cuda.empty_cache()
    return ph.results


def vpu_rows():
    """P1 at the TPU probe's shapes: each chain on a 256 x 256 tile at its
    depth (the same elements NaN, +inf or -inf) and at vpu_probe.SHORT
    links (every element finite): the mul, divide and select chains
    bit-equal to their plain versions, the others within their bars,
    their error printed at both depths; and the two bf16 matmul
    chains; the kernel's time, the plain version's; the bound over the
    work the chain's algebra needs (f32 instructions at 33.5 T/s, the
    reciprocal and divide chains at the special-function rate, the
    matmuls at the bf16 tensor-core rate with MACs at K); the library row
    for the matmuls: 64 torch.matmul calls in bf16 (none computes a
    dependent elementwise chain in one call). Besides, each kernel's
    device time by torch.profiler: the CUDA events around back-to-back
    launches also count the host's gaps between these short launches."""
    import torch
    from madrona_mp_env_tpu_torch.tools import vpu_probe as vp

    rs = np.random.RandomState(0)
    rows, scene = [], "vpu probe"
    n = vp.ROWS * vp.COLS
    for name in vp.CHAINS:
        a, b = vp.chain_inputs(rs, device="cuda")
        loop = vp.chain_loop(name)
        fn = vp.ENTRIES[name]
        got = fn(a, b, loop)
        want, pms = timed_once(lambda: vp._chain_plain(name, a, b, loop))
        torch.cuda.synchronize()
        err, rel = vp.check_chain(name, got, want, vp.BARS.get(name, 0.0))
        short_err, short_rel = vp.check_short(name, a, b)
        insns, sfu = P1_WORK[name]
        sfu_ops = n * (1 if name == "fan_epilogue" else loop * sfu)
        log(f"[kernel] P1 {name}: max abs err {err:.6g}, max rel err "
            f"{rel:.6g} against its plain version (bar "
            f"{vp.BARS.get(name, 0.0)}), {short_err:.6g} and {short_rel:.6g}"
            f" at {vp.SHORT} links, every element finite; library: none "
            f"(no PyTorch call runs a dependent chain)")
        rows.append(kernel_row(
            scene, f"P1 vpu_chain {name}", P1_SOURCE, P1_TPU, fn, err,
            cuda_time_ms(lambda: fn(a, b, loop), 20), pms, 3 * n * 4,
            n * loop * insns, [[vp.ROWS, vp.COLS, loop]],
            peak=PEAK_F32_INSNS, more=[(sfu_ops, PEAK_SFU)], rel_err=rel,
            short_max_abs_err=short_err, short_rel_err=short_rel,
            device_ms=device_ms(lambda: fn(a, b, loop), "vpu_", 20, 5)))
    for K, M, N in vp.MM_SHAPES:
        a, b = vp.mm_inputs(rs, K, M, N, device="cuda")
        fn = vp.MM_ENTRIES[K]
        got = fn(a, b, vp.MM_DEPTH)
        want, pms = timed_once(lambda: vp._mm_plain(a, b, vp.MM_DEPTH))
        torch.cuda.synchronize()
        err, rel = vp.check_chain(f"matmul K={K}", got, want, vp.MM_BAR,
                                  finite=True)
        library = cuda_time_ms(
            lambda: [torch.matmul(a, b) for _ in range(vp.MM_DEPTH)], 5)
        log(f"[kernel] P1 vpu_mma K={K}: max abs err {err:.6g}, max rel err "
            f"{rel:.6g} against its plain version (bar {vp.MM_BAR})")
        rows.append(kernel_row(
            scene, f"P1 vpu_mma K={K}", P1_SOURCE, P1_MM_TPU, fn, err,
            cuda_time_ms(lambda: fn(a, b, vp.MM_DEPTH), 20), pms,
            M * K * 2 + K * N * 2 + M * N * 4, vp.MM_DEPTH * M * N * K * 2,
            [[M, K, N, vp.MM_DEPTH]], peak=PEAK_BF16, library_ms=library,
            rel_err=rel,
            device_ms=device_ms(lambda: fn(a, b, vp.MM_DEPTH), "vpu_",
                                20, 5)))
    return rows


def probes_phase(cfg, card):
    """The probes P3 (fused movement, each map), P5, P6, P2, P4 and P1:
    their rows (p3_rows, fan_probe_rows, sc_mxu_rows, vpu_rows), then each
    probe's main as the command line runs it, with every launch counter
    zeroed just before and read just after: its launches are these
    rows'."""
    import torch
    from madrona_mp_env_tpu_torch.tools import fan_probe as p2
    from madrona_mp_env_tpu_torch.tools import vpu_probe as p1
    from madrona_mp_env_tpu_torch.tools.probes import (
        movement_fused_probe as mf, sc_mxu_probe as p4,
        v9_kernel_probe as p5, v9_scan_timing as p6,
    )

    rows = [r for scene in (SCENE, TOWN) for r in p3_rows(cfg, scene)]
    rows += fan_probe_rows() + sc_mxu_rows() + vpu_rows()
    entries = all_entries()
    for f in entries.values():
        f.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for scene in (SCENE, TOWN):
        res = mf.main(["--worlds", str(NUM_WORLDS), "--scene", scene,
                       "--steps", str(P3_STEPS), "--iters", "5"])
        bad = [k for k, v in res.items()
               if any(v[f"vs_{w}_{q}"] for w in ("plain", "split")
                      for q in ("pos", "vel"))]
        if bad:
            raise AssertionError(f"P3 main: fused differs under {bad}")
    res = {"P5": p5.main([]),
           "P6": p6.main(["--chain", str(FAN_PROBE_CHAIN)]),
           "P2": p2.main([])}
    res_p4, res_p1 = p4.main([]), p1.main([])
    torch.cuda.synchronize()
    label = "probes"
    for row in rows:
        row["launches"] = row["entry"].launches
        row["path"] = label
    missing = [r["name"] for r in rows if r["launches"] == 0]
    times = [v for r in res.values() for k, v in r.items()
             if not k.startswith("rcp_approx_")]
    times += [res_p4[k] for k in ("mxu_ms", "prod_ms")]
    times += [r[k] for r in res_p1.values() for k in ("ms", "rate")]
    if missing or not all(np.isfinite(v) and v > 0 for v in times):
        raise AssertionError(f"{label}: kernels not launched {missing} or "
                             f"a bad time {res}")
    log(f"[{label}] {time.perf_counter() - t0:.1f} s on {card}; launches "
        + ", ".join(f"{n}={f.launches}" for n, f in entries.items()))
    return rows


def bench_actions(W, A, steps, seed=0):
    """bench.py's representative run-and-shoot mix, drawn with numpy
    ([steps, W, A] each; the fused-movement probe's own draw)."""
    from madrona_mp_env_tpu_torch.tools.probes import movement_fused_probe

    return movement_fused_probe.bench_actions(W, A, steps, seed)


def actions_at(env, acts, s):
    import torch

    a = env.zero_actions()
    return a.replace(**{k: torch.as_tensor(v[s], dtype=torch.int32,
                                           device=env.device)
                        for k, v in acts.items()})


def rollout(mt, cfg, scene, W, steps, device, seed=5, bots=False,
            states=None, obs_keys=()):
    """``steps`` steps of bench.py's actions; ``bots``: team 1 of every
    world is the scripted bot from the reset on. ``states``, a list,
    receives the env and each step's state; ``obs_keys``: more
    observations recorded."""
    env = mt.Env(cfg, scene, num_worlds=W, seed=seed, device=device)
    acts = bench_actions(W, cfg.num_agents, steps)
    state, obs = env.reset()
    if bots:
        state.policy_idx[:, cfg.team_size:] = -1
    hist = []
    for s in range(steps):
        state, out = env.step(state, actions_at(env, acts, s))
        hist.append({
            "pos": state.pos, "hp": state.hp, "alive": state.alive,
            "team_points": state.team_points, "done": out["done"],
            "reward": out["reward"], "fwd_lidar": out["obs"]["fwd_lidar"],
            "self": out["obs"]["self"],
            **{k: out["obs"][k] for k in obs_keys},
        })
        if states is not None:
            states.append((env, state))
    return [{k: v.cpu().numpy() for k, v in h.items()} for h in hist]


def lidar_undecided(env, state, rays, delta):
    """For forward-lidar rays ``rays`` [(w, a, h, x), ...] of ``state`` (a
    CPU state), whether the ray's first hit (a capsule, or the world as
    -1) changes when every capsule's radius shrinks or grows by
    ``delta[w]``: a ray within delta of grazing a capsule or of a tie, so
    a position gap of that size between two devices may flip its hit."""
    import torch
    from madrona_mp_env_tpu_torch import consts
    from madrona_mp_env_tpu_torch.ops import raycast
    from madrona_mp_env_tpu_torch.ops.raycast_cull import CAPSULE_SEG_H
    from madrona_mp_env_tpu_torch.sim import observations as ob

    cfg = env.cfg
    _, dirs, zg, zgroups = ob.sensor_fan(cfg, state)
    sensor = ob.build_sensor_rays(cfg, env.map_data, state)
    n_los, r0 = zgroups[0], consts.agent_radius
    out = []
    for w, a, h, x in rays:
        f = n_los + h * consts.fwd_lidar_width + x
        o = state.pos[w, a] + torch.tensor([0.0, 0.0, float(zg[w, a, 1 + h])])
        d = torch.stack([c[w, a, f] for c in dirs])
        t_world = float(sensor["fwd_t"][w, a, h, x])
        live = (state.alive[w] > 0.0) & (torch.arange(cfg.num_agents) != a)
        first = []
        for r in (r0 - delta[w], r0 + delta[w]):
            p0 = state.pos[w] + torch.tensor([0.0, 0.0, r0])
            seg = torch.tensor([0.0, 0.0, CAPSULE_SEG_H]).expand_as(p0)
            t = raycast._ray_vs_segment_capsule(
                o, d, p0, seg, torch.full_like(p0[:, 0], CAPSULE_SEG_H ** 2),
                r)
            t = torch.where(live, t, float("inf"))
            tc, ic = t.min(0)
            first.append(int(ic) if float(tc) < t_world else -1)
        out.append(first[0] != first[1])
    return out


# steps of each step_profile window: the profiler's host events cost
# seconds a step to gather (cut from 10 to keep the run in its limit)
PROFILE_STEPS = 5


def step_profile(env, state, actions, fused_tail=True, profile=True):
    """PROFILE_STEPS env steps from ``state``: wall ms per step (host clock
    around synchronized steps) and, with ``profile``, CUDA device
    operations per step and the device us per step of K5's kernel
    (torch.profiler). ``fused_tail=False`` runs the unfused chain that K5
    replaced, for comparison in the same process."""
    import torch
    from madrona_mp_env_tpu_torch.sim import step as step_mod

    saved = step_mod.use_tail_fused
    if not fused_tail:
        step_mod.use_tail_fused = lambda cfg, collect_log=False: False
    try:
        state, _ = env.step(state, actions)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(PROFILE_STEPS):
            state, _ = env.step(state, actions)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / PROFILE_STEPS
        if not profile:
            return {"wall_ms": wall_ms}
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(PROFILE_STEPS):
                state, _ = env.step(state, actions)
            torch.cuda.synchronize()
    finally:
        step_mod.use_tail_fused = saved
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        raise AssertionError("the profiler saw no CUDA kernels")
    k5_us = sum(e.device_time_total for e in dev
                if "tail_fused_kernel" in e.name)
    return {"wall_ms": wall_ms, "launches": len(dev) / PROFILE_STEPS,
            "k5_us": k5_us / PROFILE_STEPS}


def eval_setup(mt, W, steps, chunk_steps, device, scene=SCENE,
               vs_bot=False):
    """EvalManager (``vs_bot``: against the scripted bot), P seeded
    full-width policies and seeded normalizer stats (numpy, so every
    device gets the same values), on ``device``."""
    import torch
    from madrona_mp_env_tpu_torch.train import (EvalConfig, EvalManager,
                                                build_actor_critic,
                                                init_normalizer)

    cfg = mt.EnvConfig(task=mt.Task.Zone, team_size=TEAM_SIZE,
                       sim_flags=mt.SimFlags.SimEvalMode)
    env = mt.Env(cfg, scene, num_worlds=W, seed=5, device=device)
    ecfg = EvalConfig(num_worlds=W, num_eval_steps=steps,
                      chunk_steps=chunk_steps, seed=10)
    mgr = EvalManager(cfg, ecfg, env, EVAL_POLICIES, vs_bot=vs_bot,
                      device=device)
    policies = [build_actor_critic(seed=s, device=device)
                for s in range(EVAL_POLICIES)]
    _, obs, _ = mgr.init_state()
    norm = init_normalizer(mgr._policy_obs(obs))
    g = np.random.default_rng(7)
    for k in sorted(norm.mu):
        n = norm.mu[k].shape[0]
        norm.mu[k] = torch.as_tensor(g.normal(0.0, 0.1, n), dtype=torch.float32,
                                     device=device)
        norm.var[k] = torch.as_tensor(g.uniform(0.5, 2.0, n),
                                      dtype=torch.float32, device=device)
    elo = torch.full((EVAL_POLICIES,), 1500.0, device=device)
    return mgr, policies, norm, elo


def eval_phase(mt, kernels, card):
    """The crossplay eval at EVAL_WORLDS x EVAL_STEPS on the card: rates
    over the steady chunks (after the first, which holds the reset), the
    policy forward's time at the rollout's shapes (CUDA events), and the
    kernels' launches during the run."""
    import torch

    chunk = 10
    mgr, policies, norm, elo = eval_setup(mt, EVAL_WORLDS, EVAL_STEPS, chunk,
                                          "cuda")
    stamps = []

    def on_chunk(outs):
        # run() has synchronized for its zone-swap accounting already
        stamps.append(time.perf_counter())
        for k in ("values", "logits", "rewards"):
            if not bool(torch.isfinite(outs[k]).all()):
                raise AssertionError(f"eval: non-finite {k}")

    fused = all_entries()["apply_velocity_fall_fused"]
    for k in kernels:
        k["entry"].launches = 0
    fused.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    elo = mgr.run(policies, norm, elo, iter_cb=on_chunk, verbose=False)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = {k["name"]: k["entry"].launches for k in kernels}
    missing = [n for n, c in launches.items() if c == 0]
    if missing:
        raise AssertionError(f"kernels not launched by the eval: {missing}")
    if fused.launches:
        raise AssertionError("the eval launched the fused movement (P3)")
    if len(stamps) != EVAL_STEPS // chunk or elo.shape != (EVAL_POLICIES,) \
            or not bool(torch.isfinite(elo).all()):
        raise AssertionError("eval: wrong chunk count or ELO")
    steps_s = (len(stamps) - 1) * chunk / (stamps[-1] - stamps[0])
    _, obs, rnn = mgr.init_state()
    with torch.no_grad():
        fwd_ms = cuda_time_ms(lambda: mgr.forward(policies, norm, obs, rnn),
                              20)
    A = mgr.A
    log(f"[eval] crossplay, {EVAL_WORLDS} worlds x {EVAL_STEPS} sampled steps,"
        f" P = {EVAL_POLICIES} seeded full-width policies: whole run "
        f"{t1 - t0:.3f} s (reset included); steady chunks "
        f"{EVAL_WORLDS * A * steps_s:.1f} agent-steps/s, "
        f"{EVAL_WORLDS * steps_s:.1f} env-steps/s, {1e3 / steps_s:.2f} "
        f"ms/step; policy forward {fwd_ms:.3f} ms/step "
        f"({fwd_ms * steps_s / 10:.1f}% of the step) on {card}; launches "
        + ", ".join(f"{n}={c}" for n, c in launches.items()))


def _gumbel_margin(logits, key):
    """Smallest top-two gap over the heads of log probs + the step key's
    Gumbel noise (ActorDistributions.sample's stream): [P, B / P]. With
    key None, of the logits alone (best() decides)."""
    import torch
    from madrona_mp_env_tpu_torch.train.distributions import (
        AIM_BUCKETS, DISCRETE_BUCKETS, gumbel)
    from madrona_mp_env_tpu_torch.utils import rng

    ks = rng.split(key, 2) if key is not None else (None, None)
    gaps, off = [], 0
    for k, buckets in zip(ks, (DISCRETE_BUCKETS, AIM_BUCKETS)):
        lp = logits[..., off:off + sum(buckets)]
        z = lp if k is None else lp + gumbel(k, lp.shape)
        o = 0
        for b in buckets:
            two = torch.topk(z[..., o:o + b], 2, dim=-1).values
            gaps.append(two[..., 0] - two[..., 1])
            o += b
        off += sum(buckets)
    return torch.stack(gaps).amin(0)


def eval_rollout(mt, W, S, device):
    import torch
    from madrona_mp_env_tpu_torch.train.infer import chunk_keys

    mgr, policies, norm, elo = eval_setup(mt, W, S, S, device)
    env_state, obs, rnn = mgr.init_state()
    keys = chunk_keys(mgr.ecfg.seed, 1, S, device=device)[0]
    hist = []
    with torch.no_grad():
        for t in range(S):
            env_state, obs, rnn, elo, o = mgr.step(
                policies, norm, env_state, obs, rnn, elo, keys[t])
            hist.append({
                "discrete": o["actions"]["discrete"], "aim": o["actions"]["aim"],
                "values": o["values"], "logits": o["logits"],
                "hp": env_state.hp, "alive": env_state.alive,
                "team_points": env_state.team_points, "done": o["dones"],
                "key": keys[t],
            })
    return [{k: v.cpu() for k, v in h.items()} for h in hist]


def eval_parity(mt, W, S, margin=1e-4, rel=1e-4):
    """The eval rollout on "cuda" against "cpu": actions equal wherever the
    CPU run's Gumbel top-two margin exceeds ``margin``; values and logits
    within rel * max(1, |x|); hp, alive, team points and done exact; all
    up to the first step where an action differs."""
    gpu = eval_rollout(mt, W, S, "cuda")
    cpu = eval_rollout(mt, W, S, "cpu")
    worst, compared, undecided = {}, 0, 0
    for t, (a, b) in enumerate(zip(gpu, cpu)):
        decided = _gumbel_margin(b["logits"], b["key"]) > margin
        undecided += int((~decided).sum())
        same = (a["discrete"] == b["discrete"]).all(-1) & (
            a["aim"] == b["aim"]).all(-1)
        if not bool(same[decided].all()):
            raise AssertionError(f"eval step {t}: decided actions differ")
        for k in ("values", "logits"):  # computed before this step's actions
            e = ((a[k] - b[k]).abs() / b[k].abs().clamp(min=1.0)).max()
            worst[k] = max(worst.get(k, 0.0), float(e))
            if float(e) > rel:
                raise AssertionError(f"eval step {t}: {k} rel err {float(e)}")
        compared = t + 1
        if not bool(same.all()):
            break  # an undecided action parted the two runs
        for k in ("hp", "alive", "team_points", "done"):
            if not np.array_equal(a[k].numpy(), b[k].numpy()):
                raise AssertionError(f"eval step {t}: {k} differs cuda vs cpu")
    log(f"[eval parity] cuda vs cpu, {W} worlds x {S} steps: {compared} steps"
        f" compared, actions equal where decided ({undecided} undecided of "
        f"{compared * W * 2 * TEAM_SIZE}), hp/alive/team points/done exact, "
        + ", ".join(f"{k} max rel err {v:.3g}" for k, v in worst.items()))


def all_entries():
    """Every kernel entry of the port, by name; each counts its launches."""
    from madrona_mp_env_tpu_torch.ops import raycast, raycast_cull, tail_fused
    from madrona_mp_env_tpu_torch.tools import fan_probe, vpu_probe
    from madrona_mp_env_tpu_torch.tools.probes import (
        movement_fused_probe, sc_mxu_probe, v9_kernel_probe, v9_scan_timing,
    )

    return {f.__name__: f for f in (
        raycast.ray_vs_tris, raycast.ray_vs_tris_v1,
        raycast.ray_fans_vs_tris, raycast.ray_fans_vs_tris_flat_v1,
        raycast.ray_fans_culled, raycast.fan_cell_order,
        raycast.ray_fans_culled_v1, raycast.ray_fans_culled_v9,
        raycast.ray_fans_vs_tris_flat, raycast_cull.fan_capsules,
        raycast_cull.fan_capsules_v1,
        raycast_cull.fan_capsules_explicit, raycast.sphere_cast,
        raycast.sphere_cast_v1, raycast.sphere_cast_vs_tris,
        raycast.sphere_cast_vs_tris_v1, raycast.sphere_cast_culled,
        raycast.sphere_cast_packed, raycast.sphere_cast_culled_v1,
        tail_fused.tail_fused, tail_fused.tail_fused_v1,
        movement_fused_probe.apply_velocity_fall_fused,
        v9_kernel_probe.ray_fans_v9_gathered,
        v9_scan_timing.ray_fans_v9_chunked,
        *fan_probe.ENTRIES.values(), sc_mxu_probe.sphere_cast_mxu,
        *vpu_probe.ENTRIES.values(), *vpu_probe.MM_ENTRIES.values())}


def zero_counts():
    """Every kernel entry's launch counter set to 0; returns the entries."""
    entries = all_entries()
    for f in entries.values():
        f.launches = 0
    return entries


def expect_launches(rows, name, n, key="launches"):
    """The path's launches of the kernel row ``name`` (drive_path; with
    ``key`` "vs_bot_launches" the vs-bot eval's, bots_phase) are n: one
    per Env.reset and Env.step."""
    (row,) = [r for r in rows if r["name"].startswith(name + " [")]
    path = row["vs_bot_path" if key == "vs_bot_launches" else "path"]
    if row[key] != n:
        raise AssertionError(f"{row['name']}: {row[key]} launches on "
                             f"{path}, expected {n}")
    log(f"[launches] {row['name']}: {n} on {path}")


def drive_path(label, env, acts, steps, rows, not_launched, card,
               expect=None):
    """Reset + ``steps`` steps of ``env`` with every launch counter zeroed
    just before and read just after. Each row of ``rows`` (this path's
    kernels) gets its entry's count as ``launches`` and must be > 0; the
    entries named in ``not_launched`` must stay at 0 (a gate that fell
    back fails the run), and so must the predecessors (PREDECESSORS);
    each entry of ``expect`` ({name: count}) must launch exactly that
    often. Returns (state, out, env-steps/s)."""
    import torch

    entries = zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, obs = env.reset()
    t_reset = time.perf_counter()
    for s in range(steps):
        state, out = env.step(state, actions_at(env, acts, s))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for name, x in out["obs"].items():
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"{label}: non-finite obs {name}")
    counts = check_counts(label, entries, rows, not_launched, expect)
    sps = env.num_worlds * steps / (t1 - t_reset)
    log(f"[{label}] {env.num_worlds} worlds x {steps} steps: reset "
        f"{t_reset - t0:.3f} s, steps {t1 - t_reset:.3f} s, {sps:.1f} "
        f"env-steps/s on {card}; launches "
        + ", ".join(f"{n}={c}" for n, c in counts.items()))
    return state, out, sps


def check_counts(label, entries, rows, not_launched, expect):
    """The launch counters of ``entries`` after a path: each row of
    ``rows`` gets its entry's count as ``launches`` (> 0) and the path's
    ``label``; the entries of ``not_launched`` and the predecessors stay
    at 0; each entry of ``expect`` ({name: count}) launched exactly that
    often. Returns {entry: count}."""
    counts = {n: f.launches for n, f in entries.items()}
    for row in rows:
        row["launches"] = row["entry"].launches
        row["path"] = label
    missing = [r["name"] for r in rows if r["launches"] == 0]
    if missing:
        raise AssertionError(f"{label}: kernels not launched: {missing}")
    wrong = [n for n in tuple(not_launched) + PREDECESSORS if counts[n]]
    if wrong:
        raise AssertionError(f"{label}: launched {wrong}, which this path "
                             f"must not: {counts}")
    for name, n in (expect or {}).items():
        if counts[name] != n:
            raise AssertionError(f"{label}: {name} launched {counts[name]} "
                                 f"times, expected {n}")
        log(f"[launches] {name}: {n} on {label}")
    return counts


def env_parity(mt, cfg, scene, W, S, bots=False, label="Zone",
               graze=False, obs_keys=()):
    """The env rollout on "cuda" against "cpu" from one seed (``bots``:
    team 1 the scripted bot): hp, alive, team points and done exact; NaN
    at the same places; pos and reward within 1e-4, lidar and self
    observations within 1e-3, each times max(1, |x|). ``label`` names
    the configuration. With ``graze``, a forward-lidar ray outside its
    bar passes when lidar_undecided finds it within 4x its world's
    largest pos gap between the devices (+ 1e-3) of changing its hit;
    such rays are counted and logged. ``obs_keys``: more observations,
    compared as "self"."""
    cpu_states = []
    gpu = rollout(mt, cfg, scene, W, S, "cuda", bots=bots,
                  obs_keys=obs_keys)
    cpu = rollout(mt, cfg, scene, W, S, "cpu", bots=bots,
                  states=cpu_states if graze else None, obs_keys=obs_keys)
    worst, grazes = {}, 0
    name = f"{os.path.basename(scene)} {label}"
    for s, (a, b) in enumerate(zip(gpu, cpu)):
        for k in ("hp", "alive", "team_points", "done"):
            if not np.array_equal(a[k], b[k]):
                raise AssertionError(f"{name} step {s}: {k} differs cuda vs "
                                     "cpu")
        for k, rel in (("pos", 1e-4), ("reward", 1e-4), ("fwd_lidar", 1e-3),
                       ("self", 1e-3)) + tuple((k, 1e-3) for k in obs_keys):
            if not np.array_equal(np.isnan(a[k]), np.isnan(b[k])):
                raise AssertionError(f"{name} step {s}: {k} NaN differs")
            e = np.nan_to_num(np.abs(a[k] - b[k])
                              / np.maximum(1.0, np.abs(b[k])))
            if graze and k == "fwd_lidar" and e.max() > rel:
                rays = np.argwhere(e.max(-1) > rel)
                gap = np.abs(a["pos"] - b["pos"]).max((1, 2))
                env, st = cpu_states[s]
                if not all(lidar_undecided(env, st, rays, 4 * gap + 1e-3)):
                    raise AssertionError(
                        f"{name} step {s}: lidar rays {rays.tolist()} differ "
                        f"and are decided (pos gap {gap.tolist()})")
                log(f"[parity] {name} step {s}: lidar rays "
                    f"{rays.tolist()} differ within a graze (pos gap "
                    f"{gap.max():.3g}): cuda {a[k][tuple(rays.T)].tolist()}"
                    f" cpu {b[k][tuple(rays.T)].tolist()}")
                grazes += len(rays)
                e[tuple(rays.T)] = 0.0
            worst[k] = max(worst.get(k, 0.0), float(e.max()))
            if e.max() > rel:
                raise AssertionError(f"{name} step {s}: {k} rel err "
                                     f"{e.max()}")
    log(f"[parity] {name} {cfg.team_size}v{cfg.team_size}"
        f"{', team 1 bots' if bots else ''} cuda vs cpu, "
        f"{W} worlds x {S} steps: discrete "
        "exact, " + ", ".join(f"{k} max rel err {v:.3g}"
                              for k, v in worst.items())
        + (f", {grazes} lidar rays within a graze" if graze else ""))


def golden_on_card(card):
    """tools/golden.py's rollout (the committed 100-step scripted-bot
    golden: Zone 2v2, 2 worlds, seed 7, every agent a bot) on the card,
    against the golden and against the port's own CPU rollout: hp and
    team points exact and pos within 1e-4 relative for as long as the CPU
    rollout holds against the golden; each first divergence printed."""
    from madrona_mp_env_tpu_torch.tools import golden

    with np.load(golden.DEFAULT_PATH) as z:
        want = {k: z[k] for k in golden.FIELDS}
    cpu = golden.rollout("cpu")
    gpu = golden.rollout("cuda")
    held = golden.compare(cpu, want)["first_divergence_step"]
    for name, ref in (("the golden", want), ("the CPU rollout", cpu)):
        r = golden.compare(gpu, ref, min_steps=held)
        log(f"[golden] cuda against {name}: first pos divergence at step "
            f"{r['first_divergence_step']} of {r['steps']} (the CPU rollout "
            f"holds the golden to step {held}); up to it max rel err pos "
            f"{r['max_pos_err']:.3g}, yaw {r['max_yaw_err']:.3g}, reward "
            f"{r['max_reward_err']:.3g}; hp exact {r['hp_exact']}, team "
            f"points exact {r['team_points_exact']}, reward exact "
            f"{r['reward_exact']}; whole run pos {r['max_pos_err_full']:.3g}"
            f" on {card}")


def vs_bot_eval(mt, scene, rows, card):
    """The vs-bot eval at EVAL_WORLDS x EVAL_STEPS on ``scene``: every
    counter zeroed before the run and read after, each kernel of ``rows``
    held to its count on the path (one launch per reset and step; K4' 3
    a step); agent-steps/s and ms per step over the steady chunks, the
    planner's ms per step (bot_overlay, CUDA events), CUDA launches per
    step with the bots and, from the same state, without them."""
    import torch
    from madrona_mp_env_tpu_torch.sim import bot

    chunk = 10
    name = os.path.basename(scene)
    label = f"vs-bot eval {name}"
    mgr, policies, norm, elo = eval_setup(mt, EVAL_WORLDS, EVAL_STEPS, chunk,
                                          "cuda", scene=scene, vs_bot=True)
    stamps = []

    def on_chunk(outs):
        stamps.append(time.perf_counter())
        for k in ("values", "logits", "rewards"):
            if not bool(torch.isfinite(outs[k]).all()):
                raise AssertionError(f"{label}: non-finite {k}")

    entries = all_entries()
    for f in entries.values():
        f.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    elo2 = mgr.run(policies, norm, elo, iter_cb=on_chunk, verbose=False)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    counts = {n: f.launches for n, f in entries.items()}
    for row in rows:
        row["vs_bot_launches"] = row["entry"].launches
        row["vs_bot_path"] = label
    wrong = [n for n in ("apply_velocity_fall_fused",) + PREDECESSORS
             if counts[n]]
    if wrong:
        raise AssertionError(f"{label}: launched {wrong}")
    if not torch.equal(elo2, elo) or mgr.vs_bot_wdl.shape != (
            EVAL_POLICIES, 3) or len(stamps) != EVAL_STEPS // chunk:
        raise AssertionError(f"{label}: ELO moved, or wrong counts")
    fan = "K2 ray_fans_vs_tris" if name == "simple_map" else \
        "K6 ray_fans_culled"
    for rname, n in ((fan, EVAL_STEPS + 1), ("K3 fan_capsules",
                                             EVAL_STEPS + 1),
                     ("K1 ray_vs_tris", EVAL_STEPS),
                     ("K4 sphere_cast_culled", EVAL_STEPS),
                     ("K4' sphere_cast_packed", 3 * EVAL_STEPS),
                     ("K5 tail_fused", EVAL_STEPS)) + (
            (("K6 cell order", EVAL_STEPS + 1),) if name == "town_map"
            else ()):
        expect_launches(rows, rname, n, key="vs_bot_launches")
    steps_s = (len(stamps) - 1) * chunk / (stamps[-1] - stamps[0])

    env = mgr.env
    state, _, _ = mgr.init_state()
    actions = env.zero_actions()
    state, _ = env.step(state, actions)
    bots = state.policy_idx == -1
    if not bool(bots[:, TEAM_SIZE:].all()) or bool(bots[:, :TEAM_SIZE].any()):
        raise AssertionError(f"{label}: team 1 is not the bot")

    def plan():
        return bot.bot_overlay(env.cfg, env.map_data, state, actions)

    plan_ms = cuda_time_ms(plan, 20)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        plan()
        torch.cuda.synchronize()
    planned = len([e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA])
    with_bots = step_profile(env, state, actions)["launches"]
    none = state.replace(policy_idx=torch.zeros_like(state.policy_idx))
    without = step_profile(env, none, actions)["launches"]
    A = mgr.A
    log(f"[{label}] {EVAL_WORLDS} worlds x {EVAL_STEPS} sampled steps, P = "
        f"{EVAL_POLICIES} seeded full-width policies vs the bot: whole run "
        f"{t1 - t0:.3f} s (reset included); steady chunks "
        f"{EVAL_WORLDS * A * steps_s:.1f} agent-steps/s, "
        f"{1e3 / steps_s:.2f} ms/step; planner (bot_overlay) "
        f"{plan_ms:.3f} ms/step by CUDA events, {planned} launches; "
        f"CUDA launches per step {with_bots:.1f} with bots, {without:.1f} "
        f"without; W/D/L {mgr.vs_bot_wdl.tolist()} on {card}; launches "
        + ", ".join(f"{n}={c}" for n, c in counts.items() if c))


def bots_phase(mt, cfg, simple_rows, town_rows, card):
    """The scripted bot on the card: the golden, the vs-bot eval on each
    map, and team 1 as bots on "cuda" against "cpu"."""
    golden_on_card(card)
    vs_bot_eval(mt, SCENE, simple_rows, card)
    vs_bot_eval(mt, TOWN, town_rows, card)
    env_parity(mt, cfg, SCENE, 4, 8, bots=True)
    env_parity(mt, cfg, TOWN, 4, 8, bots=True)


TRAIN_WORLDS = 1024
TRAIN_STEPS = 40  # steps_per_update, the JAX bench's train row
# route: (map, team size, MPENV_FAN_V9, updates, the sensor fan's entry,
# the CLI's precision flags)
TRAIN_ROUTES = {
    "default": (SCENE, TEAM_SIZE, "0", 1, "ray_fans_vs_tris", []),
    "v9": (SCENE, TEAM_SIZE, "1", 1, "ray_fans_culled_v9", []),
    "zone3v3": (SCENE, 3, "0", 1, "ray_fans_vs_tris_flat", []),
    "zone3v3 town_map": (TOWN, 3, "0", 1, "ray_fans_vs_tris_flat", []),
    "bf16": (SCENE, TEAM_SIZE, "0", 1, "ray_fans_vs_tris", ["--bf16"]),
    "fp16": (SCENE, TEAM_SIZE, "0", 1, "ray_fans_vs_tris", ["--fp16"]),
}
FAN_ENTRIES = ("ray_fans_vs_tris", "ray_fans_culled", "ray_fans_culled_v9",
               "ray_fans_vs_tris_flat")
# the kernels of the Zone 6v6 simple_map path (phase 4)
SIMPLE_PATH = ("ray_vs_tris", "ray_fans_vs_tris", "fan_capsules",
               "sphere_cast_culled", "sphere_cast_packed", "tail_fused")
# launches of each per env step (K4' casts three times a step)
SIMPLE_PER_STEP = {"sphere_cast_packed": 3}


def _dtype_of(flags):
    import torch

    return {"--bf16": torch.bfloat16, "--fp16": torch.float16}.get(
        (flags or [None])[0], torch.float32)


def train_phase(card):
    """The training path at full width through the train CLI's own
    builder: TrainingManager at TRAIN_WORLDS worlds x TRAIN_STEPS steps
    per update (4 BPTT chunks, 2 epochs x 4 minibatches), the LSTM-512
    policy, E = 1, weights from a seed, on each of TRAIN_ROUTES: Zone 6v6
    on the default fan route (K2), then with MPENV_FAN_V9=1 (K9), then
    Zone 3v3 (K7) on each map, then Zone 6v6 with --bf16 and --fp16 (the
    policy's compute dtype; the stored observations and BPTT start states
    must come out in it). Each update's rollout and PPO update are timed
    by CUDA events; every launch counter is zeroed before each run and
    read after it; the loss must be finite, the parameters must move,
    and the sensor fans must go through the route's entry alone."""
    for route, (scene, ts_, v9, n, fan, flags) in TRAIN_ROUTES.items():
        train_run(route, scene, ts_, v9, n, fan, flags, card)


def train_run(route, scene, ts_, v9, n, fan, flags, card, extra=(),
              steps=TRAIN_STEPS):
    """``n`` updates of ``steps`` steps of one route of train_phase
    (``extra``: more flags of the CLI, such as a --game-mode), checked and
    logged as train_phase says."""
    import torch
    from madrona_mp_env_tpu_torch.train import train as train_cli

    dtype = _dtype_of(flags)
    with mock.patch.dict(os.environ, {"MPENV_FAN_V9": v9}):
        args = train_cli.parse_args([
            "--scene", scene, "--num-worlds", str(TRAIN_WORLDS),
            "--steps-per-update", str(steps),
            "--team-size", str(ts_)] + flags + list(extra))
        cfg, tcfg, env, mgr = train_cli.build(args)
        if mgr.model.dtype != dtype or tcfg.compute_dtype != dtype:
            raise AssertionError(f"train {route}: compute dtype "
                                 f"{mgr.model.dtype}, asked {dtype}")
        ts = mgr.init()
        p0 = {k: v.clone() for k, v in ts.params[0].items()}
        entries = all_entries()
        for f in entries.values():
            f.launches = 0
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        roll_ms, ppo_ms, losses = [], [], []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            ev[0].record()
            ts, starts, outs, boot = mgr.rollout(ts)
            ev[1].record()
            ts, metrics = mgr.ppo_update(ts, starts, outs, boot)
            ev[2].record()
            torch.cuda.synchronize()
            roll_ms.append(ev[0].elapsed_time(ev[1]))
            ppo_ms.append(ev[1].elapsed_time(ev[2]))
            losses.append(float(metrics["loss"][0]))
            if starts.dtype != dtype or outs["obs_pack"].dtype != dtype:
                raise AssertionError(f"train {route}: buffers in "
                                     f"{outs['obs_pack'].dtype}")
        t1 = time.perf_counter()
    counts = {k: f.launches for k, f in entries.items()}
    moved = max(float((ts.params[0][k] - v).abs().max())
                for k, v in p0.items())
    if not all(np.isfinite(losses)) or moved == 0.0:
        raise AssertionError(f"train {route}: losses {losses}, params "
                             f"moved {moved}")
    if counts[fan] != n * steps or any(
            counts[f] for f in FAN_ENTRIES if f != fan):
        raise AssertionError(f"train {route}: fan launches {counts}")
    samples = TRAIN_WORLDS * cfg.num_agents * steps
    ups = n / (t1 - t0)
    log(f"[train {route}] {TRAIN_WORLDS} worlds x {steps} steps x "
        f"{n} updates, LSTM-512, E = 1, {str(dtype)[6:]}: {ups:.4f} "
        f"updates/s, "
        f"{ups * samples:.1f} samples/s; rollout ms "
        + ", ".join(f"{x:.1f}" for x in roll_ms) + "; PPO update ms "
        + ", ".join(f"{x:.1f}" for x in ppo_ms)
        + f" (CUDA events); losses "
        + ", ".join(f"{x:.5f}" for x in losses)
        + f"; params moved up to {moved:.3g}; launches "
        + ", ".join(f"{k}={c}" for k, c in counts.items())
        + f" on {card}")
    del ts, mgr, env


PBT_WORLDS = 1024
PBT_UPDATES = 1
# reductions: EnvConfig's episode_len and the CLI's --eval-elo-steps 1000,
# so that the eval's matches end inside a short run
PBT_EPISODE_LEN = 40
PBT_EVAL_STEPS = 50
PBT_FLAGS = ["--pbt-ensemble-size", "2", "--pbt-past-policies", "2",
             "--self-play-portion", "0.25", "--cross-play-portion", "0.5",
             "--past-play-portion", "0.25", "--pbt-update-frequency", "1",
             "--pbt-explore-lr"]
ELO_BAR = 1e-3  # rating points, cuda (atomic adds) against cpu


def pbt_build(W, team_size, steps, device, extra=()):
    """The train CLI's build with the PBT flags at episode_len
    PBT_EPISODE_LEN: (cfg, tcfg, env, mgr)."""
    import functools

    from madrona_mp_env_tpu_torch.train import train as train_cli

    args = train_cli.parse_args(
        ["--scene", SCENE, "--num-worlds", str(W), "--team-size",
         str(team_size), "--steps-per-update", str(steps),
         "--eval-elo-steps", str(PBT_EVAL_STEPS)] + PBT_FLAGS + list(extra)
        + (["--cpu"] if device == "cpu" else []))
    with mock.patch.object(train_cli, "EnvConfig", functools.partial(
            train_cli.EnvConfig, episode_len=PBT_EPISODE_LEN)):
        return train_cli.build(args)


def pbt_phase(card):
    """The PBT population at full width through the train CLI's own
    builder and its loop: Zone 6v6 on simple_map at PBT_WORLDS worlds x
    TRAIN_STEPS steps, E = 2 train and P = 2 past policies (self / cross /
    past play 0.25 / 0.5 / 0.25), --pbt-update-frequency 1, PBT_UPDATES
    updates, each followed by eval_elo (PBT_EVAL_STEPS steps),
    store_past_policy, update_population and resample_matchmaking, each
    timed by CUDA events. Every launch counter is zeroed before and read
    after: the kernels of the 6v6 path must launch. The past params must
    be bit-unchanged by each update, every slot's actor count must
    survive the rotations, the eval must finish more matches than the W
    its step-0 reset ends, and the ELOs and losses must be finite. Each
    kernel of SIMPLE_PATH must launch once per rollout and eval step
    (SIMPLE_PER_STEP times), and no other kernel at all. Then
    match_elo_parity on the last rotation's assignment."""
    import torch

    _, tcfg, env, mgr = pbt_build(PBT_WORLDS, TEAM_SIZE, TRAIN_STEPS, "cuda")
    ts = mgr.init()
    counts0 = torch.bincount(ts.assignment.reshape(-1).long(),
                             minlength=mgr.E + mgr.P)
    entries = all_entries()
    for f in entries.values():
        f.launches = 0
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
    rows = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for u in range(PBT_UPDATES):
        past0 = [{k: v.clone() for k, v in p.items()}
                 for p in ts.past_params]
        ev[0].record()
        ts, metrics = mgr.update_iter(ts)
        ev[1].record()
        ts, elo = mgr.eval_elo(ts, PBT_EVAL_STEPS)
        ev[2].record()
        ts2 = mgr.store_past_policy(ts)
        ev[3].record()
        ts3 = mgr.update_population(ts2)
        ev[4].record()
        ts4 = mgr.resample_matchmaking(ts3)
        ev[5].record()
        torch.cuda.synchronize()
        unchanged = all(torch.equal(ts.past_params[p][k], v)
                        for p, d in enumerate(past0) for k, v in d.items())
        finished = int(mgr.eval_matches)
        losses = metrics["loss"].tolist()
        if not unchanged:
            raise AssertionError(f"pbt update {u}: past params moved")
        # the reset at eval step 0 ends the W matches in progress; more
        # than W means matches reached their end inside the eval
        if finished <= PBT_WORLDS or not bool(torch.isfinite(elo).all()) \
                or not all(np.isfinite(losses)):
            raise AssertionError(f"pbt update {u}: {finished} finished "
                                 f"matches, elo {elo}, losses {losses}")
        counts = torch.bincount(ts4.assignment.reshape(-1).long(),
                                minlength=mgr.E + mgr.P)
        if not torch.equal(counts, counts0) or not torch.equal(
                ts4.env_state.policy_idx, ts4.assignment):
            raise AssertionError(f"pbt rotation {u}: slot counts {counts}")
        ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(5)]
        rows.append((ms, finished, elo.tolist(), ts4.elo.tolist(),
                     ts4.hyper_params["lr"].tolist(), ts4.past_ptr, losses))
        ts = ts4
    t1 = time.perf_counter()
    launches = {k: entries[k].launches for k in SIMPLE_PATH}
    steps = PBT_UPDATES * (TRAIN_STEPS + PBT_EVAL_STEPS)
    expect = {k: steps * SIMPLE_PER_STEP.get(k, 1) for k in SIMPLE_PATH}
    others = {k: f.launches for k, f in entries.items()
              if k not in SIMPLE_PATH and f.launches}
    if launches != expect or others:
        raise AssertionError(f"pbt: launches {launches}, expected "
                             f"{expect}; others {others}")
    samples = PBT_WORLDS * 2 * TEAM_SIZE * TRAIN_STEPS
    for u, (ms, finished, eval_elo, elo, lr, ptr, losses) in enumerate(rows):
        log(f"[pbt] update {u + 1} of {PBT_UPDATES}, {PBT_WORLDS} worlds x "
            f"{TRAIN_STEPS} steps, E = {mgr.E}, P = {mgr.P} (blocks "
            f"{mgr.BE} / {mgr.BPp} actors): update_iter {ms[0]:.1f} ms "
            f"({samples / ms[0] * 1e3:.1f} samples/s), eval_elo "
            f"{ms[1] / PBT_EVAL_STEPS:.2f} ms/step over {PBT_EVAL_STEPS} "
            f"steps ({finished} finished matches, ELO "
            + ", ".join(f"{x:.2f}" for x in eval_elo)
            + f"), store_past_policy {ms[2]:.3f} ms, update_population "
            f"{ms[3]:.3f} ms, resample_matchmaking {ms[4]:.3f} ms (CUDA "
            f"events); after them ELO "
            + ", ".join(f"{x:.2f}" for x in elo) + "; lr "
            + ", ".join(f"{x:.3g}" for x in lr)
            + f"; past_ptr {ptr}; losses "
            + ", ".join(f"{x:.5f}" for x in losses) + f" on {card}")
    log(f"[pbt] {PBT_UPDATES} updates with their PBT steps in "
        f"{t1 - t0:.2f} s; past params bit-unchanged by every update; "
        f"slot counts {counts0.tolist()} kept by every rotation; launches "
        + ", ".join(f"{k}={c} (expected {expect[k]})"
                    for k, c in launches.items()) + ", no other kernel")
    match_elo_parity(mgr, ts.assignment, card)
    del ts, mgr, env


def match_elo_parity(mgr, assignment, card):
    """The trainer's ELO fold on the card against the CPU, where the
    atomics differ: TrainingManager._match_elo on planted results of
    PBT_EVAL_STEPS steps x mgr.W worlds routed by ``assignment`` (a
    rotated table), each world finishing a match with probability
    1 / PBT_EPISODE_LEN a step, won by team 0, team 1 or drawn, from
    unequal ratings. On "cuda" index_add_ adds the deltas by atomics in
    any order, on "cpu" in index order. Bar per slot with n finished
    matches: each delta may differ by 32 x 2^-22 (expected_score's pow on
    two devices), and each sum of n float32 adds rounds by at most n x
    2^-24 x (|rating| + 32 n), for both orders."""
    import torch

    g = torch.Generator().manual_seed(7)
    T, W, n = PBT_EVAL_STEPS, mgr.W, mgr.E + mgr.P
    finished = torch.rand((T, W), generator=g) < 1.0 / PBT_EPISODE_LEN
    win = torch.where(finished, torch.randint(0, 3, (T, W), generator=g,
                                              dtype=torch.int32), -1)
    if n != 4:
        raise AssertionError(f"match elo parity: {n} slots, planted for 4")
    ratings = 1000.0 + 60.0 * torch.tensor([0.5, -1.0, 1.75, -0.25])
    a_cpu = assignment.cpu()
    want = mgr._match_elo(ratings, a_cpu, win, finished)
    got = mgr._match_elo(ratings.cuda(), assignment, win.cuda(),
                         finished.cuda()).cpu()
    team = a_cpu[:, ::mgr.cfg.team_size].expand(T, W, 2)
    per_slot = torch.bincount(team[finished].reshape(-1).long(),
                              minlength=n).double()
    bar = (per_slot * 32 * 2.0 ** -22 + 2 * per_slot * 2.0 ** -24
           * (ratings.double().abs() + 32 * per_slot))
    err = (got.double() - want.double()).abs()
    decided = int((finished & (win < 2)).sum())
    moved = float((want - ratings).abs().max())
    if decided == 0 or moved <= 1.0 or not bool((err <= bar).all()):
        raise AssertionError(f"match elo parity: {decided} decided, moved "
                             f"{moved}, err {err.tolist()} bar "
                             f"{bar.tolist()}")
    log(f"[pbt elo parity] TrainingManager._match_elo cuda vs cpu, {T} x "
        f"{W} planted results ({int(finished.sum())} finished, {decided} "
        f"decided, per slot {per_slot.long().tolist()}), ratings "
        + ", ".join(f"{x:.2f}" for x in ratings.tolist()) + " -> "
        + ", ".join(f"{x:.4f}" for x in want.tolist())
        + f": max diff {float(err.max()):.3g} rating points (bar "
        + ", ".join(f"{x:.3g}" for x in bar.tolist()) + f") on {card}")


def _record_steps(mgr):
    """Wrap mgr's env.step and apply_blocks: (steps, dists) lists that fill
    with each step's actions [W, A, 6] and match results (on the CPU) and
    each policy apply's distributions."""
    import torch

    steps, dists = [], []
    step, apply = mgr.env.step, mgr.apply_blocks

    def rec_step(state, a, *args):
        state, out = step(state, a, *args)
        res = out["episode_result"]
        steps.append((torch.stack([a.move_amount, a.move_angle, a.fire,
                                   a.stand, a.aim_yaw, a.aim_pitch],
                                  -1).cpu(), res["win_result"].cpu(),
                      res["match_finished"].cpu()))
        return state, out

    def rec_apply(*args):
        out = apply(*args)
        dists.append(out[0])
        return out

    mgr.env.step, mgr.apply_blocks = rec_step, rec_apply
    return steps, dists


def _block_margins(mgr, ts, dists, n, key=None):
    """Per step [W, A] margins (CPU) of a run from ts that applied train
    then past blocks each step: Gumbel top-two gaps from the rollout's
    step keys (``key``: ts.key) or, with None, top-two logit gaps."""
    import torch
    from madrona_mp_env_tpu_torch.utils import rng

    keys = rng.split(rng.split(key, 2)[1], n) if key is not None else None
    out = []
    for t in range(n):
        gaps = []
        for j, d in enumerate(dists[2 * t:2 * t + 2]):
            logits = torch.cat([d.discrete.packed_log_probs(),
                                d.aim.packed_log_probs()], -1) \
                if keys is not None else torch.cat(
                    [d.discrete.logits, d.aim.logits], -1)
            if keys is not None:
                gaps.append(_gumbel_margin(logits, rng.split(keys[t],
                                                             2)[j]))
            else:
                gaps.append(_gumbel_margin(logits, None))
        flat = torch.zeros(mgr.B)
        flat[ts.train_perm.reshape(-1).cpu()] = gaps[0].reshape(-1).cpu()
        flat[ts.past_perm.reshape(-1).cpu()] = gaps[1].reshape(-1).cpu()
        out.append(flat.reshape(mgr.W, mgr.A))
    return out


def _same_steps(label, a, b, margins, margin):
    """Actions equal where decided and match results exact, cuda (a)
    against cpu (b), up to the first step an action differs: (steps
    compared, undecided actors)."""
    undecided = 0
    for t, ((aa, aw, af), (ba, bw, bf)) in enumerate(zip(a, b)):
        decided = margins[t] > margin
        undecided += int((~decided).sum())
        same = (aa == ba).all(-1)
        if not bool(same[decided].all()):
            raise AssertionError(f"{label} step {t}: decided actions differ")
        if not (bool((aw == bw).all()) and bool((af == bf).all())):
            raise AssertionError(f"{label} step {t}: match results differ")
        if not bool(same.all()):
            return t + 1, undecided
    return len(a), undecided


def pbt_parity(W=8, S=4):
    """The PBT population on "cuda" against "cpu" from one seed at W
    worlds (Zone 2v2, PBT_FLAGS, S steps per update): one update_iter
    (the environment's actions, train and past actors, equal where the
    CPU run's Gumbel margin exceeds 1e-4, match results exact, up to the
    first step an action differs), eval_elo from the initial state (the
    best actions equal where the top-two logit gap exceeds 1e-4, the
    ratings within ELO_BAR rating points, the same count of finished
    matches), then store_past_policy, update_population and
    resample_matchmaking on the update's state with that ELO: the
    donors, the perturbed lr, the pointer and the tables (assignment,
    train_perm, past_perm) exact, every copy bit-equal to its donor on
    each device."""
    import torch

    runs = {}
    for dev in ("cuda", "cpu"):
        _, tcfg, env, mgr = pbt_build(W, 2, S, dev, ["--num-bptt-chunks",
                                                     "2",
                                                     "--num-minibatches",
                                                     "2"])
        steps, dists = _record_steps(mgr)
        ts0 = mgr.init()
        ts1, m = mgr.update_iter(ts0)
        roll = (list(steps), list(dists))
        steps.clear()
        dists.clear()
        _, elo = mgr.eval_elo(ts0, PBT_EVAL_STEPS)
        ev = (list(steps), list(dists), int(mgr.eval_matches))
        s = mgr.store_past_policy(dataclasses.replace(ts1, elo=elo))
        p = mgr.update_population(s)
        r = mgr.resample_matchmaking(p)
        runs[dev] = (mgr, ts0, ts1, m, roll, ev, elo, s, p, r)
    g, c = runs["cuda"], runs["cpu"]
    mc, ts0c = c[0], c[1]
    margins = _block_margins(mc, ts0c, c[4][1], S, key=ts0c.key)
    n_roll, und_roll = _same_steps("pbt parity rollout", g[4][0], c[4][0],
                                   margins, 1e-4)
    margins = _block_margins(mc, ts0c, c[5][1], PBT_EVAL_STEPS)
    n_eval, und_eval = _same_steps("pbt parity eval", g[5][0], c[5][0],
                                   margins, 1e-4)
    elo_err = float((g[6].cpu() - c[6]).abs().max())
    # once the actions part, each match either run finishes later moves
    # a rating by at most 32 (the CPU test's bound)
    late = sum(int((f & (w >= 0)).sum()) for run in (g, c)
               for _, w, f in run[5][0][n_eval:])
    elo_bar = ELO_BAR + 32.0 * late
    if elo_err > elo_bar or min(g[5][2], c[5][2]) <= W or (
            n_eval == PBT_EVAL_STEPS and g[5][2] != c[5][2]):
        raise AssertionError(f"pbt parity: eval ELO {g[6]} vs {c[6]} (bar "
                             f"{elo_bar}), finished {g[5][2]} vs {c[5][2]}")
    for name, a, b in (("store", g[7], c[7]), ("population", g[8], c[8]),
                       ("rotation", g[9], c[9])):
        for k in ("assignment", "train_perm", "past_perm", "key"):
            if not torch.equal(getattr(a, k).cpu(), getattr(b, k)):
                raise AssertionError(f"pbt parity {name}: {k} differs")
        if a.past_ptr != b.past_ptr or not torch.equal(
                a.hyper_params["lr"].cpu(), b.hyper_params["lr"]):
            raise AssertionError(f"pbt parity {name}: lr or pointer differ")
    donors = []
    for run in (g, c):
        s, p = run[7], run[8]
        src = [next(j for j in range(len(s.params)) if all(
            torch.equal(p.params[e][k], s.params[j][k]) for k in s.params[j]))
            for e in range(len(p.params))]
        donors.append(src)
    if donors[0] != donors[1]:
        raise AssertionError(f"pbt parity: donors {donors}")
    log(f"[pbt parity] cuda vs cpu, {W} worlds, E = 2, P = 2: rollout "
        f"{n_roll} of {S} steps compared ({und_roll} undecided actors), "
        f"eval {n_eval} of {PBT_EVAL_STEPS} steps ({und_eval} undecided), "
        f"{g[5][2]} / {c[5][2]} finished matches, ELO max diff {elo_err:.3g}"
        f" (bar {elo_bar}: {ELO_BAR} + 32 x {late} later matches); store, "
        f"population (donors {donors[0]}, lr "
        + ", ".join(f"{x:.6g}" for x in c[8].hyper_params["lr"].tolist())
        + ") and rotation tables exact")


# train_parity's bars by compute dtype: (the Gumbel margin that decides an
# action, values (relative), loss terms (relative, floor 1)). bf16: 4 eps
# of the dtype (2^-7): cuBLAS and the CPU round the same bf16 products
# after sums in other orders, a few roundings apart in every layer
PARITY_BARS = {"float32": (1e-4, 1e-4, 1e-4),
               "bfloat16": (2.0 ** -4, 2.0 ** -5, 2.0 ** -5)}


def train_parity(W=4, S=8, flags=()):
    """The trainer on "cuda" against "cpu" from one seed at W worlds x S
    steps (``flags``: --bf16 for the bfloat16 compute dtype), to
    PARITY_BARS: the rollouts' actions equal where the CPU run's Gumbel
    top-two margin exceeds the bar, values and rewards (1e-4) within
    their bars relative, up to the first step an action differs; then
    one PPO update of each device on the CPU rollout's data: loss terms
    within their bar * max(1, |x|), parameters within 2.5 lr (float32),
    or (bfloat16) 95% of them within 0.5 lr and all within 8.2 lr, the
    bound of 4 Adam steps that disagree in sign."""
    import torch
    from madrona_mp_env_tpu_torch.train import train as train_cli
    from madrona_mp_env_tpu_torch.utils import rng

    dtype = _dtype_of(list(flags))
    margin_bar, value_bar, loss_bar = PARITY_BARS[str(dtype)[6:]]
    runs = {}
    for dev in ("cuda", "cpu"):
        args = train_cli.parse_args([
            "--scene", SCENE, "--num-worlds", str(W), "--steps-per-update",
            str(S), "--num-bptt-chunks", "2", "--num-minibatches", "2",
            "--team-size", str(TEAM_SIZE)] + list(flags)
            + (["--cpu"] if dev == "cpu" else []))
        _, tcfg, env, mgr = train_cli.build(args)
        ts = mgr.init()
        logits = []
        apply = mgr.apply_blocks

        def rec(*a, _apply=apply, _logits=logits):
            out = _apply(*a)
            _logits.append(out[0])
            return out

        mgr.apply_blocks = rec
        ro = mgr.rollout(ts)
        mgr.apply_blocks = apply
        runs[dev] = (mgr, ts, ro, logits[:S])
    (mg, tg, (_, _, og, _), _), (mc, tc, (tc1, sc, oc, bc), lc) = (
        runs["cuda"], runs["cpu"])
    keys = rng.split(rng.split(tc.key, 2)[1], S)  # the rollout's steps
    compared, undecided = 0, 0
    worst = {}
    for t in range(S):
        margin = _gumbel_margin(torch.cat(
            [lc[t].discrete.packed_log_probs(),
             lc[t].aim.packed_log_probs()], -1),
            rng.split(keys[t], 2)[0]).reshape(-1)
        decided = margin > margin_bar
        undecided += int((~decided).sum())
        ag = og["act_pack"].reshape((S,) + og["act_pack"].shape[2:])[t]
        ac = oc["act_pack"].reshape((S,) + oc["act_pack"].shape[2:])[t]
        same = (ag.cpu() == ac).all(-1).reshape(-1)
        if not bool(same[decided].all()):
            raise AssertionError(f"train parity step {t}: decided actions "
                                 "differ")
        for k, bar in (("values", value_bar), ("rewards", 1e-4)):
            a = og[k].reshape((S, -1))[t].cpu()
            b = oc[k].reshape((S, -1))[t]
            e = float(((a - b).abs() / b.abs().clamp(min=1.0)).max())
            worst[k] = max(worst.get(k, 0.0), e)
            if e > bar:
                raise AssertionError(f"train parity step {t}: {k} {e}")
        compared = t + 1
        if not bool(same.all()):
            break
    # one PPO update of each device on the CPU rollout
    to = {k: (v.cuda() if isinstance(v, torch.Tensor)
              else {kk: vv.cuda() for kk, vv in v.items()})
          for k, v in oc.items()}
    tsg = dataclasses.replace(tg, key=tc1.key.cuda())
    ug, mgm = mg.ppo_update(tsg, sc.cuda(), to, bc.cuda())
    uc, mcm = mc.ppo_update(tc1, sc, oc, bc)
    loss_err = 0.0
    for k in mcm:
        e = float(((mgm[k].cpu() - mcm[k]).abs()
                   / mcm[k].abs().clamp(min=1.0)).max())
        loss_err = max(loss_err, e)
        if e > loss_bar:
            raise AssertionError(f"train parity: {k} rel err {e}")
    lr = mc.tcfg.lr
    dp = torch.cat([(ug.params[0][k].cpu() - v).abs().reshape(-1) / lr
                    for k, v in uc.params[0].items()])
    near = float((dp <= 0.5).double().mean())
    if dtype == torch.float32 and float(dp.max()) > 2.5:
        raise AssertionError(f"train parity: params differ by "
                             f"{float(dp.max())} lr")
    if dtype != torch.float32 and (float(dp.max()) > 8.2 or near < 0.95):
        raise AssertionError(f"train parity: params differ by up to "
                             f"{float(dp.max())} lr, {near:.4f} within 0.5")
    reduced = ""
    if dtype == torch.bfloat16:
        on = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
        reduced = (f"; cuBLAS bf16 reduced-precision reductions "
                   f"{'on' if on else 'off'}")
    log(f"[train parity {str(dtype)[6:]}] cuda vs cpu, {W} worlds x {S} "
        f"steps: {compared} steps compared, actions equal where decided "
        f"(margin {margin_bar:.3g}; {undecided} undecided), values max rel "
        f"err {worst['values']:.3g}, rewards {worst['rewards']:.3g}; PPO "
        f"update on one rollout: loss terms max rel err {loss_err:.3g} (bar "
        f"{loss_bar:.3g}), params max abs diff {float(dp.max()):.3g} lr, "
        f"{near:.4f} within 0.5 lr{reduced}")

# the game modes (phase 11): 1024 worlds of team size 6 on simple_map,
# StaggerStarts | RandomFlipTeams and each configuration's own settings;
# name: (EnvConfig settings, K1 launches a step, K5 launches a step, the
# module whose K1 launch has a shape of its own)
MODE_STEPS = 20  # cut from 50, then 30, for the whole run's time
MODE_TOWN_STEPS = 20
MODE_BASE_FLAGS = ("StaggerStarts", "RandomFlipTeams")
MODE_CONFIGS = {
    "TDM": (dict(task="TDM"), 1, 0, None),
    "ZoneCaptureDefend": (dict(task="ZoneCaptureDefend",
                               flags=("HardcodedSpawns",)), 1, 0, None),
    "Turret": (dict(task="Turret"), 2, 0, "turret"),
    "Explore": (dict(task="Explore", flags=("NavmeshSpawn",)), 1, 0, None),
    "Zone Flank": (dict(task="Zone", reward_mode="Flank"), 2, 0,
                   "observations"),
    "Zone SubZones": (dict(task="Zone", flags=("SubZones",)), 1, 0, None),
    "TDM highlevel_move": (dict(task="TDM", highlevel_move=True), 1, 0,
                           "hl_battle"),
    "Zone RandomizeHPMagazine": (dict(task="Zone",
                                      flags=("RandomizeHPMagazine",)),
                                 1, 1, None),
}
# the modules whose K1 launch has a shape of its own: the row's label
K1_SITES = {"turret": "turret LOS", "hl_battle": "hl_battle LOS",
            "observations": "Flank LOS refresh"}
# the train CLI's game modes other than Zone (phase 8 trains Zone)
MODE_TRAIN = ("TDM", "ZoneCaptureDefend", "Turret", "Explore")
# their updates hold losses and moving parameters, not rates: 8 steps (4
# BPTT chunks of 2), cut from TRAIN_STEPS for the run's time
MODE_TRAIN_STEPS = 8


def shared_env(mt, cfg, scene, maps):
    """An Env of NUM_WORLDS worlds on the card that shares the map an
    earlier configuration of the same map_key loaded; ``maps`` keeps
    them."""
    from madrona_mp_env_tpu_torch.assets.map_data import map_key

    key = map_key(scene, cfg)
    env = mt.Env(cfg, scene, num_worlds=NUM_WORLDS, seed=5, device="cuda",
                 map_data=maps.get(key))
    maps[key] = env.map_data
    return env


def mode_cfg(mt, spec, team_size=TEAM_SIZE):
    fl = mt.SimFlags.Default
    for f in MODE_BASE_FLAGS + spec.get("flags", ()):
        fl |= getattr(mt.SimFlags, f)
    return mt.EnvConfig(
        task=getattr(mt.Task, spec["task"]), sim_flags=fl,
        reward_mode=getattr(mt.RewardMode, spec.get("reward_mode",
                                                    "Default")),
        highlevel_move=spec.get("highlevel_move", False),
        team_size=team_size)


def capture_k1(env, state, actions):
    """One env.step with K1's entry wrapped in each module that calls it:
    {module: [(o, d) of each call]} (tensors cloned)."""
    import importlib

    calls = {}
    saved = []
    for site in ("combat",) + tuple(K1_SITES):
        mod = importlib.import_module(f"madrona_mp_env_tpu_torch.sim.{site}")
        fn = mod.ray_vs_tris
        calls[site] = []

        def rec(o, d, soup, _fn=fn, _site=site):
            calls[_site].append((o.clone(), d.clone()))
            return _fn(o, d, soup)

        saved.append((mod, fn))
        mod.ray_vs_tris = rec
    try:
        env.step(state, actions)
    finally:
        for mod, fn in saved:
            mod.ray_vs_tris = fn
    return calls


def k1_row(ph, label, o, d):
    """K1 on one launch of a new shape: bit-equal (int32 views) to its
    plain version (over chunks of rays), its time and its bound."""
    from madrona_mp_env_tpu_torch.ops import raycast

    soup = ph.soup
    R = o[..., 0].numel()
    o2, d2 = o.reshape(R, 3), d.reshape(R, 3)

    def kernel():
        return raycast.ray_vs_tris(o, d, soup)

    def plain():
        return chunked(lambda s: raycast._ray_vs_tris_dense(
            o2[s], d2[s], soup), R, max(1024, 2 ** 22 // soup.num_tris)
        ).reshape(o.shape[:-1])

    err = check_equal(f"K1 ray_vs_tris ({label})", (kernel(), plain()))
    return ph.record(
        f"K1 ray_vs_tris ({label})",
        "madrona_mp_env_tpu_torch/csrc/ray_tris.cu",
        "madrona_mp_env_tpu/ops/raycast_pallas.py:111", raycast.ray_vs_tris,
        err, cuda_time_ms(kernel, 50), cuda_time_ms(plain, 3),
        R * 28 + ph.T_real * 40, R * ph.T_real * OPS_RAY_TRI,
        [list(o.shape[:-1])],
        split=raycast.ray_split(soup.num_tris, R,
                                raycast._sm_count(o.device)))


def k6_row(ph, calls):
    """K6 on a step's fans (town_map Flank's 48-ray LOS run): bit-equal
    (int32 views) to its plain version, its time and its bound."""
    from madrona_mp_env_tpu_torch.ops import raycast

    soup = ph.soup
    (org, zgf, dirf, zgroups, cells, tables, _), = calls["ray_fans_culled"]
    N, G = zgf.shape
    F = dirf[0].shape[-1]

    def kernel():
        return raycast.ray_fans_culled(org, zgf, dirf, zgroups, cells,
                                       tables, soup)

    def plain():
        return chunked(lambda s: raycast._ray_fans_culled_plain(
            org[s], zgf[s], tuple(c[s] for c in dirf), zgroups, cells[s],
            tables, soup), N, 256)

    err = check_equal("K6 ray_fans_culled", (kernel(), plain()))
    n_valid = int((tables.cand_idx >= 0).sum(-1)[cells.long()].sum())
    return ph.record(
        "K6 ray_fans_culled", "madrona_mp_env_tpu_torch/csrc/fan_culled.cu",
        "madrona_mp_env_tpu/ops/raycast_pallas.py:465",
        raycast.ray_fans_culled, err, cuda_time_ms(kernel, 10),
        cuda_time_ms(plain, 1),
        N * (16 + 4 * G) + 3 * N * F * 4 + tables.cand_idx.numel() * 4
        + ph.T_real * 40 + N * F * 4,
        n_valid * F * OPS_FAN_PAIR + n_valid * G * OPS_FAN_HOIST,
        [[N, F, tables.K]])


def k2_row(ph, calls):
    """K2 on a step's fans (Flank's 128-ray fans on simple_map): bit-equal
    (int32 views) to its plain version, its time and its bound."""
    from madrona_mp_env_tpu_torch.ops import raycast

    soup = ph.soup
    (org, zgf, dirf, zgroups, _), = calls["ray_fans_vs_tris"]
    N, G = zgf.shape
    F = dirf[0].shape[-1]

    def kernel():
        return raycast.ray_fans_vs_tris(org, zgf, dirf, zgroups, soup)

    def plain():
        return chunked(lambda s: raycast._ray_fans_dense(
            org[s], zgf[s], tuple(c[s] for c in dirf), zgroups, soup), N,
            max(16, 2 ** 18 // soup.num_tris))

    err = check_equal("K2 ray_fans_vs_tris", (kernel(), plain()))
    return ph.record(
        "K2 ray_fans_vs_tris", "madrona_mp_env_tpu_torch/csrc/fan_tris.cu",
        "madrona_mp_env_tpu/ops/raycast_pallas.py:383",
        raycast.ray_fans_vs_tris, err, cuda_time_ms(kernel, 10),
        cuda_time_ms(plain, 1),
        N * (12 + 4 * G) + 3 * N * F * 4 + ph.T_real * 40 + N * F * 4,
        N * F * ph.T_real * OPS_FAN_PAIR + N * G * ph.T_real * OPS_FAN_HOIST,
        [[N, F, soup.num_tris]])


def k3_row(ph, calls):
    """K3 on a step's fans (Flank's 128 rays a fan): t and capsule index
    bit-equal (int32 views) to its plain version, its time and its bound
    from the pairs that reach a root (cap_roots)."""
    from madrona_mp_env_tpu_torch.ops import raycast_cull

    (pos, zg, dirs, zgroups, alive), = calls["fan_capsules"]
    W, A, G = zg.shape
    F = dirs[0].shape[-1]

    def kernel():
        return raycast_cull.fan_capsules(pos, zg, dirs, zgroups, alive)

    def plain():
        return chunked(lambda s: raycast_cull._fan_capsules_plain(
            pos[s], zg[s], tuple(c[s] for c in dirs), zgroups, alive[s]),
            W, 128)

    (tk, ik), ((tp, ip), pms) = kernel(), timed_once(plain)
    err = check_equal("K3 fan_capsules", (tk, tp), (ik, ip))
    pairs, cyl, sph = (sum(x) for x in zip(*(
        cap_roots(pos[s], zg[s], tuple(c[s] for c in dirs), zgroups,
                  alive[s]) for s in chunks(W, 64))))
    return ph.record(
        "K3 fan_capsules", "madrona_mp_env_tpu_torch/csrc/fan_capsules.cu",
        "madrona_mp_env_tpu/ops/raycast_cull.py:120",
        raycast_cull.fan_capsules, err, cuda_time_ms(kernel, 50), pms,
        W * A * 16 + W * A * G * 4 + W * A * F * 12 + F * 4 + W * A * F * 8,
        pairs * OPS_CAP_PAIR + cyl * OPS_CAP_CYL + sph * OPS_CAP_SPHERE
        + W * A * G * A * OPS_CAP_HOIST + W * A * F * OPS_CAP_RAY,
        [[W, A, F, G]], root_share=round((cyl + sph) / (3 * pairs), 4))


def mode_expect(k1, k5, steps, town=False):
    """Exact launches of every kernel entry on a game mode's path: reset +
    ``steps`` steps."""
    fan = "ray_fans_culled" if town else "ray_fans_vs_tris"
    expect = {"ray_vs_tris": k1 * steps, fan: steps + 1,
              "fan_capsules": steps + 1, "sphere_cast_culled": steps,
              "sphere_cast_packed": 3 * steps, "tail_fused": k5 * steps}
    if town:
        expect["fan_cell_order"] = steps + 1
    return expect


MODE_PROFILE_STEPS = 5


def launches_per_step(env, state, actions, step=None):
    """CUDA device operations per env step (or ``step``, e.g.
    env.replay_step with a step log for ``actions``) over
    MODE_PROFILE_STEPS steps (torch.profiler tracing the device alone:
    the host's op events cost seconds a step to gather), after one step
    unprofiled. Steps where a world resets add the reset's launches, so
    the count is a mean."""
    import torch

    step = step or env.step
    state, _ = step(state, actions)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(MODE_PROFILE_STEPS):
            state, _ = step(state, actions)
        torch.cuda.synchronize()
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        raise AssertionError("the profiler saw no CUDA kernels")
    return len(dev) / MODE_PROFILE_STEPS


MODE_NOT_LAUNCHED = ("sphere_cast", "ray_fans_culled_v9",
                     "ray_fans_vs_tris_flat", "apply_velocity_fall_fused")


def modes_phase(mt, card):
    """Every game mode and flag on the card (Env(device="cuda"), 1024
    worlds, team size 6): for each of MODE_CONFIGS, K1 at its new shape
    (the turret's and hl_battle's LOS, W * A * ts rays; Flank's LOS
    refresh, W * A * 8 ts) bit-equal to its plain version with its time
    and bound, and on Flank the sensor fans' 48-ray LOS run through K2
    and K3 (KernelPhase's checks); reset + MODE_STEPS steps of bench.py's
    actions with every launch counter zeroed before and read after, each
    kernel held to its count (K1 once a step, twice with a turret or a
    Flank refresh; K5 only on the flags configuration); env-steps/s and
    CUDA launches per step (torch.profiler). Then Zone + Flank on
    town_map (MODE_TOWN_STEPS steps, K6 on the 48-ray run, held to its
    plain version); each configuration's 4-world, 16-step rollout on
    "cuda" against "cpu" (phase 9's bars); one train-CLI update at 1024
    worlds x MODE_TRAIN_STEPS steps of each game mode of MODE_TRAIN.
    Returns the new
    kernel rows."""
    import torch

    t_start = time.perf_counter()
    rows, maps = [], {}
    simple_entries = ("ray_vs_tris", "ray_fans_vs_tris", "fan_capsules",
                      "sphere_cast_culled", "sphere_cast_packed")
    for label, (spec, k1, k5, site) in MODE_CONFIGS.items():
        cfg = mode_cfg(mt, spec)
        env = shared_env(mt, cfg, SCENE, maps)
        acts = bench_actions(NUM_WORLDS, cfg.num_agents, MODE_STEPS)
        ph = KernelPhase(env.map_data.tris, f"simple_map {label}")
        state, _ = env.reset()
        a0 = actions_at(env, acts, 0)
        mine = []
        if site is not None:
            calls = capture_k1(env, state, a0)
            n = {k: len(v) for k, v in calls.items()}
            # hl_battle replaces the hitscan; the others add to it
            if n[site] != 1 or n["combat"] != int(site != "hl_battle"):
                raise AssertionError(f"{label}: K1 calls {n}")
            (o, d), = calls[site]
            mine.append(k1_row(ph, K1_SITES[site], o, d))
        if label == "Zone Flank":
            expect = simple_entries + ("tail_fused",) * k5
            fan_calls = capture_step_calls(env, state, a0, expect)
            zgroups = fan_calls["ray_fans_vs_tris"][0][3]
            if zgroups[0] != 8 * TEAM_SIZE:
                raise AssertionError(f"Flank LOS run {zgroups[0]}")
            mine += [k2_row(ph, fan_calls), k3_row(ph, fan_calls)]
        del state
        state, out, sps = drive_path(
            f"{label} simple_map", env, acts, MODE_STEPS, mine,
            MODE_NOT_LAUNCHED + ("ray_fans_culled", "fan_cell_order"),
            card, expect=mode_expect(k1, k5, MODE_STEPS))
        # SubZones' first reward after a world's reset is NaN, as the JAX
        # package's (an infinite approach distance times the blend's 0)
        r = out["reward"]
        if label == "Zone SubZones":
            r = torch.nan_to_num(r, nan=0.0, posinf=np.inf, neginf=-np.inf)
        if not bool(torch.isfinite(r).all()):
            raise AssertionError(f"{label}: non-finite rewards")
        per_step = launches_per_step(env, state, a0)
        log(f"[modes] {label}: {sps:.1f} env-steps/s, {per_step:.1f} CUDA "
            f"launches per step (torch.profiler, {MODE_PROFILE_STEPS} "
            f"steps) at {NUM_WORLDS} worlds on {card}; "
            f"{time.perf_counter() - t_start:.1f} s into the phase")
        rows += mine
        del env, state, out

    # Zone + Flank on town_map: K6 on the 48-ray LOS run
    spec, k1, k5, _ = MODE_CONFIGS["Zone Flank"]
    cfg = mode_cfg(mt, spec)
    env = shared_env(mt, cfg, TOWN, maps)
    acts = bench_actions(NUM_WORLDS, cfg.num_agents, MODE_TOWN_STEPS)
    ph = KernelPhase(env.map_data.tris, "town_map Zone Flank")
    state, _ = env.reset()
    a0 = actions_at(env, acts, 0)
    calls = capture_k1(env, state, a0)
    (o, d), = calls["observations"]
    k1_row(ph, K1_SITES["observations"], o, d)
    fan_calls = capture_step_calls(
        env, state, a0, ("ray_vs_tris", "ray_fans_culled", "fan_capsules",
                         "sphere_cast_culled", "sphere_cast_packed"))
    k6_row(ph, fan_calls)
    del state
    drive_path("Zone Flank town_map", env, acts, MODE_TOWN_STEPS,
               ph.results, MODE_NOT_LAUNCHED + ("ray_fans_vs_tris",), card,
               expect=mode_expect(k1, k5, MODE_TOWN_STEPS, town=True))
    rows += ph.results
    del env, maps
    t_town = time.perf_counter()

    # the kernel path against the plain path, each configuration
    for label, (spec, *_) in MODE_CONFIGS.items():
        env_parity(mt, mode_cfg(mt, spec), SCENE, 4, 16, label=label,
                   graze=True)
    t_parity = time.perf_counter()

    # one update of the train CLI per game mode
    for mode in MODE_TRAIN:
        train_run(mode, SCENE, TEAM_SIZE, "0", 1, "ray_fans_vs_tris", [],
                  card, extra=["--game-mode", mode], steps=MODE_TRAIN_STEPS)
    t_end = time.perf_counter()
    log(f"[modes] phase {t_end - t_start:.1f} s: paths to the town path "
        f"{t_town - t_start:.1f}, parity {t_parity - t_town:.1f}, training "
        f"{t_end - t_parity:.1f}")
    return rows


# phase 12: the full-team interface and its policy, the LearnShooting
# world curriculum with K5's override and the spawn curriculum, 1024
# worlds of Zone 6v6 with StaggerStarts | RandomFlipTeams
FT_STEPS = 50
FT_TOWN_STEPS = 20
FT_SEQ_STEPS = 40  # the sequence forward + backward: the trainer's 40
FT_SEQ_TEAMS = 512  # teams a minibatch (the trainer's 4 minibatches)
CURR_STEPS = 50
# EnableCurriculum's episodes cut to 40 steps (EnvConfig's default is
# consts.episode_len), so that every world resets inside the path: the
# first reset draws one curriculum for every world (the same step key:
# the JAX package's too), the later resets each world's own
CURR_EPISODE_LEN = 40
# the full-team observations compared cuda against cpu (1e-3, as "self"):
# the continuous ones; the enemies' and last-known tables hold sight
# flags, which a graze may flip
FT_PARITY_KEYS = ("full_team_players", "full_team_global",
                  "full_team_reward")
# cuda against cpu for the full-team network's outputs: cuDNN's and the
# CPU's convolution sums and the minimap's atomic adds (index_add_) add
# in other orders, a few float32 roundings apart
FT_NET_BAR = 1e-4
FT_NET_MARGIN = 1e-4  # actions compared where the Gumbel margin exceeds it
# the configurations of the phase (mode_cfg specs; the spawn curriculum's
# EnvConfig fields beside them)
CURRICULUM_CONFIGS = {
    "FullTeamPolicy": dict(task="Zone", flags=("FullTeamPolicy",)),
    "EnableCurriculum": dict(task="Zone", flags=("EnableCurriculum",),
                             episode_len=CURR_EPISODE_LEN),
    "spawn curriculum": dict(task="Zone"),
}


def curriculum_cfg(mt, label, **kw):
    spec = dict(CURRICULUM_CONFIGS[label])
    kw.setdefault("episode_len", spec.pop("episode_len",
                                          mt.EnvConfig.episode_len))
    if label == "spawn curriculum":
        kw.setdefault("enable_spawn_curriculum", True)
    return dataclasses.replace(mode_cfg(mt, spec), **kw)


def team_sums(r, ts):
    """[W, A] -> [W, 2]: each team's members summed in index order."""
    r = r.reshape(r.shape[0], 2, ts)
    total = r[..., 0]
    for k in range(1, ts):
        total = total + r[..., k]
    return total


def full_team_paths(mt, card):
    """FullTeamPolicy Zone 6v6 on each map (FT_STEPS, FT_TOWN_STEPS):
    every counter zeroed before and read after, each kernel held to its
    count (K1, K4 culled and K5 once a step, K2 or K6 and K3 once a step
    and at the reset, K4' three times a step: the 6v6 path's, no more),
    the full-team observations finite, the team reward the sum of its
    members' and done their all; env-steps/s and CUDA launches per step.
    Returns the simple_map Env and its last state."""
    import torch

    cfg = curriculum_cfg(mt, "FullTeamPolicy")
    kept = None
    for scene, steps in ((SCENE, FT_STEPS), (TOWN, FT_TOWN_STEPS)):
        town = scene == TOWN
        name = os.path.basename(scene)
        env = mt.Env(cfg, scene, num_worlds=NUM_WORLDS, seed=5,
                     device="cuda")
        acts = bench_actions(NUM_WORLDS, cfg.num_agents, steps)
        fan = ("ray_fans_vs_tris",) if town else ("ray_fans_culled",
                                                  "fan_cell_order")
        state, out, sps = drive_path(
            f"FullTeamPolicy {name}", env, acts, steps, [],
            MODE_NOT_LAUNCHED + fan, card,
            expect=mode_expect(1, 1, steps, town=town))
        ob = out["obs"]
        if not (torch.equal(ob["full_team_reward"],
                            team_sums(out["reward"], TEAM_SIZE))
                and torch.equal(ob["full_team_done"], (out["done"].reshape(
                    NUM_WORLDS, 2, TEAM_SIZE) != 0).all(-1).int())):
            raise AssertionError(f"FullTeamPolicy {name}: team reward or "
                                 "done is not its members'")
        per_step = launches_per_step(env, state, actions_at(env, acts, 0))
        log(f"[full team] {name}: {sps:.1f} env-steps/s, {per_step:.1f} "
            f"CUDA launches per step (torch.profiler, {MODE_PROFILE_STEPS} "
            f"steps) at {NUM_WORLDS} worlds, the team reward and done its "
            f"members' on {card}; obs "
            + ", ".join(f"{k} {tuple(v.shape)}" for k, v in ob.items()
                        if k.startswith("full_team")))
        if not town:
            kept = env, state, ob
        del out
    return kept


def _ft_loss(lp, ent, vals):
    return ((lp["discrete"] + lp["aim"]).mean()
            + 0.01 * (ent["discrete"] + ent["aim"]).mean()
            + 0.5 * (vals * vals).mean())


def full_team_policy_phase(mt, env, state, obs, card):
    """FullTeamActorCriticNet at full width (embeddings 64, LSTM 256,
    minimap 16 x 16, team size 6; weights from a seed) driving the
    FullTeamPolicy env on 2 x NUM_WORLDS teams for FT_SEQ_STEPS steps:
    the forward's ms per step (CUDA events), then one sequence forward +
    backward over those steps (in minibatches of FT_SEQ_TEAMS teams), in
    float32 and in bfloat16; finite gradients."""
    import torch
    from madrona_mp_env_tpu_torch.train import full_team_policy as ftp
    from madrona_mp_env_tpu_torch.utils import rng

    dev = env.device
    B = 2 * NUM_WORLDS
    net = ftp.build_full_team_policy(TEAM_SIZE, seed=0, device=dev)
    key0 = rng.prng_key(11, device=dev)
    rnn = ftp.init_team_rnn_states((B,), device=dev)
    seq_obs, seq_acts, seq_done = [], [], []
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    fwd_ms = []
    for s in range(FT_SEQ_STEPS):
        tob = ftp.team_obs(obs)
        with torch.no_grad():
            ev[0].record()
            dists, value, rnn = net(rnn, tob)
            ev[1].record()
            actions, _ = dists.sample(rng.fold_in(key0, s))
        torch.cuda.synchronize()
        fwd_ms.append(ev[0].elapsed_time(ev[1]))
        seq_obs.append(tob)
        seq_acts.append(actions)
        state, out = env.step(state, ftp.env_actions(actions,
                                                     env.zero_actions()))
        obs = out["obs"]
        seq_done.append(obs["full_team_done"].reshape(B))
    if not bool(torch.isfinite(value).all()):
        raise AssertionError("full-team policy: non-finite values")
    obs_t = {k: torch.stack([o[k] for o in seq_obs]) for k in seq_obs[0]}
    acts_t = {k: torch.stack([a[k] for a in seq_acts]) for k in seq_acts[0]}
    dones = torch.stack(seq_done)
    start = ftp.init_team_rnn_states((B,), device=dev)
    sd = {k: v.detach().clone() for k, v in net.state_dict().items()}
    for dtype in (torch.float32, torch.bfloat16):
        m = ftp.build_full_team_policy(TEAM_SIZE, state_dict=sd, device=dev,
                                       dtype=dtype)
        rnn = ftp.init_team_rnn_states((B,), device=dev)
        ms = []
        with torch.no_grad():
            for s in range(FT_SEQ_STEPS):
                tob = {k: v[s] for k, v in obs_t.items()}
                ev[0].record()
                _, _, rnn = m(rnn, tob)
                ev[1].record()
                torch.cuda.synchronize()
                ms.append(ev[0].elapsed_time(ev[1]))
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        ev[0].record()
        for sl in chunks(B, FT_SEQ_TEAMS):
            lp, ent, vals = m.sequence(
                start[:, :, sl], dones[:, sl],
                {k: v[:, sl] for k, v in obs_t.items()},
                {k: v[:, sl] for k, v in acts_t.items()})
            _ft_loss(lp, ent, vals).backward()
        ev[1].record()
        torch.cuda.synchronize()
        seq_ms = ev[0].elapsed_time(ev[1])
        grads = [p.grad for p in m.parameters()]
        if any(g is None or not bool(torch.isfinite(g).all())
               for g in grads):
            raise AssertionError(f"full-team policy {dtype}: gradients "
                                 "missing or non-finite")
        steady = ms[1:]
        log(f"[full team policy] {str(dtype)[6:]}, {B} teams of "
            f"{TEAM_SIZE}, embeddings {ftp.EMBED_CH}, LSTM "
            f"{ftp.TEAM_RNN_HIDDEN}, minimap {ftp.MINIMAP_RES}^2: forward "
            f"{np.mean(steady):.3f} ms/step (min {min(steady):.3f}, first "
            f"{ms[0]:.3f}; driving the env: "
            f"{np.mean(fwd_ms[1:]):.3f} in float32); sequence forward + "
            f"backward over {FT_SEQ_STEPS} steps in {B // FT_SEQ_TEAMS} "
            f"minibatches of {FT_SEQ_TEAMS} teams {seq_ms:.1f} ms, peak "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; "
            f"gradients finite (CUDA events) on {card}")
        del m, grads
    del obs_t, acts_t, seq_obs, seq_acts


def k5_ls_row(ph, calls, ls_share):
    """K5's LearnShooting instantiation on a step's tail with both
    curricula present: every output bit-equal (int32 views) to the plain
    version, its time, device time, registers and bound (the step's K5
    bytes and one int32 more per world)."""
    from madrona_mp_env_tpu_torch.ops import cuda_build, tail_fused

    (cfg5, m5, st5, fr5), = calls["tail_fused"]
    wc = st5.world_curriculum
    if not (bool((wc == 0).any()) and bool((wc == 1).any())):
        raise AssertionError("the captured step lacks one curriculum")

    def kernel():
        return tail_fused.tail_fused(cfg5, m5, st5, fr5)

    def plain():
        return tail_fused.tail_fused_plain(cfg5, m5, st5, fr5)

    out, (want, pms) = kernel(), timed_once(plain)
    err = check_tail("K5 tail_fused LearnShooting", out, want)
    ms = cuda_time_ms(kernel, 200)
    ins, outs = tail_fused.kernel_operands(cfg5, m5, st5, fr5)
    W5, A5 = st5.hp.shape
    ts5 = cfg5.team_size
    lanes = 16 if A5 <= 16 else 32
    regs, spill = cuda_build.ptxas_usage(
        "tail_fused", f"tail_fused_kernelILi{lanes}ELb1E")
    n_ls = int((wc == 0).sum())
    # the step's K5 operations, and the override's subtraction per agent
    # of a LearnShooting world
    nops = (W5 * A5 * (OPS_TAIL_AGENT + 2 * (ts5 - 1) + 5 * (ts5 - 2))
            + n_ls * A5)
    return ph.record(
        "K5 tail_fused LearnShooting",
        "madrona_mp_env_tpu_torch/csrc/tail_fused.cu",
        "madrona_mp_env_tpu/ops/tail_pallas.py:330", tail_fused.tail_fused,
        err, ms, pms,
        k5_bytes(cfg5, ins, outs), nops,
        [[W5, A5]],
        device_ms=device_ms(kernel, "tail_fused_kernel", 20),
        fmad_floor_ms=round(nops / PEAK_F32_INSNS * 1e3, 4),
        registers=regs, spill_bytes=spill, helper_launches=0,
        ls_share=round(ls_share, 4))


def curriculum_path(mt, card):
    """EnableCurriculum Zone 6v6 on simple_map (episodes of
    CURR_EPISODE_LEN steps): reset + CURR_STEPS steps with every counter
    zeroed before and read after, each kernel held to its count; the
    share of LearnShooting worlds; then the K5 LearnShooting row on the
    next step's tail, where both curricula are present. Returns the row,
    its launches those of the path."""
    from madrona_mp_env_tpu_torch.ops import tail_fused

    cfg = curriculum_cfg(mt, "EnableCurriculum")
    env = mt.Env(cfg, SCENE, num_worlds=NUM_WORLDS, seed=5, device="cuda")
    acts = bench_actions(NUM_WORLDS, cfg.num_agents, CURR_STEPS + 1)
    label = "EnableCurriculum simple_map"
    state, out, sps = drive_path(
        label, env, acts, CURR_STEPS, [],
        MODE_NOT_LAUNCHED + ("ray_fans_culled", "fan_cell_order"), card,
        expect=mode_expect(1, 1, CURR_STEPS))
    launches = tail_fused.tail_fused.launches
    share = float((state.world_curriculum == 0).float().mean())
    resets = int(state.episode_counter.min())
    calls = capture_step_calls(env, state,
                               actions_at(env, acts, CURR_STEPS),
                               SIMPLE_ENTRIES)
    row = k5_ls_row(KernelPhase(env.map_data.tris, "simple_map"), calls,
                    share)
    row.update(launches=launches, path=label)
    log(f"[curriculum] {label}: LearnShooting worlds {share:.4f} of "
        f"{NUM_WORLDS} after {CURR_STEPS} steps (every world's episode "
        f"counter at least {resets}, episodes of {CURR_EPISODE_LEN} "
        f"steps); "
        f"{sps:.1f} env-steps/s on {card}")
    return row


def spawn_curriculum_phase(mt, card):
    """On each map: the spawn-curriculum tables' build time, cold (a fresh
    cache directory) and from the cache, then for each tier (a one-hot
    curriculum_tier_probs, every episode on the curriculum) a reset of
    NUM_WORLDS worlds sharing one loaded map, and the mean distance
    between the two teams' centroids (x, y)."""
    import shutil
    import torch
    from madrona_mp_env_tpu_torch.assets import formats, navmesh
    from madrona_mp_env_tpu_torch.assets import spawn_curriculum as psc

    tmp = os.path.join(REPO, "build", "spawn_curriculum_smoke")
    for scene in (SCENE, TOWN):
        name = os.path.basename(scene)
        nav = navmesh.build_navmesh_tables(
            formats.load_navmesh(os.path.join(scene, "navmesh.bin")))
        shutil.rmtree(tmp, ignore_errors=True)
        t0 = time.perf_counter()
        sc = psc.build_spawn_curriculum(nav, cache_dir=tmp)
        t1 = time.perf_counter()
        psc.build_spawn_curriculum(nav, cache_dir=tmp)
        t2 = time.perf_counter()
        shutil.rmtree(tmp, ignore_errors=True)
        cfg = curriculum_cfg(mt, "spawn curriculum")
        seps, maps = [], {}
        for tier in range(psc.NUM_TIERS):
            cfg_t = dataclasses.replace(cfg, curriculum_tier_probs=tuple(
                float(t == tier) for t in range(psc.NUM_TIERS)))
            env_t = shared_env(mt, cfg_t, scene, maps)
            state, obs = env_t.reset()
            if not (bool(state.curr_spawn_active.all())
                    and bool((state.curr_spawn_tier == tier).all())):
                raise AssertionError(f"spawn curriculum {name} tier {tier}:"
                                     " draws off the tier")
            for k, x in obs.items():
                if not bool(torch.isfinite(x).all()):
                    raise AssertionError(f"spawn curriculum {name}: "
                                         f"non-finite {k}")
            c = state.pos[..., :2].reshape(NUM_WORLDS, 2, TEAM_SIZE, 2)
            sep = torch.linalg.vector_norm(c[:, 0].mean(1) - c[:, 1].mean(1),
                                           dim=-1)
            seps.append(float(sep.mean()))
            del env_t, state, obs
        log(f"[spawn curriculum] {name}: tables ({sc.num_spawns.tolist()} "
            f"pairs a tier) built in {t1 - t0:.3f} s cold, {t2 - t1:.4f} s "
            f"from the cache (host); mean team separation at reset over "
            f"{NUM_WORLDS} worlds by tier (target "
            + ", ".join(f"{x:.0f}" for x in psc.TIER_SEPARATIONS) + "): "
            + ", ".join(f"{x:.1f}" for x in seps) + f" on {card}")
        del maps


def ft_net_parity(mt, W=4, S=8):
    """The full-team policy (weights from a seed) on the observations of
    a W-world, S-step CPU rollout of the FullTeamPolicy env, on "cuda"
    against "cpu": the forward's logits, values and recurrent state at
    every step and the sequence's log probs, entropies and values within
    FT_NET_BAR * max(1, |x|), sampled actions equal where the Gumbel
    margin exceeds FT_NET_MARGIN."""
    import torch
    from madrona_mp_env_tpu_torch.train import full_team_policy as ftp
    from madrona_mp_env_tpu_torch.utils import rng

    cfg = curriculum_cfg(mt, "FullTeamPolicy")
    env = mt.Env(cfg, SCENE, num_worlds=W, seed=5, device="cpu")
    acts = bench_actions(W, cfg.num_agents, S)
    state, obs = env.reset()
    seq = []
    for s in range(S):
        seq.append(ftp.team_obs(obs))
        state, out = env.step(state, actions_at(env, acts, s))
        obs = out["obs"]
    B = 2 * W
    nets = {d: ftp.build_full_team_policy(TEAM_SIZE, seed=0, device=d)
            for d in ("cpu", "cuda")}
    res = {}
    for d, net in nets.items():
        rnn = ftp.init_team_rnn_states((B,), device=d)
        outs, margins, sampled = [], [], []
        with torch.no_grad():
            for s, tob in enumerate(seq):
                key = rng.fold_in(rng.prng_key(3, device=d), s)
                dists, v, rnn = net(rnn, {k: x.to(d) for k, x in
                                          tob.items()})
                a, _ = dists.sample(key)
                outs.append(torch.cat([dists.discrete.logits.flatten(),
                                       dists.aim.logits.flatten(),
                                       v, rnn.flatten()]).cpu())
                margins.append(_gumbel_margin(torch.cat(
                    [dists.discrete.packed_log_probs(),
                     dists.aim.packed_log_probs()], -1), key).cpu())
                sampled.append(torch.cat([a["discrete"], a["aim"]],
                                         -1).cpu())
            ob_t = {k: torch.stack([o[k] for o in seq]).to(d)
                    for k in seq[0]}
            act_t = {"discrete": torch.stack([x[..., :4] for x in sampled
                                              ]).to(d),
                     "aim": torch.stack([x[..., 4:] for x in sampled]
                                        ).to(d)}
            lp, ent, vals = net.sequence(
                ftp.init_team_rnn_states((B,), device=d),
                torch.zeros(S, B, dtype=torch.int32, device=d), ob_t, act_t)
        res[d] = dict(step=torch.stack(outs), margin=torch.stack(margins),
                      actions=torch.stack(sampled),
                      seq=torch.cat([x.flatten() for x in (
                          lp["discrete"], lp["aim"], ent["discrete"],
                          ent["aim"], vals)]).cpu())
    worst = {}
    for k in ("step", "seq"):
        a, b = res["cuda"][k], res["cpu"][k]
        e = float(((a - b).abs() / b.abs().clamp(min=1.0)).max())
        worst[k] = e
        if e > FT_NET_BAR:
            raise AssertionError(f"full-team net {k}: cuda vs cpu rel err "
                                 f"{e}")
    decided = torch.minimum(res["cuda"]["margin"], res["cpu"]["margin"]
                            ) > FT_NET_MARGIN
    ga, gb = res["cuda"]["actions"], res["cpu"]["actions"]
    if not torch.equal(ga[decided], gb[decided]):
        raise AssertionError("full-team net: decided actions differ cuda "
                             "vs cpu")
    log(f"[parity] full-team policy cuda vs cpu, {W} worlds x {S} steps: "
        f"forward max rel err {worst['step']:.3g}, sequence "
        f"{worst['seq']:.3g} (bar {FT_NET_BAR}), actions equal where "
        f"decided ({int((~decided).sum())} of {decided.numel()} "
        f"undecided at {FT_NET_MARGIN})")


def curriculum_phase(mt, card):
    """Phase 12: the EnableCurriculum path with its K5 row, the
    FullTeamPolicy paths and the full-team policy, the spawn curriculum on
    each map, then each configuration's 4-world, 16-step rollout on "cuda"
    against "cpu" (phase 9's bars, the full-team observations within
    1e-3) and the full-team network's. Returns the new kernel rows."""
    # the K5 row first: after the full-team policy's phase in a whole run,
    # torch.profiler has traced no CUDA event at all
    t0 = time.perf_counter()
    row = curriculum_path(mt, card)
    t1 = time.perf_counter()
    env, state, obs = full_team_paths(mt, card)
    full_team_policy_phase(mt, env, state, obs, card)
    del env, state, obs
    t2 = time.perf_counter()
    spawn_curriculum_phase(mt, card)
    t3 = time.perf_counter()
    for label in CURRICULUM_CONFIGS:
        cfg = curriculum_cfg(mt, label)
        env_parity(mt, cfg, SCENE, 4, 16, label=label, graze=True,
                   obs_keys=FT_PARITY_KEYS if label == "FullTeamPolicy"
                   else ())
    ft_net_parity(mt)
    t4 = time.perf_counter()
    log(f"[curriculum] phase {t4 - t0:.1f} s: EnableCurriculum "
        f"{t1 - t0:.1f}, full team {t2 - t1:.1f}, spawn curriculum "
        f"{t3 - t2:.1f}, parity {t4 - t3:.1f}")
    return [row]


# phase 13: the logging step, replay, the eval's dumps and the trajectory
# curriculum, 1024 worlds of Zone 6v6 with StaggerStarts | RandomFlipTeams
LOG_STEPS = 20  # cut from 30 for the whole run's time
LOG_CHUNK = 10  # steps a writer copy takes (the eval's chunk_steps)
LOG_GROUPS = ("step_log", "snapshot", "game_events")
# the eval CLI's dumps, reductions of its --num-steps 200: the record and
# the event log over LOG_STEPS, the behaviour-cloning dump (~150 MB a step
# at 1024 worlds) over CLI_BC_STEPS
CLI_BC_STEPS = 5
# the DB's trajectories, cut to the LOG_STEPS-step run: windows of
# CURR_WINDOW match steps (any events), every CURR_SUBSAMPLE-th step a
# snapshot (build_trajectory_curriculum's defaults: 100 and 20)
CURR_WINDOW = 20
CURR_SUBSAMPLE = 5
CURR_MAX_WINDOWS = 64
CURR_PROB = 0.5
# the snapshot's int16 fields cuda against cpu: the pos bar of phase 9
LOG_POS_BAR = 1e-4
# the restore's leaves held exact cuda against cpu
RESTORE_KEYS = ("pos", "yaw", "pitch", "hp", "mag_bullets", "mag_reloading",
                "stand_cur", "stand_tgt", "stand_transition", "cur_step",
                "zone_cur", "zone_controlling", "zone_captured",
                "zone_steps_remaining", "zone_steps_until_point", "team_a")


def stack_outs(outs):
    """A list of steps' {group: {key: tensor}} -> {group: {key: [T, ...]}}."""
    import torch

    return {g: {k: torch.stack([o[g][k] for o in outs]) for k in outs[0][g]}
            for g in LOG_GROUPS}


def logging_path(label, env, acts, steps, out_dir, card, expect,
                 not_launched):
    """Reset + ``steps`` steps of the logging ``env`` (collect_log) with
    every counter zeroed before and read after, each kernel held to
    ``expect``; the exports go through the writers in chunks of LOG_CHUNK
    steps (one device-to-host copy a chunk and group) into ``out_dir``.
    Returns (env-steps/s with the writers, writer stats {name: (s, bytes,
    steps)})."""
    import torch
    from madrona_mp_env_tpu_torch.data import EventLogWriter, RecordLogWriter

    entries = zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = env.reset()
    t_reset = time.perf_counter()
    with RecordLogWriter(os.path.join(out_dir, "record.bin")) as rw, \
            EventLogWriter(os.path.join(out_dir, "events")) as ew:
        chunk = []
        for s in range(steps):
            state, out = env.step(state, actions_at(env, acts, s))
            chunk.append({g: out[g] for g in LOG_GROUPS})
            if len(chunk) == LOG_CHUNK or s == steps - 1:
                c = stack_outs(chunk)
                rw.append_chunk(c["step_log"])
                ew.append_chunk(c["snapshot"], c["game_events"])
                chunk = []
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    for name, x in out["obs"].items():
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"{label}: non-finite obs {name}")
    counts = check_counts(label, entries, [], not_launched, expect)
    sps = env.num_worlds * steps / (t1 - t_reset)
    stats = {w: (x.seconds, x.bytes_written, x.steps)
             for w, x in (("record", rw), ("event log", ew))}
    log(f"[{label}] {env.num_worlds} worlds x {steps} steps: reset "
        f"{t_reset - t0:.3f} s, steps and writers {t1 - t_reset:.3f} s, "
        f"{sps:.1f} env-steps/s on {card}; writers' host ms and bytes per "
        "step: " + ", ".join(f"{w} {s * 1e3 / n:.3f} ms {b / n:.0f} B"
                             for w, (s, b, n) in stats.items())
        + "; launches " + ", ".join(f"{n}={c}" for n, c in counts.items()))
    return sps, stats


def replay_path(label, env, out_dir, card, expect, not_launched, rows):
    """Env.replay_step over the record in ``out_dir`` from a reset, every
    counter zeroed before and read after (``rows``: the replay's kernel
    rows, which get its launches): each kernel held to ``expect``, the
    replayed match-state stream equal to the recorded snapshots'.
    Returns (the env's last state, the last step log, env-steps/s)."""
    import torch
    from madrona_mp_env_tpu_torch.data import (ReplayLogReader,
                                               read_step_snapshots)

    W = env.num_worlds
    reader = ReplayLogReader(os.path.join(out_dir, "record.bin"), W)
    logs = reader.tensors(env.device)
    recorded = read_step_snapshots(os.path.join(out_dir, "events"))
    recorded = recorded["match_state"].reshape(len(reader), W)
    fields = (("step", "match_step"), ("cur_zone", "cur_zone"),
              ("cur_zone_controller", "cur_zone_controller"),
              ("zone_steps_remaining", "zone_steps_remaining"),
              ("steps_until_point", "steps_until_point"))
    entries = zero_counts()
    torch.cuda.synchronize()
    state, _ = env.reset()
    t0 = time.perf_counter()
    replayed = []
    for t in range(len(reader)):
        log_t = {k: v[t] for k, v in logs.items()}
        state, out = env.replay_step(state, log_t)
        replayed.append(torch.stack([out["snapshot"][k].to(torch.int64)
                                     for _, k in fields]))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    check_counts(label, entries, rows, not_launched, expect)
    got = torch.stack(replayed).cpu().numpy()
    for j, (field, _) in enumerate(fields):
        want = recorded[field]
        if not np.array_equal(got[:, j].astype(want.dtype), want):
            n = int((got[:, j].astype(want.dtype) != want).sum())
            raise AssertionError(f"{label}: replayed {field} differs from "
                                 f"the recorded one at {n} of {want.size}")
    sps = W * len(reader) / (t1 - t0)
    log(f"[{label}] {W} worlds x {len(reader)} replayed steps: {sps:.1f} "
        f"env-steps/s on {card}; the match-state stream equals the "
        "recorded snapshots'")
    return state, log_t, sps


def snapshot_parity(name, got, want, floats):
    """Snapshots cuda (``got``) against cpu (``want``), numpy [T, W, ...]
    each: every field exact, but an int16 field may be one count off where
    its cpu float (``floats``: {field: [T, W, ...]}) sits within
    LOG_POS_BAR * max(1, |x|) of an integer (the truncation's edge).
    Returns (fields near an edge, fields one count off)."""
    near = off = 0
    for k, w in want.items():
        g = got[k]
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{name} {k}: {g.dtype}{g.shape} vs "
                                 f"{w.dtype}{w.shape}")
        diff = np.abs(g.astype(np.int64) - w.astype(np.int64))
        if k in floats:
            f = floats[k].astype(np.float64)
            edge = (np.abs(f - np.round(f))
                    <= LOG_POS_BAR * np.maximum(1.0, np.abs(f)))
            near += int(edge.sum())
            off += int((diff == 1).sum())
            bad = (diff > 1) | ((diff == 1) & ~edge)
        else:
            bad = diff != 0
        if bad.any():
            raise AssertionError(f"{name} {k}: {int(bad.sum())} of {w.size} "
                                 f"differ cuda vs cpu")
    return near, off


def float_parity(name, got, want, rel):
    """Floats within rel * max(1, |x|), NaN and infinities at the same
    places; returns the max relative error."""
    if not np.array_equal(np.isfinite(got), np.isfinite(want)) or \
            not np.array_equal(got[~np.isfinite(got)],
                               want[~np.isfinite(want)]):
        raise AssertionError(f"{name}: non-finite values differ")
    fin = np.isfinite(want)
    e = (np.abs(got[fin].astype(np.float64) - want[fin])
         / np.maximum(1.0, np.abs(want[fin].astype(np.float64))))
    worst = float(e.max()) if e.size else 0.0
    if worst > rel:
        raise AssertionError(f"{name}: rel err {worst}")
    return worst


def log_parity(mt, cfg, scene, W=4, S=16):
    """A W-world, S-step logging rollout on "cuda" against "cpu" from one
    seed: step log, snapshot and events exact (the step log's floats to
    phase 9's pos bar, an int16 snapshot field one count off only at a
    truncation edge, snapshot_parity); then the cpu record replayed on both
    devices: snapshots and events the same way, "self" and the forward
    lidar within 1e-3 * max(1, |x|), reward within 1e-4."""
    import torch
    from madrona_mp_env_tpu_torch.data.recorder import host_arrays

    name = f"{os.path.basename(scene)} logging"
    scale = 32768.0 / np.pi
    runs = {}
    for dev in ("cuda", "cpu"):
        env = mt.Env(cfg, scene, num_worlds=W, seed=5, device=dev,
                     collect_log=True)
        acts = bench_actions(W, cfg.num_agents, S)
        state, _ = env.reset()
        outs = []
        for s in range(S):
            state, out = env.step(state, actions_at(env, acts, s))
            outs.append({g: out[g] for g in LOG_GROUPS})
        runs[dev] = {g: host_arrays(v) for g, v in stack_outs(outs).items()}
    gpu, cpu = runs["cuda"], runs["cpu"]
    worst = {}
    for k, w in cpu["step_log"].items():
        g = gpu["step_log"][k]
        if w.dtype.kind == "f" and k != "hp":
            worst[k] = float_parity(f"{name} step_log {k}", g, w, LOG_POS_BAR)
        elif not np.array_equal(g, w):
            raise AssertionError(f"{name} step_log {k} differs cuda vs cpu")
    for k, w in cpu["game_events"].items():
        if not np.array_equal(gpu["game_events"][k], w):
            raise AssertionError(f"{name} game_events {k} differs cuda vs "
                                 "cpu")
    sl = cpu["step_log"]
    # the live players' floats (the padded rows are 0 on both devices)
    live = np.arange(sl["pos"].shape[2]) < cfg.num_agents
    floats = {k: np.where(live.reshape((1, 1, -1) + (1,) * (v.ndim - 3)),
                          v, np.nan)
              for k, v in (("player_pos", sl["pos"]),
                           ("player_yaw", sl["aim_yaw"] * scale),
                           ("player_pitch", sl["aim_pitch"] * scale))}
    near, off = snapshot_parity(f"{name} snapshot", gpu["snapshot"],
                                cpu["snapshot"], floats)

    # the cpu record replayed on both devices
    reps = {}
    for dev in ("cuda", "cpu"):
        env = mt.Env(cfg, scene, num_worlds=W, seed=5, device=dev)
        state, _ = env.reset()
        outs = []
        for t in range(S):
            state, out = env.replay_step(
                state, {k: v[t] for k, v in sl.items()})
            outs.append({**{f"snapshot/{k}": v
                            for k, v in out["snapshot"].items()},
                         **{f"game_events/{k}": v
                            for k, v in out["game_events"].items()},
                         "self": out["obs"]["self"],
                         "fwd_lidar": out["obs"]["fwd_lidar"],
                         "reward": out["reward"]})
        reps[dev] = host_arrays({k: torch.stack([o[k] for o in outs])
                                 for k in outs[0]})
    rg, rc = reps["cuda"], reps["cpu"]
    for k, w in rc.items():
        if k.startswith("game_events/") and not np.array_equal(rg[k], w):
            raise AssertionError(f"{name} replay {k} differs")
    r_near, r_off = snapshot_parity(
        f"{name} replay snapshot",
        {k[9:]: v for k, v in rg.items() if k.startswith("snapshot/")},
        {k[9:]: v for k, v in rc.items() if k.startswith("snapshot/")},
        floats)
    for k, rel in (("self", 1e-3), ("fwd_lidar", 1e-3), ("reward", 1e-4)):
        worst["replay " + k] = float_parity(f"{name} replay {k}", rg[k],
                                            rc[k], rel)
    log(f"[parity] {name} cuda vs cpu, {W} worlds x {S} steps: step log, "
        f"snapshot and events exact but floats ("
        + ", ".join(f"{k} max rel err {v:.3g}" for k, v in worst.items())
        + f"); int16 snapshot fields at a truncation edge: {near} (one "
        f"count off: {off}), in the replay {r_near} ({r_off})")


def seeded_policy_npz(mt, path, W):
    """An export_policy.py-layout .npz of P = EVAL_POLICIES seeded policies
    (tests/fixtures_torch/policy_weights.py, numpy alone) with eval_setup's
    seeded normalizer stats, for the eval CLI."""
    sys.path.insert(0, os.path.join(REPO, "tests", "fixtures_torch"))
    from policy_weights import random_flax_params
    from madrona_mp_env_tpu_torch.train.convert import flatten

    _, _, norm, _ = eval_setup(mt, W, 1, 1, "cuda")
    tree = {"params": random_flax_params(0, EVAL_POLICIES),
            "normalizer": {
                "mu": {k: v.cpu().numpy() for k, v in norm.mu.items()},
                "var": {k: v.cpu().numpy() for k, v in norm.var.items()},
                "count": norm.count.cpu().numpy()},
            "elo": np.full(EVAL_POLICIES, 1500.0, np.float32)}
    np.savez(path, **flatten(tree))


def eval_cli_dumps(mt, card, tmp):
    """The eval CLI on the card at 1024 worlds: --record and --event-log
    over LOG_STEPS steps, --bc-dump-dir over CLI_BC_STEPS; each dump's
    host ms and bytes per step (mgr.dump_stats) and its files' sizes."""
    from madrona_mp_env_tpu_torch.train import infer

    npz = os.path.join(tmp, "policy.npz")
    # the normalizer's stats are per observation key: 4 worlds give them
    seeded_policy_npz(mt, npz, 4)
    base = ["--num-worlds", str(NUM_WORLDS), "--ckpt-path", npz]
    runs = (
        ["--num-steps", str(LOG_STEPS), "--record",
         os.path.join(tmp, "cli_record.bin"), "--event-log",
         os.path.join(tmp, "cli_events")],
        ["--num-steps", str(CLI_BC_STEPS), "--bc-dump-dir",
         os.path.join(tmp, "cli_bc")],
    )
    for extra in runs:
        t0 = time.perf_counter()
        mgr, elo = infer.main(base + extra)
        wall = time.perf_counter() - t0
        stats = mgr.dump_stats
        # the eval runs whole chunks (chunk_steps), as the JAX eval does
        ecfg = mgr.ecfg
        steps = -(-ecfg.num_eval_steps // ecfg.chunk_steps) * ecfg.chunk_steps
        if not stats or any(s["steps"] != steps for s in stats.values()):
            raise AssertionError(f"eval CLI {extra}: dumps {stats}")
        if not np.isfinite(elo.cpu().numpy()).all():
            raise AssertionError("eval CLI: non-finite ELO")
        dumps = " ".join(extra[2::2])
        log(f"[eval CLI] {NUM_WORLDS} worlds, --num-steps "
            f"{ecfg.num_eval_steps} ({steps} steps run: whole chunks of "
            f"{ecfg.chunk_steps}), {dumps}: {wall:.1f} s "
            "(the policies' load and the Env's included); "
            + ", ".join(f"{n} {s['seconds'] * 1e3 / s['steps']:.2f} host ms "
                        f"and {s['bytes'] / s['steps']:.0f} bytes per step"
                        for n, s in stats.items()) + f" on {card}")
        del mgr


def curriculum_files(out_dir, tmp):
    """build_db -> select_windows -> build_curriculum on the logging
    path's event log: (the curriculum file, its snapshots), each tool's
    host seconds logged."""
    from madrona_mp_env_tpu_torch.data import build_db
    from madrona_mp_env_tpu_torch.data.build_trajectory_curriculum import (
        build_curriculum)
    from madrona_mp_env_tpu_torch.data.select_trajectories import (
        select_windows)
    from madrona_mp_env_tpu_torch.data.trajectory_db import write_dump_items

    db = os.path.join(tmp, "analytics.db")
    t0 = time.perf_counter()
    n_matches, n_steps = build_db.build_db(os.path.join(out_dir, "events"),
                                           db)
    t1 = time.perf_counter()
    sid, tid = select_windows(db, 0, CURR_WINDOW, CURR_MAX_WINDOWS)
    dump = os.path.join(tmp, "trajectories.bin")
    write_dump_items(dump, sid, tid)
    t2 = time.perf_counter()
    curr = os.path.join(tmp, "curriculum.bin")
    n = build_curriculum(db, dump, curr, CURR_WINDOW, CURR_SUBSAMPLE)
    t3 = time.perf_counter()
    if not n:
        raise AssertionError("the curriculum has no snapshot")
    log(f"[curriculum file] build_db {n_matches} matches, {n_steps} steps "
        f"in {t1 - t0:.2f} s; select_windows {len(sid) // CURR_WINDOW} "
        f"windows of {CURR_WINDOW} in {t2 - t1:.2f} s; "
        f"build_curriculum {n} snapshots in {t3 - t2:.2f} s (host)")
    return curr, n


def restore_phase(mt, cfg, curr, n_snap, plain_env, card):
    """Env(curriculum_path, trajectory_curriculum_prob=CURR_PROB) at 1024
    worlds: the share of worlds the reset restored (those whose players
    left the plain reset's positions) within 4 sigma of CURR_PROB; reset +
    LOG_STEPS steps with each 6v6 kernel held to its count, K5 included;
    then the restored reset at 4 worlds (prob 1) cuda against cpu, exact."""
    import torch

    ccfg = dataclasses.replace(cfg, trajectory_curriculum_prob=CURR_PROB)
    env = mt.Env(ccfg, SCENE, num_worlds=NUM_WORLDS, seed=5, device="cuda",
                 curriculum_path=curr)
    if env.map_data.num_curriculum_snapshots != n_snap:
        raise AssertionError("the curriculum's snapshots did not load")
    state, _ = env.reset()
    plain, _ = plain_env.reset()
    restored = (state.pos != plain.pos).any(-1).any(-1)
    share = float(restored.float().mean())
    sigma = (CURR_PROB * (1 - CURR_PROB) / NUM_WORLDS) ** 0.5
    if abs(share - CURR_PROB) > 4 * sigma:
        raise AssertionError(f"restored share {share} is not within 4 sigma "
                             f"of {CURR_PROB}")
    del state, plain
    acts = bench_actions(NUM_WORLDS, cfg.num_agents, LOG_STEPS)
    _, _, sps = drive_path(
        "trajectory curriculum simple_map", env, acts, LOG_STEPS, [],
        MODE_NOT_LAUNCHED + ("ray_fans_culled", "fan_cell_order"), card,
        expect=mode_expect(1, 1, LOG_STEPS))
    del env
    leaves = {}
    for dev in ("cuda", "cpu"):
        e = mt.Env(dataclasses.replace(cfg, trajectory_curriculum_prob=1.0),
                   SCENE, num_worlds=4, seed=5, device=dev,
                   curriculum_path=curr)
        st, _ = e.reset()
        leaves[dev] = {k: getattr(st, k).cpu() for k in RESTORE_KEYS}
    for k in RESTORE_KEYS:
        g, w = leaves["cuda"][k], leaves["cpu"][k]
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        if not torch.equal(g, w):
            raise AssertionError(f"restored reset {k} differs cuda vs cpu")
    log(f"[curriculum] {n_snap} snapshots, trajectory_curriculum_prob "
        f"{CURR_PROB}: {share:.4f} of {NUM_WORLDS} worlds restored at the "
        f"reset (4 sigma {4 * sigma:.4f}); {sps:.1f} env-steps/s over "
        f"{LOG_STEPS} steps on {card}; the restored reset at 4 worlds "
        "bit-equal cuda vs cpu")


def record_phase(mt, cfg, card):
    """Phase 13 on each map: the logging step (reset + LOG_STEPS steps,
    every counter zeroed before and read after; K1, K3, K4 culled, 3 K4'
    a step and K2 or K6 with its cell order, K5 never) against the same
    steps without logging (env-steps/s, CUDA launches per step); the
    replay of its record (K2 and K3 once a replayed step, K3 and the
    step's fan route at the reset, no other kernel; K2 and K3 on the
    replay's launches held to their plain versions; the match-state
    stream equal to the recorded one); then the
    4-world logging rollout and replay cuda against cpu. Then the eval
    CLI's dumps, the curriculum file from the simple_map event log, and
    the trajectory-curriculum restore. Returns the new kernel rows."""
    import shutil
    import tempfile

    t_start = time.perf_counter()
    rows = []
    tmp = tempfile.mkdtemp(prefix="chip_smoke_record_")
    try:
        plain_simple = None
        for scene in (SCENE, TOWN):
            town = scene == TOWN
            name = os.path.basename(scene)
            out_dir = os.path.join(tmp, name)
            os.makedirs(out_dir)
            env = mt.Env(cfg, scene, num_worlds=NUM_WORLDS, seed=5,
                         device="cuda", collect_log=True)
            plain = mt.Env(cfg, scene, num_worlds=NUM_WORLDS, seed=5,
                           device="cuda", map_data=env.map_data)
            acts = bench_actions(NUM_WORLDS, cfg.num_agents, LOG_STEPS)
            fan = ("ray_fans_vs_tris",) if town else ("ray_fans_culled",
                                                      "fan_cell_order")
            log_sps, _ = logging_path(
                f"logging {name}", env, acts, LOG_STEPS, out_dir, card,
                mode_expect(1, 0, LOG_STEPS, town=town),
                MODE_NOT_LAUNCHED + fan)
            state, _, plain_sps = drive_path(
                f"not logging {name}", plain, acts, LOG_STEPS, [],
                MODE_NOT_LAUNCHED + fan, card,
                expect=mode_expect(1, 1, LOG_STEPS, town=town))
            a0 = actions_at(env, acts, 0)
            per_log = launches_per_step(env, state, a0)
            per_plain = launches_per_step(plain, state, a0)

            # the replay: K2 and K3 on its launches against their plain
            # versions, then the path
            ph = KernelPhase(env.map_data.tris, f"{name} replay")
            from madrona_mp_env_tpu_torch.data import ReplayLogReader

            logs = ReplayLogReader(os.path.join(out_dir, "record.bin"),
                                   NUM_WORLDS).tensors(env.device)
            st, _ = env.reset()
            log0 = {k: v[0] for k, v in logs.items()}
            calls = capture_step_calls(env, st, log0,
                                       ("ray_fans_vs_tris", "fan_capsules"),
                                       step=env.replay_step)
            mine = [k2_row(ph, calls), k3_row(ph, calls)]
            del st, calls, logs
            # the reset's observations take the step's route (K6 and its
            # cell order on town_map); every replayed step K2
            n = LOG_STEPS
            state, log_t, rep_sps = replay_path(
                f"replay {name}", env, out_dir, card,
                {"ray_fans_vs_tris": n + (not town), "fan_capsules": n + 1,
                 "ray_vs_tris": 0, "sphere_cast_culled": 0,
                 "sphere_cast_packed": 0, "tail_fused": 0,
                 "ray_fans_culled": int(town), "fan_cell_order": int(town)},
                MODE_NOT_LAUNCHED, mine)
            per_rep = launches_per_step(env, state, log_t,
                                        step=env.replay_step)
            rows += mine
            log(f"[record] {name}: {NUM_WORLDS} worlds, CUDA launches per "
                f"step (torch.profiler, {MODE_PROFILE_STEPS} steps) "
                f"{per_log:.1f} logging, {per_plain:.1f} not logging, "
                f"{per_rep:.1f} replaying; env-steps/s {log_sps:.1f} logging "
                f"(writers included), {plain_sps:.1f} not, {rep_sps:.1f} "
                f"replaying, on {card}; "
                f"{time.perf_counter() - t_start:.1f} s into the phase")
            del env, state, log_t
            if town:
                del plain
            else:
                plain_simple = plain
        t_paths = time.perf_counter()
        for scene in (SCENE, TOWN):
            log_parity(mt, cfg, scene)
        t_parity = time.perf_counter()
        eval_cli_dumps(mt, card, tmp)
        t_cli = time.perf_counter()
        curr, n_snap = curriculum_files(os.path.join(tmp, "simple_map"), tmp)
        restore_phase(mt, cfg, curr, n_snap, plain_simple, card)
        del plain_simple
        t_end = time.perf_counter()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[record] phase {t_end - t_start:.1f} s: logging and replay paths "
        f"{t_paths - t_start:.1f}, parity {t_parity - t_paths:.1f}, eval "
        f"CLI {t_cli - t_parity:.1f}, curriculum {t_end - t_cli:.1f}")
    return rows


# phase 14: behaviour cloning end to end and the attention backbone, 1024
# worlds of Zone 6v6 on simple_map: one eval CLI run with --event-log and
# --bc-dump-dir (the DB's join needs both from one run), the DB and its
# token tools, the trajectory training sets, train/bc.py on both layouts,
# PPO resumed from BC's checkpoint
BC_STEPS = 20  # the eval CLI's --num-steps: two chunks of 10
BC_WINDOWS = 32  # select_windows' max: the BC set's trajectories
BC_LR = 1e-4  # the CLI's default 0.01 overshoots from Adam's first steps
BC_MB = 2048  # the CLI's default minibatch
BC_RUNS = [(flags, kl) for flags in ([], ["--bf16"]) for kl in (0.0, 0.1)]
# the PPO update resumed from BC: a reduction of the trainer's 40 steps
BC_PPO_STEPS = 10
# the attention policy at the rollout's shapes: one step of W x A agents,
# a sequence of ATTN_SEQ_STEPS x ATTN_SEQ_ROWS; cuda against cpu at
# ATTN_PARITY (worlds, steps)
ATTN_SEQ_STEPS = 40
ATTN_SEQ_ROWS = 2048
ATTN_PARITY = (4, 8)


def dir_bytes(path):
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))


def bc_eval_cli(mt, tmp, card):
    """The eval CLI at NUM_WORLDS worlds x BC_STEPS steps with --event-log
    and --bc-dump-dir, every counter zeroed before and read after: the
    logging step's counts (K1, K4 culled and 3 K4' a step, K2 and K3 once
    a step and at the reset, K5 never). Returns (event log dir, dump
    dir)."""
    import torch
    from madrona_mp_env_tpu_torch.train import infer

    npz = os.path.join(tmp, "policy.npz")
    seeded_policy_npz(mt, npz, 4)
    events, dump = os.path.join(tmp, "events"), os.path.join(tmp, "dump")
    entries = zero_counts()
    t0 = time.perf_counter()
    mgr, elo = infer.main(["--num-worlds", str(NUM_WORLDS), "--ckpt-path",
                           npz, "--num-steps", str(BC_STEPS), "--event-log",
                           events, "--bc-dump-dir", dump])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check_counts("eval CLI --event-log --bc-dump-dir", entries, [],
                 MODE_NOT_LAUNCHED + ("ray_fans_culled", "fan_cell_order"),
                 mode_expect(1, 0, BC_STEPS))
    stats = mgr.dump_stats
    if {s["steps"] for s in stats.values()} != {BC_STEPS}:
        raise AssertionError(f"eval CLI dumps: {stats}")
    if not np.isfinite(elo.cpu().numpy()).all():
        raise AssertionError("eval CLI: non-finite ELO")
    log(f"[bc] eval CLI {NUM_WORLDS} worlds x {BC_STEPS} steps with "
        f"--event-log and --bc-dump-dir: {wall:.1f} s (the policies' load "
        "and the Env's included); "
        + ", ".join(f"{n} {s['seconds'] * 1e3 / s['steps']:.2f} host ms and "
                    f"{s['bytes'] / s['steps']:.0f} bytes per step"
                    for n, s in stats.items()) + f" on {card}")
    del mgr
    return events, dump


def bc_tools(events, dump, tmp):
    """build_db -> tokenize_steps -> ngrams -> select_windows ->
    build_trajectory_training_dataset, each tool's host seconds logged.
    Returns (BC set dir, KL set dir)."""
    from madrona_mp_env_tpu_torch.data import build_db
    from madrona_mp_env_tpu_torch.data.select_trajectories import (
        select_windows)
    from madrona_mp_env_tpu_torch.data.trajectory_db import write_dump_items
    from madrona_mp_env_tpu_torch.tools import (
        build_trajectory_training_dataset as btd, ngrams, tokenize_steps)

    db = os.path.join(tmp, "analytics.db")
    items = os.path.join(tmp, "items.bin")
    sets = os.path.join(tmp, "bc_set"), os.path.join(tmp, "kl_set")
    t = [time.perf_counter()]
    n_matches, n_steps = build_db.build_db(events, db)
    t.append(time.perf_counter())
    n_tokens = tokenize_steps.tokenize(db, verbose=False)
    t.append(time.perf_counter())
    n_grams, top = ngrams.top_ngrams(db)
    t.append(time.perf_counter())
    sid, tid = select_windows(db, 0, btd.SEQ_LEN, BC_WINDOWS)
    write_dump_items(items, sid, tid)
    t.append(time.perf_counter())
    btd.build(db, items, dump, *sets, NUM_WORLDS, team_size=TEAM_SIZE)
    t.append(time.perf_counter())
    rows = [os.path.getsize(os.path.join(d, "rewards")) // 4 for d in sets]
    trajs = [r // (btd.SEQ_LEN * TEAM_SIZE) for r in rows]
    if trajs[0] != BC_WINDOWS or trajs[1] < 1:
        raise AssertionError(f"trajectory sets: {trajs} trajectories")
    dt = [b - a for a, b in zip(t, t[1:])]
    log(f"[bc tools] build_db {n_matches} matches, {n_steps} steps in "
        f"{dt[0]:.2f} s; tokenize_steps {n_tokens} tokens in {dt[1]:.2f} s; "
        f"ngrams {n_grams} 5-grams ({len(top)} distinct in the top) in "
        f"{dt[2]:.2f} s; select_windows {len(sid) // btd.SEQ_LEN} windows of "
        f"{btd.SEQ_LEN} in {dt[3]:.2f} s; the training sets in {dt[4]:.2f} s "
        f"(host): BC {trajs[0]} trajectories ({dir_bytes(sets[0])} bytes), "
        f"KL {trajs[1]} ({dir_bytes(sets[1])} bytes)")
    return sets


def bc_runs(dump, blocks, sets, ckpts, card):
    """bc.main (1 epoch, minibatch BC_MB, --lr BC_LR) on the step-block
    dump (``blocks``: its load_bc_data on the card) and on the sequences
    set, in float32 and --bf16, each with kl_coef 0 and 0.1, from the
    save_ckpt file ``<ckpts>/seeded/0.pt``: each minibatch's bc_loss
    finite, and each policy's loss on the epoch's first minibatch lower
    after the epoch than before it. Returns the path of the first run's
    output checkpoint."""
    import torch
    from madrona_mp_env_tpu_torch.train import ActorCriticNet, bc
    from madrona_mp_env_tpu_torch.utils import rng

    first = None
    for layout, data_dir in (("step blocks", dump), ("sequences", sets[0])):
        data = blocks if data_dir == dump else bc.load_bc_data(data_dir,
                                                               "cuda")
        N = data["actions"].shape[0]
        for flags, kl in BC_RUNS:
            name = (f"bc_{layout.split()[0]}_{'bf16' if flags else 'f32'}_"
                    f"kl{kl}")
            run = bc.main([
                "--ckpt-dir", ckpts, "--in-run-name", "seeded",
                "--out-run-name", name, "--start-update", "0",
                "--bc-data-dir", data_dir, "--kl-data-dir", sets[1],
                "--kl-coef", str(kl), "--lr", str(BC_LR), "--num-epochs",
                "1", "--minibatch-size", str(BC_MB)] + flags)
            first = first or run.path
            E = len(run.params)
            per_e = N // E
            mb = min(BC_MB, per_e)
            # the epoch's first minibatch again, with the trained params
            _, sub = rng.split(rng.prng_key(7, device="cuda"), 2)
            idx = rng.permutation(sub, N).reshape(E, per_e)[:, :mb]
            model = ActorCriticNet(
                torch.bfloat16 if flags else torch.float32).cuda()
            with torch.no_grad():
                after = np.array([float(bc.bc_loss(
                    model, run.params[e], bc.gather(data, idx[e]), kl)[1])
                    for e in range(E)])
            before = run.losses[0, 0]
            if not (np.isfinite(run.losses).all() and np.isfinite(after).all()
                    and (after < before).all()):
                raise AssertionError(f"bc {name}: losses {run.losses}, the "
                                     f"first minibatch after {after}")
            num_mb = run.losses.shape[1]
            log(f"[bc] {name}: {N} samples, E = {E}, {num_mb} minibatches of "
                f"{mb} a policy; "
                f"{run.epoch_seconds[0] * 1e3 / num_mb:.2f} ms per minibatch "
                f"update (E policies); bc_loss first {before.mean():.4f}, "
                f"last {run.losses[0, -1].mean():.4f}, the first minibatch "
                f"after the epoch {after.mean():.4f} on {card}")
        del data
    return first


def attention_phase(data, card):
    """ActorCriticNet(use_attention=True) beside ActorCriticNet() (seeded
    weights) on the eval dump's observations (``data``: its load_bc_data
    on the card): one forward step of
    NUM_WORLDS x 12 agents and the sequence forward + backward over
    ATTN_SEQ_STEPS x ATTN_SEQ_ROWS, in float32 and bfloat16, by CUDA
    events; then the attention policy cuda against cpu over ATTN_PARITY's
    worlds and steps (forward and sequence) within FT_NET_BAR."""
    import torch
    from madrona_mp_env_tpu_torch.train import (build_actor_critic,
                                                init_rnn_states)

    B = NUM_WORLDS * 2 * TEAM_SIZE
    T, R = ATTN_SEQ_STEPS, ATTN_SEQ_ROWS
    acts = data["actions"][:T * R].reshape(T, R, 6)
    acts = {"discrete": acts[..., :4], "aim": acts[..., 4:]}
    dones = torch.zeros(T, R, device="cuda")
    times = {}
    for dt in (torch.float32, torch.bfloat16):
        step_obs = {k: v[:B].to(dt) for k, v in data["obs"].items()}
        seq_obs = {k: v[:T * R].reshape((T, R) + v.shape[1:]).to(dt)
                   for k, v in data["obs"].items()}
        for attn in (True, False):
            net = build_actor_critic(seed=0, device="cuda", dtype=dt,
                                     use_attention=attn)
            rnn = init_rnn_states((B,), device="cuda")

            def fwd():
                with torch.no_grad():
                    return net(rnn, step_obs)

            net.requires_grad_(True)
            start = init_rnn_states((R,), device="cuda")

            def seq():
                lp, ent, v = net.sequence(start, dones, seq_obs, acts)
                loss = (lp["discrete"].sum() + lp["aim"].sum() + v.sum())
                loss.backward()
                net.zero_grad(set_to_none=True)
                if not bool(torch.isfinite(loss)):
                    raise AssertionError("attention: non-finite sequence")

            times[(str(dt)[6:], attn)] = (cuda_time_ms(fwd, 5),
                                          cuda_time_ms(seq, 2))
            del net
    # ATTN_PARITY's worlds (the first rows of each step) and steps
    W, S = ATTN_PARITY
    rows = (torch.arange(S, device="cuda")[:, None] * B
            + torch.arange(W * 2 * TEAM_SIZE, device="cuda")).reshape(-1)
    parity = ({k: v[rows].cpu() for k, v in data["obs"].items()},
              data["actions"][rows].cpu())
    log(f"[attention] {B} agents one step / {T} x {R} sequence fwd + bwd "
        "(CUDA events), attention against MaxPoolNet: "
        + "; ".join(f"{dt} {'attention' if a else 'maxpool'} forward "
                    f"{f:.3f} ms, sequence {s:.2f} ms"
                    for (dt, a), (f, s) in times.items()) + f" on {card}")
    attention_parity(*parity)


def attention_parity(obs, actions):
    """The attention policy (weights from a seed) cuda against cpu on
    ATTN_PARITY's observations ``obs`` and ``actions`` (rows [S * n, ...],
    step-major): each step's logits, values and recurrent state, then the
    sequence's log probs, entropies and values, within FT_NET_BAR *
    max(1, |x|)."""
    import torch
    from madrona_mp_env_tpu_torch.train import (build_actor_critic,
                                                init_rnn_states)

    W, S = ATTN_PARITY
    n = W * 2 * TEAM_SIZE
    obs = {k: v.reshape((S, n) + v.shape[1:]) for k, v in obs.items()}
    a = actions.reshape(S, n, 6)
    res = {}
    for d in ("cuda", "cpu"):
        net = build_actor_critic(seed=0, device=d, use_attention=True)
        rnn = init_rnn_states((n,), device=d)
        outs = []
        with torch.no_grad():
            for s in range(S):
                dists, v, rnn = net(rnn, {k: x[s].to(d)
                                          for k, x in obs.items()})
                outs.append(torch.cat([dists.discrete.logits.flatten(),
                                       dists.aim.logits.flatten(), v,
                                       rnn.flatten()]).cpu())
            lp, ent, vals = net.sequence(
                init_rnn_states((n,), device=d), torch.zeros(S, n, device=d),
                {k: x.to(d) for k, x in obs.items()},
                {"discrete": a[..., :4].to(d), "aim": a[..., 4:].to(d)})
        res[d] = {"step": torch.stack(outs), "seq": torch.cat(
            [x.flatten().cpu() for x in (lp["discrete"], lp["aim"],
                                         ent["discrete"], ent["aim"],
                                         vals)])}
    worst = {}
    for k in ("step", "seq"):
        x, y = res["cuda"][k], res["cpu"][k]
        worst[k] = float(((x - y).abs() / y.abs().clamp(min=1.0)).max())
        if worst[k] > FT_NET_BAR:
            raise AssertionError(f"attention policy {k}: cuda vs cpu rel err "
                                 f"{worst[k]}")
    log(f"[parity] attention policy cuda vs cpu, {W} worlds x {S} steps: "
        f"forward max rel err {worst['step']:.3g}, sequence "
        f"{worst['seq']:.3g} (bar {FT_NET_BAR})")


def bc_phase(mt, card, keep=None):
    """Phase 14: the eval CLI's event log and BC dump, the tool chain, BC
    on both layouts (f32 / bf16, kl_coef 0 / 0.1), PPO resumed from BC's
    checkpoint, the attention policy. The phase logs its own seconds.
    ``keep``: a directory that gets a copy of the seeded checkpoint
    (phase 17 exports it)."""
    import shutil
    import tempfile

    import torch
    from madrona_mp_env_tpu_torch.train import bc
    from madrona_mp_env_tpu_torch.train import train as train_cli

    t = [time.perf_counter()]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_bc_")
    try:
        events, dump = bc_eval_cli(mt, tmp, card)
        t.append(time.perf_counter())
        sets = bc_tools(events, dump, tmp)
        blocks = bc.load_bc_data(dump, "cuda")
        t.append(time.perf_counter())
        # the checkpoint BC starts from: a TrainingManager of 2 policies
        args = train_cli.parse_args([
            "--scene", SCENE, "--num-worlds", str(NUM_WORLDS),
            "--pbt-ensemble-size", "2", "--steps-per-update",
            str(BC_PPO_STEPS), "--num-bptt-chunks", "2"])
        _, _, env, mgr = train_cli.build(args)
        ts = mgr.init()
        ckpts = os.path.join(tmp, "ckpts")
        seeded = mgr.save_ckpt(ts, os.path.join(ckpts, "seeded"))
        if keep is not None:
            shutil.copy(seeded, keep)
        out = bc_runs(dump, blocks, sets, ckpts, card)
        t.append(time.perf_counter())
        # PPO from BC's checkpoint
        back = mgr.restore_ckpt(ts, out)
        moved = max(float((back.params[0][k] - v).abs().max())
                    for k, v in ts.params[0].items())
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        ts2, metrics = mgr.update_iter(back)
        ev[1].record()
        torch.cuda.synchronize()
        loss = metrics["loss"].cpu().numpy()
        if not np.isfinite(loss).all() or moved == 0.0 or \
                ts2.update_idx != 1:
            raise AssertionError(f"PPO from BC: loss {loss}, BC moved the "
                                 f"params by {moved}")
        log(f"[bc] PPO resumed from {os.path.basename(os.path.dirname(out))}"
            f"/0.pt: one update at {NUM_WORLDS} worlds x {BC_PPO_STEPS} "
            f"steps, E = 2, {ev[0].elapsed_time(ev[1]):.1f} ms (CUDA events), "
            f"losses {loss.tolist()} on {card}")
        del mgr, env, ts, ts2, back
        t.append(time.perf_counter())
        attention_phase(blocks, card)
        del blocks
        t.append(time.perf_counter())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    dt = [b - a for a, b in zip(t, t[1:])]
    log(f"[bc] phase {t[-1] - t[0]:.1f} s: eval CLI {dt[0]:.1f}, tools "
        f"and the dump's load {dt[1]:.1f}, checkpoint and BC runs "
        f"{dt[2]:.1f}, PPO from BC "
        f"{dt[3]:.1f}, attention {dt[4]:.1f}")


# phase 15: data parallelism (parallel/, the trainer's sharded path, the
# train CLI's --num-devices, tools/scaling_bench.py)
DP_RANKS = 2
# E = 2 train policies in cross play: the blocks are ragged on each rank
# after a rotation; one minibatch an epoch (2 Adam steps), the CPU test's
# count, which its 2.5 lr bar on the params is for
DP_FLAGS = ["--pbt-ensemble-size", "2", "--num-minibatches", "1"]
DP_MARGIN = 1e-4  # the Gumbel top-two margin that decides an action
DP_STEPS = 20  # (b)'s steps an update, cut from TRAIN_STEPS for the time


def dp_cli_args(tmp, name):
    """The train CLI at TRAIN_WORLDS x TRAIN_STEPS, Zone 6v6 on
    simple_map, one update, its metrics and checkpoint under tmp/name."""
    return ["--scene", SCENE, "--num-worlds", str(TRAIN_WORLDS),
            "--steps-per-update", str(TRAIN_STEPS), "--num-updates", "1",
            "--metrics-buffer-size", "1",
            "--ckpt-dir", os.path.join(tmp, name, "ck"),
            "--tb-dir", os.path.join(tmp, name, "tb"), "--run-name", "r"]


def dp_build(mesh, device):
    """The train CLI's build of the (b) configuration on one rank of
    ``mesh`` (or alone with None): (mgr, ts after global_init)."""
    from madrona_mp_env_tpu_torch.parallel import global_init
    from madrona_mp_env_tpu_torch.train import train as train_cli

    args = train_cli.parse_args(
        ["--scene", SCENE, "--num-worlds", str(TRAIN_WORLDS),
         "--steps-per-update", str(DP_STEPS)] + DP_FLAGS)
    _, _, _, mgr = train_cli.build(args, mesh, device)
    return mgr, global_init(mgr)


def dp_update(mgr, ts0, margins=False):
    """A rotation, then one update_iter with every launch counter zeroed
    just before and read just after it: each step's actions [S, W, A, 6]
    and match results of this process's worlds, the params, loss terms,
    key, normalizer and env state after it (on the CPU), the launches of
    SIMPLE_PATH's kernels, the update's ms (CUDA events) and, with
    ``margins``, each step's Gumbel top-two margins [S, W, A] and the
    params before the update."""
    import torch
    from madrona_mp_env_tpu_torch.utils import rng

    steps, dists = _record_steps(mgr)
    ts = mgr.resample_matchmaking(ts0)
    entries = zero_counts()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    ts1, m = mgr.update_iter(ts)
    ev[1].record()
    torch.cuda.synchronize()
    out = {"launches": {k: entries[k].launches for k in SIMPLE_PATH},
           "ms": ev[0].elapsed_time(ev[1]),
           "actions": torch.stack([s[0] for s in steps]),
           "win": torch.stack([s[1] for s in steps]),
           "finished": torch.stack([s[2] for s in steps]),
           "params": [{k: v.cpu() for k, v in p.items()}
                      for p in ts1.params],
           "lr": ts.hyper_params["lr"].cpu(),
           "metrics": {k: v.cpu() for k, v in m.items()},
           "key": ts1.key.cpu(),
           "normalizer": [{k: v.cpu() for k, v in d.items()}
                          for d in (ts1.normalizer.mu, ts1.normalizer.var)],
           "env": {k: v.cpu() for k, v in ts1.env_state.leaves().items()}}
    if margins:
        out["params0"] = [{k: v.cpu() for k, v in p.items()}
                          for p in ts.params]
        tb, pb = mgr.blocks(ts)
        keys = rng.split(rng.split(ts.key, 2)[1], DP_STEPS)
        out["margins"] = torch.stack([mgr.from_blocks(_gumbel_margin(
            torch.cat([d.discrete.packed_log_probs(),
                       d.aim.packed_log_probs()], -1),
            rng.split(keys[t], 2)[0]), None, tb, pb).cpu()
            for t, d in enumerate(dists[:DP_STEPS])])
    return out


def dp_rank(out_dir):
    """One rank of (b): its share of the 2-rank update on cuda:0, written
    to out_dir/rank<r>.pt."""
    import torch
    from madrona_mp_env_tpu_torch.parallel import global_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = global_mesh(TRAIN_WORLDS)
    mgr, ts0 = dp_build(mesh, "cuda:0")
    res = dp_update(mgr, ts0)
    res["rank"] = mesh.rank
    torch.save(res, os.path.join(out_dir, f"rank{mesh.rank}.pt"))


def dp_bits(x):
    import torch

    return x.view(torch.int32) if x.dtype == torch.float32 else x


def dp_equal(a, b):
    import torch

    return a.shape == b.shape and torch.equal(dp_bits(a), dp_bits(b))


def dp_cli(tmp, card):
    """(a): the train CLI with --num-devices 1 (a one-rank NCCL group)
    against the plain CLI from the same seed: the update bit-equal (int32
    views) in params, Adam state, normalizer, key and env state; the
    --num-devices 1 run's launches with every counter zeroed before and
    read after (the reset's fans, then every step's)."""
    import torch
    from madrona_mp_env_tpu_torch.train import train as train_cli

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = train_cli.main(dp_cli_args(tmp, "plain"))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    entries = zero_counts()
    one = train_cli.main(dp_cli_args(tmp, "one") + ["--num-devices", "1"])
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = {k: entries[k].launches for k in SIMPLE_PATH}
    expect = {k: TRAIN_STEPS * SIMPLE_PER_STEP.get(k, 1) + (
        k in ("ray_fans_vs_tris", "fan_capsules")) for k in SIMPLE_PATH}
    others = {k: f.launches for k, f in entries.items()
              if k not in SIMPLE_PATH and f.launches}
    if counts != expect or others:
        raise AssertionError(f"[dp] --num-devices 1: launches {counts}, "
                             f"expected {expect}; others {others}")
    pairs = [(a[k], b[k]) for a, b in zip(one.params, plain.params)
             for k in a]
    pairs += [(getattr(a, f)[k], getattr(b, f)[k])
              for a, b in zip(one.opt_state, plain.opt_state)
              for f in ("mu", "nu") for k in a.mu]
    pairs += [(d1[k], d2[k]) for d1, d2 in (
        (one.normalizer.mu, plain.normalizer.mu),
        (one.normalizer.var, plain.normalizer.var)) for k in d1]
    pairs += [(v, plain.env_state.leaves()[k])
              for k, v in one.env_state.leaves().items()]
    pairs += [(one.key, plain.key)]
    bad = sum(not dp_equal(a, b) for a, b in pairs)
    if bad:
        raise AssertionError(f"[dp] --num-devices 1: {bad} of {len(pairs)} "
                             "tensors differ from the plain CLI's")
    log(f"[dp] (a) train CLI --num-devices 1 (NCCL, one rank) at "
        f"{TRAIN_WORLDS} worlds x {TRAIN_STEPS} steps, one update: "
        f"{len(pairs)} tensors bit-equal (int32 views) to the plain CLI's "
        f"(params, Adam state, normalizer, env state, key); CLI wall "
        f"{t2 - t1:.2f} s against {t1 - t0:.2f} s plain; launches "
        + ", ".join(f"{k}={c}" for k, c in counts.items()) + f" on {card}")
    del plain, one


def dp_compare(ref, ranks):
    """(b)'s bars, the CPU test's: the ranks' actions equal to the
    one-process run's where its margin decides them and match results
    exact, up to the first step an action differs; params within 2.5 lr;
    where every action agreed, loss terms within 1e-4 relative and the
    normalizer within 1e-6 * max(1, |x|); each rank's env state bit-equal
    to the one-process slice in every world whose actions all agreed;
    params, loss terms and key bit-equal across the ranks. The CPU test's
    0.5 lr where every action agreed is reported, not held: at 1024
    worlds some gradient elements sum to less than the rounding of their
    terms, and Adam's first steps (~lr * sign(g)) move those either way
    under another summation order. Returns a summary dict."""
    import torch

    Wl = TRAIN_WORLDS // len(ranks)
    act = torch.cat([r["actions"] for r in ranks], 1)
    win = torch.cat([r["win"] for r in ranks], 1)
    fin = torch.cat([r["finished"] for r in ranks], 1)
    compared = 0
    for t in range(DP_STEPS):
        same = (act[t] == ref["actions"][t]).all(-1)
        if not bool(same[ref["margins"][t] > DP_MARGIN].all()):
            raise AssertionError(f"[dp] (b) step {t}: decided actions "
                                 "differ")
        if not (torch.equal(win[t], ref["win"][t])
                and torch.equal(fin[t], ref["finished"][t])):
            raise AssertionError(f"[dp] (b) step {t}: match results differ")
        compared = t + 1
        if not bool(same.all()):
            break
    all_same = bool((act == ref["actions"]).all())
    lr = ref["lr"]
    worst, n, near, big_n, flipped = 0.0, 0, 0, 0, 0
    for e, (p1, p0) in enumerate(zip(ref["params"], ref["params0"])):
        for k, want in p1.items():
            got = ranks[0]["params"][e][k]
            d = (got - want).abs() / float(lr[e])
            worst = max(worst, float(d.max()))
            n += d.numel()
            near += int((d <= 0.5).sum())
            dw, dg = want - p0[k], got - p0[k]
            big = dw.abs() > lr[e]
            big_n += int(big.sum())
            flipped += int((torch.sign(dg[big]) != torch.sign(dw[big])).sum())
    if worst > 2.5:
        raise AssertionError(f"[dp] (b) params differ by up to {worst} lr")
    loss_err = max(float(((ranks[0]["metrics"][k] - ref["metrics"][k]).abs()
                          / ref["metrics"][k].abs().clamp(min=1.0)).max())
                   for k in ("loss", "pg_loss", "v_loss"))
    norm_err = max(float(((g[k] - w[k]).abs() / w[k].abs().clamp(min=1.0))
                         .max()) for g, w in zip(ranks[0]["normalizer"],
                                                 ref["normalizer"])
                   for k in w)
    if all_same and (loss_err > 1e-4 or norm_err > 1e-6):
        raise AssertionError(f"[dp] (b) loss terms {loss_err:.3g}, "
                             f"normalizer {norm_err:.3g}")
    agreed_worlds = 0
    for r, res in enumerate(ranks):
        sl = slice(r * Wl, (r + 1) * Wl)
        agreed = (res["actions"] == ref["actions"][:, sl]).all(-1).all(
            -1).all(0)
        agreed_worlds += int(agreed.sum())
        bad = [k for k, v in res["env"].items()
               if not dp_equal(v[agreed], ref["env"][k][sl][agreed])]
        if bad:
            raise AssertionError(f"[dp] (b) rank {r}: env state differs "
                                 f"from the one-process slice in {bad}")
    a = ranks[0]
    for b in ranks[1:]:
        if not (all(dp_equal(x[k], y[k]) for x, y in zip(a["params"],
                                                        b["params"])
                    for k in x)
                and all(dp_equal(a["metrics"][k], b["metrics"][k])
                        for k in a["metrics"])
                and torch.equal(a["key"], b["key"])):
            raise AssertionError("[dp] (b) the ranks' replicated state "
                                 "differs")
    if not torch.equal(a["key"], ref["key"]):
        raise AssertionError("[dp] (b) the key differs from one process's")
    return {"compared": compared, "all_same": all_same,
            "undecided": int((ref["margins"] <= DP_MARGIN).sum()),
            "params_lr": worst, "over": n - near, "n": n, "flipped": flipped,
            "big": big_n, "loss_err": loss_err, "norm_err": norm_err,
            "agreed_worlds": agreed_worlds}


def dp_ranks(tmp, rows, card):
    """(b): DP_RANKS ranks on the one card (gloo over CUDA tensors, each
    given cuda:0), TRAIN_WORLDS / DP_RANKS worlds each, the (b)
    configuration: a rotation and one update, held to the one-process
    run of the same configuration (dp_compare), which this process runs
    while the ranks do. Each rank's launches of the six main-path
    kernels are held to DP_STEPS steps' and stored on their rows."""
    import threading

    import torch
    from madrona_mp_env_tpu_torch.parallel import launch

    failed = []

    def ranks():
        try:
            launch(dp_rank, DP_RANKS, (tmp,), "gloo",
                   init_method="file://" + os.path.join(tmp, "rendezvous"),
                   timeout_s=600)
        except RuntimeError as e:
            failed.append(e)

    t0 = time.perf_counter()
    th = threading.Thread(target=ranks)
    th.start()
    try:
        mgr, ts0 = dp_build(None, "cuda")
        ref = dp_update(mgr, ts0, margins=True)
        del mgr, ts0
    finally:
        th.join()
    t1 = time.perf_counter()
    if failed:
        raise failed[0]
    res = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
           for r in range(DP_RANKS)]
    expect = {k: DP_STEPS * SIMPLE_PER_STEP.get(k, 1) for k in SIMPLE_PATH}
    for r in res:
        if r["launches"] != expect:
            raise AssertionError(f"[dp] (b) rank {r['rank']}: launches "
                                 f"{r['launches']}, expected {expect}")
    summary = dp_compare(ref, res)
    for row in rows:
        entry = row["entry"].__name__
        row["dp_launches"] = [r["launches"][entry] for r in res]
        row["dp_path"] = (f"train update, {DP_RANKS} ranks x "
                          f"{TRAIN_WORLDS // DP_RANKS} worlds on one card")
    for r in res:
        log(f"[dp] (b) rank {r['rank']} of {DP_RANKS} (gloo, cuda:0), "
            f"{TRAIN_WORLDS // DP_RANKS} worlds: update_iter after a "
            f"rotation {r['ms']:.1f} ms (CUDA events); launches "
            + ", ".join(f"{k}={c}" for k, c in r["launches"].items()))
    log(f"[dp] (b) {DP_RANKS} ranks against one process at {TRAIN_WORLDS} "
        f"worlds x {DP_STEPS} steps, E = 2 (cross play), one rotation: "
        f"{summary['compared']} of {DP_STEPS} steps compared, every "
        f"action equal: {summary['all_same']} ({summary['undecided']} "
        f"undecided actor-steps at margin {DP_MARGIN}); params within "
        f"{summary['params_lr']:.4g} lr (bar 2.5), {summary['over']} of "
        f"{summary['n']} beyond 0.5 lr, {summary['flipped']} of the "
        f"{summary['big']} that moved more than lr moved the other way; "
        f"loss terms {summary['loss_err']:.3g} relative, normalizer "
        f"{summary['norm_err']:.3g}; env state "
        f"bit-equal in {summary['agreed_worlds']} of {TRAIN_WORLDS} worlds; "
        f"replicated state bit-equal across the ranks; one-process "
        f"update_iter {ref['ms']:.1f} ms (the ranks and this process share "
        f"the card); wall {t1 - t0:.1f} s on {card}")


def dp_bench(card):
    """(c): tools/scaling_bench.py at one device (512 worlds, 50 env
    steps, one timed train update after a warm-up one), every counter
    zeroed before and read after."""
    from madrona_mp_env_tpu_torch.tools import scaling_bench

    entries = zero_counts()
    (line,) = scaling_bench.main(["--train", "--num-updates", "1",
                                  "--max-devices", "1"])
    counts = {k: entries[k].launches for k in SIMPLE_PATH}
    if min(counts.values()) == 0 or line.get("card") != card:
        raise AssertionError(f"[dp] (c) scaling bench: {line}, launches "
                             f"{counts}")
    log(f"[dp] (c) scaling_bench at 1 device, {line['num_worlds']} worlds: "
        f"{line['env_steps_per_sec']:.1f} env-steps/s, "
        f"{line['train_env_steps_per_sec']:.1f} train env-steps/s "
        f"(efficiency {line['efficiency_vs_1dev']}) on {line['card']}; "
        "launches " + ", ".join(f"{k}={c}" for k, c in counts.items()))


def dp_refuses():
    """(d): --num-devices beyond the visible cards raises before any
    rank starts."""
    import torch
    from madrona_mp_env_tpu_torch.train import train as train_cli

    n = torch.cuda.device_count() + 1
    try:
        train_cli.main(["--num-devices", str(n), "--num-updates", "1"])
    except RuntimeError as e:
        if "visible" not in str(e):
            raise
        log(f"[dp] (d) --num-devices {n} on {n - 1} card(s) raises: {e}")
        return
    raise AssertionError(f"[dp] (d) --num-devices {n} did not raise")


def parallel_phase(rows, card):
    """Phase 15: (a) dp_cli, (b) dp_ranks, (c) dp_bench, (d) dp_refuses.
    The phase logs its own seconds."""
    import shutil
    import tempfile

    import torch

    torch.cuda.empty_cache()
    t = [time.perf_counter()]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    try:
        dp_cli(tmp, card)
        t.append(time.perf_counter())
        dp_ranks(tmp, rows, card)
        t.append(time.perf_counter())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    dp_bench(card)
    t.append(time.perf_counter())
    dp_refuses()
    t.append(time.perf_counter())
    dt = [b - a for a, b in zip(t, t[1:])]
    log(f"[dp] phase {t[-1] - t[0]:.1f} s: (a) {dt[0]:.1f}, (b) "
        f"{dt[1]:.1f}, (c) {dt[2]:.1f}, (d) {dt[3]:.1f}")


def dp_card_rank(out_dir):
    """One rank of cards_phase's update: rank r on cuda:r over NCCL, its
    share written to out_dir/rank<r>.pt."""
    import torch
    from madrona_mp_env_tpu_torch.parallel import global_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = global_mesh(TRAIN_WORLDS)
    dev = torch.device("cuda", mesh.rank)
    torch.cuda.set_device(dev)
    mgr, ts0 = dp_build(mesh, dev)
    res = dp_update(mgr, ts0)
    res["rank"] = mesh.rank
    torch.save(res, os.path.join(out_dir, f"rank{mesh.rank}.pt"))


def cards_phase(n, card):
    """``python3 chip_smoke.py --cards`` on a machine of n > 1 cards, one
    process a card over NCCL: tools/scaling_bench.py over 1, 2, 4, ...
    cards (512 worlds a card, two timed train updates a point); n ranks
    of phase 15 (b)'s update (TRAIN_WORLDS / n worlds each) against one
    process on cuda:0 at dp_compare's bars, each rank's launches held to
    DP_STEPS steps'; the train CLI with --num-devices n: two updates,
    a checkpoint after each, then a restore to a third."""
    import shutil
    import tempfile
    import threading

    import torch
    from madrona_mp_env_tpu_torch.parallel import launch
    from madrona_mp_env_tpu_torch.tools import scaling_bench
    from madrona_mp_env_tpu_torch.train import train as train_cli

    t = [time.perf_counter()]
    # its rank 0 prints a JSON line a point, with each card's name and limit
    scaling_bench.main(["--train", "--num-updates", "2"])
    t.append(time.perf_counter())
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cards_")
    try:
        failed = []

        def ranks():
            try:
                launch(dp_card_rank, n, (tmp,), "nccl",
                       init_method="file://" + os.path.join(tmp, "rdv"),
                       timeout_s=600)
            except RuntimeError as e:
                failed.append(e)

        th = threading.Thread(target=ranks)
        th.start()
        try:
            mgr, ts0 = dp_build(None, "cuda:0")
            ref = dp_update(mgr, ts0, margins=True)
            del mgr, ts0
        finally:
            th.join()
        if failed:
            raise failed[0]
        res = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                          weights_only=False) for r in range(n)]
        expect = {k: DP_STEPS * SIMPLE_PER_STEP.get(k, 1)
                  for k in SIMPLE_PATH}
        for r in res:
            if r["launches"] != expect:
                raise AssertionError(f"[cards] rank {r['rank']}: launches "
                                     f"{r['launches']}, expected {expect}")
            log(f"[cards] rank {r['rank']} of {n} (NCCL, cuda:{r['rank']}):"
                f" update_iter {r['ms']:.1f} ms (CUDA events); launches "
                + ", ".join(f"{k}={c}" for k, c in r["launches"].items()))
        log(f"[cards] {n} ranks against one process at {TRAIN_WORLDS} "
            f"worlds: {dp_compare(ref, res)}; one process {ref['ms']:.1f} "
            "ms (sharing cuda:0 with rank 0)")
        t.append(time.perf_counter())
        base = ["--scene", SCENE, "--num-worlds", str(TRAIN_WORLDS),
                "--steps-per-update", str(TRAIN_STEPS),
                "--metrics-buffer-size", "1", "--ckpt-frequency", "1",
                "--ckpt-dir", os.path.join(tmp, "ck"),
                "--tb-dir", os.path.join(tmp, "tb"), "--run-name", "r",
                "--num-devices", str(n)]
        train_cli.main(base + ["--num-updates", "2"])
        train_cli.main(base + ["--num-updates", "3", "--restore", "2"])
        ckpts = sorted(os.listdir(os.path.join(tmp, "ck", "r")))
        with open(os.path.join(tmp, "tb", "r", "metrics.jsonl")) as f:
            rows = [json.loads(x) for x in f]
        keys = [(r["tag"], r["step"]) for r in rows]
        if ckpts != ["1.pt", "2.pt", "3.pt"] or len(keys) != len(set(keys)):
            raise AssertionError(f"[cards] CLI: checkpoints {ckpts}, "
                                 f"{len(keys)} metric rows")
        t.append(time.perf_counter())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    dt = [b - a for a, b in zip(t, t[1:])]
    log(f"[cards] CLI --num-devices {n}: checkpoints {ckpts}, {len(keys)} "
        f"metric rows, each written once; seconds: bench {dt[0]:.1f}, "
        f"ranks {dt[1]:.1f}, CLI {dt[2]:.1f}")


# phase 16: the offline asset tools. The table builders' batteries are cut
# to fit the run (the full builds' seconds: PERF.md, from
# tools/build_culling.py and load_map(build_culling=True) runs)
ASSET_RAY_KW = dict(rays_per_cell=1000, round_rays=1 << 16, max_rounds=2)
ASSET_CELL_KW = dict(cells_per_side=16, rays_per_cell=2000,
                     casts_per_cell=400, round_rays=1 << 16,
                     round_casts=1 << 14, max_rounds=2, k_max=1152)
ASSET_VERIFY = dict(n_rays=100000, n_casts=20000)
ASSET_CASTS = 8192  # one chunk of the cast battery
ASSET_RAYS = 16384  # one chunk of verify_tables' rays
ASSET_GOLDEN_STEPS = 50  # golden --generate's rollout on the CPU, cut


def map_inputs(scene):
    """(Morton-ordered triangles, the builders' walkable points) of a map
    directory, as load_map hands them to the builders."""
    from madrona_mp_env_tpu_torch.assets import formats
    from madrona_mp_env_tpu_torch.assets.map_data import walkable_points
    from madrona_mp_env_tpu_torch.ops.raycast import morton_sort_tris

    col = formats.load_collision_data(os.path.join(scene, "collisions.bin"))
    nav = formats.load_navmesh(os.path.join(scene, "navmesh.bin"))
    spawns = formats.load_spawns(os.path.join(scene, "spawns.bin"))
    return morton_sort_tris(col.tri_verts), walkable_points(nav, spawns)


def table_bits(new, old):
    """(bits only in new, bits only in old): the (cell, triangle) pairs of
    two [C, K] candidate tables."""
    def bits(cand):
        c, k = np.nonzero(cand >= 0)
        return c.astype(np.int64) * (1 << 32) + cand[c, k]

    a, b = bits(new), bits(old)
    return len(np.setdiff1d(a, b)), len(np.setdiff1d(b, a))


def build_line(label, stats, seconds):
    return (f"{label} in {seconds:.1f} s ({stats['chunks']} battery chunks, "
            f"device {stats['device_s']:.1f} s, host share "
            f"{1 - stats['device_s'] / stats['total_s']:.3f} of "
            f"{stats['total_s']:.1f} s after the near sets; round bits "
            f"{stats['round_bits']})")


def asset_chunk_rows(tv, wp, launches):
    """K4 dense on one chunk of town_map's cast battery and K1 on one
    chunk of verify_tables' rays, each against its plain version and its
    predecessor on the card (int32 views: t and winner row, t), timed in
    turns with it; rows tagged "town_map tables" with the launches of the
    build + verify path."""
    import torch
    from madrona_mp_env_tpu_torch.ops import culling, raycast

    b = culling._Battery(tv, ASSET_CELL_KW["cells_per_side"], 190.0,
                         culling.QUERY_MARGIN, 0, wp,
                         torch.device("cuda"), None)
    soup = raycast.make_tri_soup(tv, pad_to=128, device="cuda")
    T = len(tv)
    rows = []
    for name, n, src, replaces, entry in (
            ("K4 sphere_cast (dense)", ASSET_CASTS, "sphere_cast.cu",
             "raycast_pallas.py:1384", raycast.sphere_cast),
            ("K1 ray_vs_tris", ASSET_RAYS, "ray_tris.cu",
             "raycast_pallas.py:111", raycast.ray_vs_tris)):
        o = torch.as_tensor(b.sample_origins(n), device="cuda")
        d = torch.as_tensor(culling._unit_dirs(b.rng, n), device="cuda")
        if entry is raycast.sphere_cast:
            def kernel(o=o, d=d):
                return raycast.sphere_cast(o, d, 15.0, soup)

            def plain(o=o, d=d):
                return sc_dense_plain(o, d, 15.0, soup)

            def before(o=o, d=d):
                return raycast.sphere_cast_v1(o, d, 15.0, soup)

            nbytes, nops = n * 32 + T * 52, n * T * OPS_SPHERE_TRI
        else:
            def kernel(o=o, d=d):
                return raycast.ray_vs_tris(o, d, soup)

            def plain(o=o, d=d):
                return chunked(lambda s: raycast._ray_vs_tris_dense(
                    o[s], d[s], soup), n, max(64, 2 ** 22 // soup.num_tris))

            def before(o=o, d=d):
                return raycast.ray_vs_tris_v1(o, d, soup)

            nbytes, nops = n * 28 + T * 40, n * T * OPS_RAY_TRI
        got, want = kernel(), plain()
        pairs = list(zip(got, want)) if isinstance(got, tuple) else [
            (got, want)]
        err = check_equal(f"{name} [town_map tables]", *pairs)
        old = before()
        check_equal(f"{name} [town_map tables] against its predecessor",
                    *(zip(got, old) if isinstance(got, tuple)
                      else [(got, old)]))
        ms, before_ms = turns_ms(kernel, before, 10)
        hits = float(torch.isfinite(pairs[0][1]).float().mean())
        extra = {}
        if entry is raycast.sphere_cast:
            extra = sc_dense_extra(kernel, before, nops, False,
                                   soup.num_tris, n, 10)
        row = kernel_row(
            "town_map tables", name,
            f"madrona_mp_env_tpu_torch/csrc/{src}",
            f"madrona_mp_env_tpu/ops/{replaces}", entry, err,
            ms, cuda_time_ms(plain, 1), nbytes, nops,
            [[n]], hit_share=round(hits, 4), before_ms=round(before_ms, 4),
            **extra)
        row["launches"] = launches[entry.__name__]
        row["path"] = "town_map tables: build_cell_tables + verify_tables"
        rows.append(row)
    return rows


def asset_tools_phase(card):
    """Phase 16: (a) make_town_map at its defaults, byte-equal to
    data/town_map; (b) build_ray_tables for simple_map on cuda and on cpu
    (ASSET_RAY_KW), equal tables and round bits; (c) build_cell_tables for
    town_map on cuda (ASSET_CELL_KW) and verify_tables on it
    (ASSET_VERIFY), every launch counter zeroed before the build and read
    after the build and after the check (K4 dense in both, K1 in the
    check, nothing else), its bits against the committed table and the
    mismatch counts logged; (d) asset_chunk_rows; (e) golden --generate
    into a temporary path, then --check on the card against it. Returns
    the two kernel rows; the phase logs its own seconds."""
    import shutil
    import tempfile

    import torch
    from madrona_mp_env_tpu_torch.ops import culling
    from madrona_mp_env_tpu_torch.tools import golden, make_town_map

    torch.cuda.empty_cache()
    t = [time.perf_counter()]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_assets_")
    try:
        town = os.path.join(tmp, "town")
        make_town_map.main(["--out", town])
        for name in ("collisions.bin", "navmesh.bin", "spawns.bin",
                     "zones.bin"):
            with open(os.path.join(town, name), "rb") as f, open(
                    os.path.join(TOWN, name), "rb") as g:
                if f.read() != g.read():
                    raise AssertionError(f"[assets] make_town_map: {name} "
                                         "differs from data/town_map's")
        t.append(time.perf_counter())
        log(f"[assets] (a) make_town_map at its defaults: the four .bin "
            f"files byte-equal to data/town_map's, {t[-1] - t[-2]:.1f} s")

        tv, wp = map_inputs(SCENE)
        raws = {}
        for dev in ("cuda", "cpu"):
            stats, t0 = {}, time.perf_counter()
            raws[dev] = culling.build_ray_tables(
                tv, walkable_points=wp, device=dev, stats=stats,
                **ASSET_RAY_KW), stats
            log("[assets] (b) " + build_line(
                f"build_ray_tables simple_map {ASSET_RAY_KW} on {dev}: K "
                f"{raws[dev][0]['K']}", stats, time.perf_counter() - t0))
        (gpu, gs), (cpu, cs) = raws["cuda"], raws["cpu"]
        if (not np.array_equal(gpu["cand_idx"], cpu["cand_idx"])
                or gs["round_bits"] != cs["round_bits"]):
            raise AssertionError("[assets] (b) the sensor-ray tables on "
                                 "cuda differ from the cpu build's")
        log(f"[assets] (b) cuda and cpu tables equal ({gpu['cand_idx'].shape}"
            f" cand_idx, round bits {gs['round_bits']})")
        t.append(time.perf_counter())

        tv, wp = map_inputs(TOWN)
        entries = zero_counts()
        stats, t0 = {}, time.perf_counter()
        raw = culling.build_cell_tables(tv, walkable_points=wp,
                                        device="cuda", stats=stats,
                                        **ASSET_CELL_KW)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        build = {n: f.launches for n, f in entries.items() if f.launches}
        log("[assets] (c) " + build_line(
            f"build_cell_tables town_map {ASSET_CELL_KW} on cuda: K "
            f"{raw['K']}, k_raw {raw['k_raw']}, mean "
            f"{raw['mean_count']:.1f}", stats, build_s)
            + f"; launches {build}")
        with np.load(os.path.join(TOWN, "culling.npz")) as z:
            only_new, only_old = table_bits(raw["cand_idx"], z["cand_idx"])
            n_old = int((z["cand_idx"] >= 0).sum())
        tables = culling._grid_tables(culling.CellTables, raw, "cuda")
        t0 = time.perf_counter()
        res = culling.verify_tables(tv, tables, walkable_points=wp,
                                    **ASSET_VERIFY)
        verify_s = time.perf_counter() - t0
        launches = {n: f.launches for n, f in entries.items() if f.launches}
        if set(build) != {"sphere_cast"} or set(launches) != {
                "sphere_cast", "ray_vs_tris"}:
            raise AssertionError(f"[assets] (c) launches: build {build}, "
                                 f"build + verify {launches}")
        log(f"[assets] (c) against the committed culling.npz ({n_old} bits,"
            f" its full battery): {only_new} bits only in this cut build, "
            f"{only_old} only in the committed; verify_tables "
            f"{ASSET_VERIFY} in {verify_s:.1f} s: {res}; launches build + "
            f"verify {launches} on {card}")
        t.append(time.perf_counter())

        rows = asset_chunk_rows(tv, wp, launches)
        t.append(time.perf_counter())

        path = os.path.join(tmp, "golden.npz")
        golden.main(["--generate", "--path", path, "--num-steps",
                     str(ASSET_GOLDEN_STEPS)])
        rep = golden.check(path, "cuda", verbose=False)
        log(f"[assets] (e) golden --generate ({ASSET_GOLDEN_STEPS} steps on "
            f"the CPU), then --check on cuda: first pos divergence at step "
            f"{rep['first_divergence_step']}, hp exact {rep['hp_exact']}, "
            f"team points exact {rep['team_points_exact']}")
        t.append(time.perf_counter())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    dt = [b - a for a, b in zip(t, t[1:])]
    log(f"[assets] phase {t[-1] - t[0]:.1f} s: (a) {dt[0]:.1f}, (b) "
        f"{dt[1]:.1f}, (c) {dt[2]:.1f}, (d) {dt[3]:.1f}, (e) {dt[4]:.1f}")
    return rows


# phase 17: the viewing tools and the weight export. The viz server
# (tools/viz_server.py) on cuda over a logging run of its own, its live
# session (one world, every agent the A* bot) on each configuration of
# VIZ_LIVE against a CPU session of the same seed, convert_weights on the
# seeded checkpoint of phase 14 and the viewer's frame readers
VIZ_STEPS = 20  # live steps a configuration, one request each
VIZ_LOG_WORLDS = 4  # the server's record, event log and DB
VIZ_LOG_STEPS = 10
VIZ_TIMEOUT = 120  # s an HTTP call may take
VIZ_BAR = 1e-4  # live pos and yaw, cuda against cpu: phase 9's bar
VIZ_REPLAY = ((0, 0), (4, 1), (VIZ_LOG_STEPS - 1, VIZ_LOG_WORLDS - 1))
# each canned query with parameters that select rows of the logging run's
# DB
VIZ_CANNED = {
    "matches": {},
    "match_steps": {"match_id": 1},
    "players_at_step": {"step_id": 3},
    "kills_in_match": {"match_id": 1},
    "kills_near": {"x": 0.0, "y": 0.0, "r": 5000.0},
    "captures_in_match": {"match_id": 1},
    "team_positions": {"match_id": 1},
}
# the live configurations: (label, scene, team size, the scene tags of
# its kernel rows (the fan's first), the fan's entries, its CUDA kernels
# by name); the kernels of every configuration besides the fan
VIZ_LIVE = (
    ("live simple_map 6v6", SCENE, TEAM_SIZE, ("simple_map",),
     ("ray_fans_vs_tris",), {"fan_tris_rb_kernel": 1}),
    ("live simple_map 3v3", SCENE, 3, ("simple_map Zone 3v3", "simple_map"),
     ("ray_fans_vs_tris_flat",), {"fan_flat_rb_kernel": 1}),
    ("live town_map 6v6", TOWN, TEAM_SIZE, ("town_map",),
     ("ray_fans_culled", "fan_cell_order"),
     {"fan_culled_rb_kernel": 1, "fan_cell_order_kernel": 1}),
)
VIZ_PER_STEP = {"ray_vs_tris": 1, "fan_capsules": 1, "sphere_cast_culled": 1,
                "sphere_cast_packed": 3, "tail_fused": 1}
VIZ_KERNELS = {"ray_tris_rb_kernel": 1, "fan_capsules_kernel": 1,
               "sc_culled_kernel": 4, "tail_fused_kernel": 1}
VIZ_ROWS = ("K1 ray_vs_tris", "K2 ray_fans_vs_tris",
            "K7 ray_fans_vs_tris_flat", "K6 ray_fans_culled",
            "K6 cell order", "K3 fan_capsules", "K4 sphere_cast_culled",
            "K4' sphere_cast_packed", "K5 tail_fused")


def viz_get(url):
    import urllib.request

    with urllib.request.urlopen(url, timeout=VIZ_TIMEOUT) as r:
        return json.loads(r.read())


def viz_post(url, body):
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=VIZ_TIMEOUT) as r:
        return json.loads(r.read())


def viz_refused(url):
    """The status and JSON of a GET the server refuses; a 200 fails."""
    import urllib.error

    try:
        viz_get(url)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())
    raise AssertionError(f"viz {url}: answered 200")


def viz_query(url, body):
    """Submit a DB query and poll its ticket until the worker answers."""
    ticket = viz_post(url + "/api/db/submit", body)["ticket"]
    deadline = time.monotonic() + VIZ_TIMEOUT
    while True:
        res = viz_get(url + f"/api/db/result?ticket={ticket}")
        if res["status"] != "pending":
            return res
        if time.monotonic() > deadline:
            raise AssertionError(f"viz: query {body} still pending")
        time.sleep(0.01)


def viz_start(data):
    """(base URL, server): ``data`` served on an ephemeral 127.0.0.1 port
    from a daemon thread."""
    import socket
    import threading

    from madrona_mp_env_tpu_torch.tools import viz_server

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    httpd = viz_server.serve(data, port)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{port}", httpd


def viz_logs(mt, cfg, tmp):
    """A VIZ_LOG_STEPS-step logging run of VIZ_LOG_WORLDS worlds of
    ``cfg`` on simple_map on the card (bench.py's actions, every agent
    reloading on every third step so that the event log holds events):
    its record, event log and build_db DB in ``tmp``."""
    from madrona_mp_env_tpu_torch.data import EventLogWriter, RecordLogWriter
    from madrona_mp_env_tpu_torch.data.build_db import build_db

    env = mt.Env(cfg, SCENE, num_worlds=VIZ_LOG_WORLDS, seed=5,
                 device="cuda", collect_log=True)
    acts = bench_actions(VIZ_LOG_WORLDS, cfg.num_agents, VIZ_LOG_STEPS)
    acts["fire"][::3] = 2
    record = os.path.join(tmp, "record.bin")
    events = os.path.join(tmp, "events")
    state, _ = env.reset()
    with RecordLogWriter(record) as rw, EventLogWriter(events) as ew:
        for s in range(VIZ_LOG_STEPS):
            state, out = env.step(state, actions_at(env, acts, s))
            rw.append(out["step_log"])
            ew.append(out["snapshot"], out["game_events"])
    db = os.path.join(tmp, "analytics.db")
    build_db(events, db, team_size=cfg.team_size)
    return record, events, db


def viz_routes(url, data, db):
    """(a) Every route of the server but the live ones, each JSON equal to
    ``data``'s own answer: the page (viewer_web.html's bytes), the map,
    the replay's meta and VIZ_REPLAY's frames (a frame past the record
    400), each world's events; the canned queries and a free-form one,
    their rows those of the same SQL on a read-only connection of their
    own; a DELETE an error with the rows untouched."""
    import sqlite3
    import urllib.request

    from madrona_mp_env_tpu_torch.tools import viz_server

    with urllib.request.urlopen(url + "/", timeout=VIZ_TIMEOUT) as r:
        page = r.read()
    with open(os.path.join(os.path.dirname(viz_server.__file__),
                           "viewer_web.html"), "rb") as f:
        if page != f.read():
            raise AssertionError("viz: / is not viewer_web.html")

    def same(route, want):
        got = viz_get(url + route)
        if got != json.loads(json.dumps(want)):
            raise AssertionError(f"viz {route}: {str(got)[:300]} against "
                                 f"{str(want)[:300]}")
        return got

    same("/api/map", data.map_json)
    same("/api/replay/meta", {"available": True, "num_steps": VIZ_LOG_STEPS,
                              "num_worlds": VIZ_LOG_WORLDS})
    for step, world in VIZ_REPLAY:
        same(f"/api/replay/frame?step={step}&world={world}",
             data.replay_frame(step, world))
    code, _ = viz_refused(url + f"/api/replay/frame?step={VIZ_LOG_STEPS}")
    if code != 400:
        raise AssertionError(f"viz: a frame past the record answered {code}")
    n_events = sum(len(same(f"/api/events?world={w}",
                            data.event_list(w))["events"])
                   for w in range(VIZ_LOG_WORLDS))
    same("/api/db/canned", {"queries": sorted(viz_server.CANNED_QUERIES)})
    conn = sqlite3.connect(f"file:{db}?mode=ro", uri=True)
    try:
        bodies = [{"canned": n, "params": p} for n, p in VIZ_CANNED.items()]
        bodies.append({"sql": "SELECT COUNT(*), MAX(hp) FROM player_states"})
        rows = {}
        for body in bodies:
            sql = viz_server.CANNED_QUERIES.get(body.get("canned"),
                                                body.get("sql"))
            want = [list(r) for r in conn.execute(sql, body.get("params",
                                                                {}))]
            res = viz_query(url, body)
            if res["status"] != "done" or res["rows"] != json.loads(
                    json.dumps(want)):
                raise AssertionError(f"viz: query {body}: {str(res)[:300]}")
            rows[body.get("canned", "free")] = res["rows"]
    finally:
        conn.close()
    players = VIZ_LOG_WORLDS * VIZ_LOG_STEPS * 2 * TEAM_SIZE
    if rows["free"][0][0] != players:
        raise AssertionError(f"viz: player_states holds {rows['free']}, "
                             f"not {players} rows")
    matches = viz_query(url, {"canned": "matches"})
    bad = viz_query(url, {"sql": "DELETE FROM matches"})
    if bad["status"] != "error" or viz_query(
            url, {"canned": "matches"}) != matches:
        raise AssertionError(f"viz: a DELETE answered {bad}")
    return n_events, {k: len(v) for k, v in rows.items()}


def viz_frame_check(label, got, want, err):
    """A live frame of the card against the CPU session's: step, hp,
    alive, cur_zone, controller and team_points exact, pos and yaw within
    VIZ_BAR * max(1, |x|); ``err`` keeps the largest relative errors."""
    if set(got) != set(want):
        raise AssertionError(f"{label}: frame keys {sorted(got)}")
    for k in ("step", "hp", "alive", "cur_zone", "controller",
              "team_points"):
        if got[k] != want[k]:
            raise AssertionError(f"{label}: {k} {got[k]} on cuda, {want[k]} "
                                 f"on cpu at step {want['step']}")
    for k in ("pos", "yaw"):
        g, w = np.asarray(got[k], np.float64), np.asarray(want[k], np.float64)
        e = float((np.abs(g - w) / np.maximum(1.0, np.abs(w))).max())
        err[k] = max(err[k], e)
        if e > VIZ_BAR:
            raise AssertionError(f"{label}: {k} {e:.3g} relative from the "
                                 f"cpu at step {want['step']}")


def viz_live(label, url, live, cpu, rows, fan, kernels, card):
    """(a) One live configuration: VIZ_STEPS /api/live/step?n=1 requests
    with every launch counter zeroed before and read after, each frame
    held to the CPU session's (viz_frame_check); each kernel of the path
    launched VIZ_PER_STEP times a request (``fan``'s entries once) and no
    other, each row of ``rows`` getting {"path", "launches"} on its "live"
    list; wall ms per request; /api/live/reset and a request of n = 3
    against the CPU session reset; then MODE_PROFILE_STEPS steps of the
    server's session ``live`` in this thread timed on the host clock and
    MODE_PROFILE_STEPS under torch.profiler (the device alone): CUDA
    launches per step, and per step of each of ``kernels`` (CUDA kernel
    names) beside the counters'."""
    import torch

    err = {"pos": 0.0, "yaw": 0.0}
    entries = zero_counts()
    torch.cuda.synchronize()
    ms = []
    for _ in range(VIZ_STEPS):
        t0 = time.perf_counter()
        got = viz_get(url + "/api/live/step?n=1")
        ms.append((time.perf_counter() - t0) * 1e3)
        viz_frame_check(label, got, cpu.step(1), err)
    expect = {n: k * VIZ_STEPS for n, k in VIZ_PER_STEP.items()}
    expect.update({n: VIZ_STEPS for n in fan})
    counts = {n: f.launches for n, f in entries.items()}
    wrong = {n: c for n, c in counts.items() if c != expect.get(n, 0)}
    if wrong:
        raise AssertionError(f"{label}: launches {wrong}, expected "
                             f"{expect} and no other")
    for row in rows:
        row.setdefault("live", []).append(
            {"path": label, "launches": row["entry"].launches})
    if viz_get(url + "/api/live/reset") != {"ok": True}:
        raise AssertionError(f"{label}: /api/live/reset")
    cpu.reset()
    viz_frame_check(label + " after a reset", viz_get(
        url + "/api/live/step?n=3"), cpu.step(3), err)

    live.step(1)
    t0 = time.perf_counter()
    for _ in range(MODE_PROFILE_STEPS):
        live.step(1)
    step_ms = (time.perf_counter() - t0) * 1e3 / MODE_PROFILE_STEPS
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(MODE_PROFILE_STEPS):
            live.step(1)
        torch.cuda.synchronize()
    dev = [e.name for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        raise AssertionError("the profiler saw no CUDA kernels")
    seen = {k: sum(k in n for n in dev) / MODE_PROFILE_STEPS
            for k in kernels}
    log(f"[viz] {label}: 1 world, {VIZ_STEPS} requests of one step, each "
        f"frame within the cpu session's bars (max rel err pos "
        f"{err['pos']:.3g}, yaw {err['yaw']:.3g}); wall ms per request "
        f"mean {np.mean(ms):.2f}, median {np.median(ms):.2f}, min "
        f"{min(ms):.2f} (HTTP and JSON included); a step in process "
        f"{step_ms:.2f} ms; CUDA launches per step "
        f"{len(dev) / MODE_PROFILE_STEPS:.1f} (torch.profiler); per step by "
        f"the counters "
        + ", ".join(f"{n}={c // VIZ_STEPS}" for n, c in counts.items() if c)
        + ", by the profiler "
        + ", ".join(f"{k}={v:g}" for k, v in seen.items())
        + f" on {card}")


def viz_weights(ckpt, tmp, card):
    """(b) tools/convert_weights.py on ``ckpt`` (phase 14's seeded
    save_ckpt file: 2 LSTM-512 policies at full width, written on the
    card): every file read back (ndim, shape, data) bit-equal to
    params_to_jax of the loaded state_dicts, no other file; and
    params_from_jax(params_to_jax(sd)) bit-equal to each sd."""
    import torch
    from madrona_mp_env_tpu_torch.tools import convert_weights
    from madrona_mp_env_tpu_torch.train.convert import (flatten,
                                                        params_from_jax,
                                                        params_to_jax)

    out = os.path.join(tmp, "weights")
    t0 = time.perf_counter()
    convert_weights.convert(ckpt, out, verbose=False)
    secs = time.perf_counter() - t0
    sds = torch.load(ckpt, map_location="cpu", weights_only=True)["params"]
    want = {k.replace("/", "_"): v
            for k, v in flatten(params_to_jax(sds)).items() if v.ndim >= 2}
    nbytes = 0
    for e in range(len(sds)):
        d = os.path.join(out, str(e))
        if sorted(os.listdir(d)) != sorted(want):
            raise AssertionError(f"convert_weights: {d} holds "
                                 f"{sorted(os.listdir(d))}")
        for name, v in want.items():
            with open(os.path.join(d, name), "rb") as f:
                ndim = int(np.fromfile(f, np.int32, 1)[0])
                shape = tuple(int(x) for x in np.fromfile(f, np.int32, ndim))
                data = np.fromfile(f, np.float32)
            ref = np.ascontiguousarray(v[e], np.float32).reshape(-1)
            if ndim != v.ndim - 1 or shape != v.shape[1:] or not \
                    np.array_equal(data.view(np.int32), ref.view(np.int32)):
                raise AssertionError(f"convert_weights: {e}/{name} is not "
                                     f"params_to_jax's")
            nbytes += os.path.getsize(os.path.join(d, name))
    for sd, back in zip(sds, params_from_jax(params_to_jax(sds))):
        if sd.keys() != back.keys() or not all(torch.equal(
                sd[k].view(torch.int32), back[k].view(torch.int32))
                for k in sd):
            raise AssertionError("params_from_jax(params_to_jax(sd)) is not "
                                 "sd")
    if sorted(os.listdir(out)) != sorted(str(e) for e in range(len(sds))):
        raise AssertionError(f"convert_weights: {sorted(os.listdir(out))}")
    hidden = sds[0]["actor_rnn.h_proj.weight"].shape[1]
    log(f"[viz] (b) convert_weights on phase 14's checkpoint ({len(sds)} "
        f"policies, LSTM-{hidden}, written on {card}): {len(want)} files a "
        f"policy, {nbytes} bytes, {secs:.2f} s on the host; each file "
        f"bit-equal to params_to_jax, params_from_jax(params_to_jax(sd)) "
        f"bit-equal to sd")


def viz_viewer(data, record):
    """(c) tools/viewer.py's frame readers on the card's record and event
    log: frames_from_record's pos, yaw, hp, alive, fired and step equal to
    ViewerData.replay_frame's for every step and world;
    frames_from_snapshots one frame a step, every event of event_list at
    a step of its world's frames, its positions those of the record
    within the snapshot's int16 truncation (< 1). Nothing is rendered:
    that needs matplotlib (tests/test_torch_viewer_tools.py on the
    CPU)."""
    import importlib.util

    from madrona_mp_env_tpu_torch.tools import viewer

    n_events = 0
    gap = 0.0
    for w in range(VIZ_LOG_WORLDS):
        rec = list(viewer.frames_from_record(record, VIZ_LOG_WORLDS, w))
        snaps = list(viewer.frames_from_snapshots(data.snapshots, w))
        if len(rec) != VIZ_LOG_STEPS or len(snaps) != VIZ_LOG_STEPS:
            raise AssertionError(f"viewer: {len(rec)} / {len(snaps)} frames "
                                 f"of world {w}")
        for s, fr in enumerate(rec):
            want = data.replay_frame(s, w)
            for k in ("pos", "yaw", "hp", "alive", "fired", "step"):
                if np.asarray(fr[k]).tolist() != want[k]:
                    raise AssertionError(f"viewer: {k} of step {s} world {w}"
                                         f" differs from replay_frame's")
        steps = {fr["step"] for fr in snaps}
        events = data.event_list(w)["events"]
        lost = [e for e in events if e["step"] not in steps]
        if lost:
            raise AssertionError(f"viewer: events at steps without a frame:"
                                 f" {lost[:5]}")
        n_events += len(events)
        gap = max(gap, max(float(np.abs(a["pos"] - b["pos"]).max())
                           for a, b in zip(rec, snaps)))
    if gap >= 1.0 or n_events == 0:
        raise AssertionError(f"viewer: snapshot positions {gap} from the "
                             f"record's, {n_events} events")
    mpl = importlib.util.find_spec("matplotlib") is not None
    log(f"[viz] (c) viewer frame readers on the card's record and event log "
        f"({VIZ_LOG_WORLDS} worlds x {VIZ_LOG_STEPS} steps): record frames "
        f"equal to replay_frame, {n_events} events at snapshot frames, "
        f"snapshot pos within {gap:.3f} of the record's; not rendered "
        f"(matplotlib {'present' if mpl else 'absent'} here; rendering is "
        f"tested on the CPU)")


def viz_phase(mt, cfg, rows_of, ckpt, card):
    """Phase 17: the viz server on cuda (VIZ_LIVE; the routes once, on the
    first configuration's server, given the record, event log and DB of
    viz_logs), convert_weights on ``ckpt``, the viewer's frame readers.
    ``rows_of(scene, *names)`` gives the kernel rows of a scene tag. The
    phase logs its own seconds."""
    import shutil
    import tempfile

    import torch
    from madrona_mp_env_tpu_torch.tools import viz_server

    t = [time.perf_counter()]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_viz_")
    try:
        record, events, db = viz_logs(mt, cfg, tmp)
        t.append(time.perf_counter())
        for i, (label, scene, ts, tags, fan, kernels) in enumerate(VIZ_LIVE):
            t_cfg = time.perf_counter()
            logs = dict(record=record, num_worlds=VIZ_LOG_WORLDS,
                        event_log=events, db=db) if i == 0 else {}
            data = viz_server.ViewerData(scene, live=True, team_size=ts,
                                         device="cuda", **logs)
            cpu = viz_server.LiveSession(scene, team_size=ts, device="cpu")
            # each kernel's row: the first tag that holds it
            rows, names = [], set()
            for tag in tags:
                for row in rows_of(tag, *VIZ_ROWS):
                    name = row["name"].split(" [")[0]
                    if name not in names and row["entry"].__name__ in (
                            tuple(VIZ_PER_STEP) + fan):
                        rows.append(row)
                        names.add(name)
            url, httpd = viz_start(data)
            try:
                if i == 0:
                    n_events, n_rows = viz_routes(url, data, db)
                    log(f"[viz] (a) the routes on cuda: page, map, replay "
                        f"meta and frames, {n_events} events, the canned "
                        f"queries' rows {n_rows} held to sqlite, a DELETE "
                        f"refused")
                viz_live(label, url, data.live, cpu, rows, fan,
                         dict(VIZ_KERNELS, **kernels), card)
            finally:
                httpd.shutdown()
                httpd.server_close()
            if i == 0:
                first = data
            del data, cpu
            torch.cuda.empty_cache()
            log(f"[viz] {label}: {time.perf_counter() - t_cfg:.1f} s, the "
                f"sessions' set-up on cuda and cpu included")
        t.append(time.perf_counter())
        viz_weights(ckpt, tmp, card)
        t.append(time.perf_counter())
        viz_viewer(first, record)
        t.append(time.perf_counter())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    dt = [b - a for a, b in zip(t, t[1:])]
    log(f"[viz] phase {t[-1] - t[0]:.1f} s: logging run {dt[0]:.1f}, "
        f"server and live sessions {dt[1]:.1f}, convert_weights "
        f"{dt[2]:.1f}, viewer {dt[3]:.1f}")


def tables_phase(card):
    """``python3 chip_smoke.py --tables``: the table builders at their full
    defaults on the card, outside the no-argument run (minutes): (a)
    load_map(build_culling=True) on a copy of simple_map without
    culling_ray.npz (it builds culling.npz too, which simple_map lacks),
    each build's seconds, battery chunks, device seconds and K4 dense
    launches, the new sensor-ray table's bits against the committed one
    and verify_ray_tables on it; (b) tools/build_culling.py --k-max 1152
    --verify on a copy of town_map without culling.npz, in a process of
    its own, its JSON line, the new table's bits against the committed
    one, and the committed table under the same check. The CLI's exit
    code is logged, not held: its 1e-5 bar is not reached on town_map
    (ROADMAP Queue 3)."""
    import shutil
    import tempfile

    import torch
    from madrona_mp_env_tpu_torch import EnvConfig
    from madrona_mp_env_tpu_torch.assets.map_data import load_map
    from madrona_mp_env_tpu_torch.ops import culling, raycast

    tmp = tempfile.mkdtemp(prefix="chip_smoke_tables_")
    try:
        scene = os.path.join(tmp, "simple_map")
        shutil.copytree(SCENE, scene)
        os.remove(os.path.join(scene, "culling_ray.npz"))
        stats = {}

        def with_stats(build):
            def run(*args, **kw):
                st = stats.setdefault(build.__name__, {})
                raycast.sphere_cast.launches = 0
                t0 = time.perf_counter()
                out = build(*args, stats=st, **kw)
                torch.cuda.synchronize()
                st["seconds"] = time.perf_counter() - t0
                st["k4_dense_launches"] = raycast.sphere_cast.launches
                return out
            return run

        t0 = time.perf_counter()
        with mock.patch.object(culling, "build_cell_tables", with_stats(
                culling.build_cell_tables)), mock.patch.object(
                culling, "build_ray_tables", with_stats(
                    culling.build_ray_tables)):
            m = load_map(scene, EnvConfig(team_size=TEAM_SIZE),
                         device="cuda", build_culling=True)
        log(f"[tables] (a) load_map(build_culling=True) simple_map: "
            f"{time.perf_counter() - t0:.1f} s, PVS K {m.cells.K}, "
            f"sensor-ray K {m.ray_cells.K}")
        for name, st in stats.items():
            log(f"[tables] (a) {build_line(name, st, st['seconds'])}: "
                f"{len(st['round_bits'])} rounds, K4 dense launches "
                f"{st['k4_dense_launches']} on {card}")
        with np.load(os.path.join(scene, "culling_ray.npz")) as new, \
                np.load(os.path.join(SCENE, "culling_ray.npz")) as old:
            a, b = table_bits(new["cand_idx"], old["cand_idx"])
            log(f"[tables] (a) culling_ray.npz: K {int(new['K'])} "
                f"(committed {int(old['K'])}), k_raw {int(new['k_raw'])} "
                f"({int(old['k_raw'])}); bits only new {a}, only committed "
                f"{b}, of {int((old['cand_idx'] >= 0).sum())}")
        tv, wp = map_inputs(scene)
        log(f"[tables] (a) verify_ray_tables: "
            f"{culling.verify_ray_tables(tv, m.ray_cells, walkable_points=wp)}")
        del m

        town = os.path.join(tmp, "town_map")
        shutil.copytree(TOWN, town)
        os.remove(os.path.join(town, "culling.npz"))
        t0 = time.perf_counter()
        p = subprocess.run(
            [sys.executable, "-m", "madrona_mp_env_tpu_torch.tools."
             "build_culling", town, "--k-max", "1152", "--verify"],
            cwd=REPO, capture_output=True, text=True, timeout=1800)
        line = [x for x in p.stdout.splitlines() if x.startswith("{")]
        if not line:
            raise AssertionError(f"[tables] build_culling: {p.stderr[-2000:]}")
        res = json.loads(line[-1])
        log(f"[tables] (b) build_culling town_map --k-max 1152 --verify: "
            f"exit {p.returncode} ({'passes' if p.returncode == 0 else 'fails'}"
            f" the 1e-5 bar) in {time.perf_counter() - t0:.1f} s: "
            f"{json.dumps(res)} on {card}")
        with np.load(os.path.join(town, "culling.npz")) as new, \
                np.load(os.path.join(TOWN, "culling.npz")) as old:
            a, b = table_bits(new["cand_idx"], old["cand_idx"])
            log(f"[tables] (b) culling.npz: K {int(new['K'])} (committed "
                f"{int(old['K'])}), k_raw {int(new['k_raw'])} "
                f"({int(old['k_raw'])}), mean {float(new['mean_count']):.2f}"
                f" ({float(old['mean_count']):.2f}); bits only new {a}, "
                f"only committed {b}, of {int((old['cand_idx'] >= 0).sum())}")
        tv, wp = map_inputs(TOWN)
        committed = culling.load_or_build_cell_tables(
            tv, TOWN, build_if_missing=False, device="cuda")
        log(f"[tables] (b) the committed culling.npz under the same check: "
            + str(culling.verify_tables(tv, committed, n_rays=500000,
                                        n_casts=100000, walkable_points=wp)))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> int:
    import shutil
    import tempfile

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import madrona_mp_env_tpu_torch as mt
    from madrona_mp_env_tpu_torch.ops import cuda_build

    if sys.argv[1:] == ["--tables"]:
        card = card_line()
        log(f"[card] {card}")
        cuda_build.build_all()
        tables_phase(card)
        print(card, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if sys.argv[1:] == ["--cards"]:
        card = card_line()
        cuda_build.build_all()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        cards_phase(torch.cuda.device_count(), card)
        print(card, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    t_main = time.perf_counter()

    def mark(phase):
        """Log the wall s since the start after ``phase``."""
        log(f"[time] after phase {phase}: "
            f"{time.perf_counter() - t_main:.1f} s")

    # 1. the card
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[card] {card}")
    log(f"[versions] python {sys.version.split()[0]} torch {torch.__version__}"
        f" cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build
    t0 = time.perf_counter()
    cuda_build.build_all()
    log(f"[build] {len(cuda_build.KERNEL_SOURCES)} kernels in "
        f"{time.perf_counter() - t0:.1f} s -> {cuda_build.BUILD_DIR}")
    # the fused movement's registers and spills (ptxas -v)
    for line in cuda_build.build_log("move_fused").splitlines():
        if "registers" in line or "spill" in line or "properties" in line:
            log(f"[build] move_fused: {line.strip()}")
    # the register-blocked kernels K2, K6, K7 and K1 (csrc/fan_sweep_rb.cuh),
    # K4 dense and K8 (the K4 culled and K4' rows carry their own), K3,
    # K3x and K5 with their predecessors
    for src, kern in (("fan_tris", "fan_tris_rb_kernel"),
                      ("fan_culled", "fan_culled_rb_kernel"),
                      ("fan_flat", "fan_flat_rb_kernelILi4E"),
                      ("ray_tris", "ray_tris_rb_kernelILi2E"),
                      ("sphere_cast", "sc_dense_kernelILb0E"),
                      ("sphere_cast", "sc_dense_kernelILb1E"),
                      ("sphere_cast", "sphere_cast_dense_kernelILb0E"),
                      ("sphere_cast", "sphere_cast_dense_kernelILb1E"),
                      ("fan_capsules", "fan_capsules_kernel"),
                      ("fan_capsules", "fan_capsules_v1_kernel"),
                      ("fan_capsules", "fan_capsules_explicit_kernel"),
                      ("tail_fused", "tail_fused_kernelILi16ELb0E"),
                      ("tail_fused", "tail_fused_kernelILi32ELb0E"),
                      ("tail_fused", "tail_fused_kernelILi16ELb1E"),
                      ("tail_fused", "tail_fused_kernelILi32ELb1E"),
                      ("tail_fused", "tail_fused_v1_kernel")):
        regs, spill = cuda_build.ptxas_usage(src, kern)
        log(f"[build] {kern}: {regs} registers, {spill} bytes spilled")

    cfg = mt.EnvConfig(
        task=mt.Task.Zone, team_size=TEAM_SIZE,
        sim_flags=mt.SimFlags.StaggerStarts | mt.SimFlags.RandomFlipTeams,
    )
    acts = bench_actions(NUM_WORLDS, cfg.num_agents, NUM_STEPS)

    # 3. kernels vs plain versions on one real step's launches, each map
    env = mt.Env(cfg, SCENE, num_worlds=NUM_WORLDS, seed=5, device="cuda")
    state, _ = env.reset()
    sensor_syncs(env, state, "simple_map")
    simple = simple_kernels(env, state, actions_at(env, acts, 0))
    town_env = mt.Env(cfg, TOWN, num_worlds=NUM_WORLDS, seed=5,
                      device="cuda")
    state, _ = town_env.reset()
    sensor_syncs(town_env, state, "town_map")
    town = town_kernels(town_env, state, actions_at(town_env, acts, 0))
    del state
    # Zone 3v3 on each map: K7 (and K5 at team size 3) on a real step
    cfg3 = dataclasses.replace(cfg, team_size=3)
    acts3 = bench_actions(NUM_WORLDS, cfg3.num_agents, TEAM3_STEPS)
    team3 = {}
    for scene in (SCENE, TOWN):
        env3 = mt.Env(cfg3, scene, num_worlds=NUM_WORLDS, seed=5,
                      device="cuda")
        state, _ = env3.reset()
        name = os.path.basename(scene)
        team3[name] = (env3, team3_kernels(env3, state,
                                           actions_at(env3, acts3, 0), name))
        del state
    # K7, K8 and K3x at the kernel bench's shapes, and the bench itself
    bench = [row for scene in (SCENE, TOWN) for ts in (TEAM_SIZE, 3)
             for row in bench_kernels(mt, scene, ts, card)]
    # the probes P3 (each map), P5, P6, P2, P4 and P1, each through its main
    probes = probes_phase(cfg, card)
    kernels = (simple + town + [r for _, rs in team3.values() for r in rs]
               + bench + probes)
    mark(3)

    def rows(scene, *names):
        return [k for k in kernels if k["scene"] == scene
                and k["name"].split(" [")[0] in names]

    # 4. the simple_map path on the card
    main_simple = rows("simple_map", "K1 ray_vs_tris", "K2 ray_fans_vs_tris",
                       "K3 fan_capsules", "K4 sphere_cast_culled",
                       "K4' sphere_cast_packed", "K5 tail_fused")
    state, out, _ = drive_path(
        "slice simple_map", env, acts, NUM_STEPS, main_simple,
        ("sphere_cast", "ray_fans_culled", "fan_cell_order",
         "ray_fans_culled_v9",
         "ray_fans_vs_tris_flat", "apply_velocity_fall_fused"), card)
    expect_launches(main_simple, "K2 ray_fans_vs_tris", NUM_STEPS + 1)
    expect_launches(main_simple, "K1 ray_vs_tris", NUM_STEPS)
    expect_launches(main_simple, "K4 sphere_cast_culled", NUM_STEPS)
    expect_launches(main_simple, "K4' sphere_cast_packed", 3 * NUM_STEPS)
    expect_launches(main_simple, "K3 fan_capsules", NUM_STEPS + 1)
    expect_launches(main_simple, "K5 tail_fused", NUM_STEPS)
    # the same steps with the fused tail and with the unfused chain, in
    # turns (fused, unfused, unfused, fused) from one state
    a0 = actions_at(env, acts, 0)
    runs = [step_profile(env, state, a0, fused_tail=f, profile=p)
            for f, p in ((True, True), (False, True), (False, False),
                         (True, False))]
    fused, unfused = runs[0], runs[1]
    wall_f = (runs[0]["wall_ms"] + runs[3]["wall_ms"]) / 2
    wall_u = (runs[1]["wall_ms"] + runs[2]["wall_ms"]) / 2
    if fused["k5_us"] <= 0.0 or unfused["k5_us"] != 0.0:
        raise AssertionError("K5's kernel missing from the fused profile")
    log(f"[launches] {NUM_WORLDS} worlds, {PROFILE_STEPS} steps each way "
        f"(torch.profiler): CUDA launches per step {fused['launches']:.1f} "
        f"with the fused tail (K5 device time {fused['k5_us']:.2f} us/step), "
        f"{unfused['launches']:.1f} with the unfused chain; wall ms/step "
        f"(fused, unfused, unfused, fused) "
        + ", ".join(f"{r['wall_ms']:.2f}" for r in runs)
        + f": fused {wall_f:.2f}, unfused {wall_u:.2f} on {card}")
    del state, out

    # 4b. the same path on the sensor-ray tables (MPENV_FAN_V9=1): K9 for K2
    with mock.patch.dict(os.environ, MPENV_FAN_V9="1"):
        drive_path("sensor-ray tables simple_map", env, acts, NUM_STEPS,
                   rows("simple_map", "K9 ray_fans_culled_v9"),
                   ("ray_fans_vs_tris", "ray_fans_culled", "fan_cell_order",
                    "sphere_cast",
                    "ray_fans_vs_tris_flat"), card,
                   expect={"fan_capsules": NUM_STEPS + 1,
                           "tail_fused": NUM_STEPS})

    mark(4)
    # 5. the crossplay eval on the card (simple_map's kernels)
    eval_phase(mt, main_simple, card)
    mark(5)

    # 6. K4 dense: the L2/L3/fall casts over the soup (MPENV_SC_PACK=0)
    with mock.patch.dict(os.environ, MPENV_SC_PACK="0"):
        forced = rows("simple_map", "K4 sphere_cast (dense)")
        drive_path("dense casts simple_map", env, acts, FORCED_STEPS,
                   forced, ("sphere_cast_packed",), card)
        expect_launches(forced, "K4 sphere_cast (dense)", 3 * FORCED_STEPS)
    del env

    # 7. the town_map path on the card, then its forced-dense fan route
    town_rows = rows("town_map", "K1 ray_vs_tris", "K3 fan_capsules",
                     "K4 sphere_cast_culled", "K4' sphere_cast_packed",
                     "K5 tail_fused", "K6 ray_fans_culled", "K6 cell order")
    drive_path("slice town_map", town_env, acts, NUM_STEPS, town_rows,
               ("ray_fans_vs_tris", "ray_fans_culled_v9",
                "sphere_cast", "ray_fans_vs_tris_flat",
                "apply_velocity_fall_fused"), card)
    expect_launches(town_rows, "K6 ray_fans_culled", NUM_STEPS + 1)
    expect_launches(town_rows, "K1 ray_vs_tris", NUM_STEPS)
    expect_launches(town_rows, "K6 cell order", NUM_STEPS + 1)
    expect_launches(town_rows, "K4 sphere_cast_culled", NUM_STEPS)
    expect_launches(town_rows, "K4' sphere_cast_packed", 3 * NUM_STEPS)
    expect_launches(town_rows, "K3 fan_capsules", NUM_STEPS + 1)
    expect_launches(town_rows, "K5 tail_fused", NUM_STEPS)
    with mock.patch.dict(os.environ, MPENV_FAN_CULL="0"):
        dense_rows = rows("town_map", "K2 ray_fans_vs_tris")
        drive_path("dense fans town_map", town_env, acts, FORCED_STEPS,
                   dense_rows, ("ray_fans_culled", "fan_cell_order"), card)
        expect_launches(dense_rows, "K2 ray_fans_vs_tris", FORCED_STEPS + 1)
    del town_env

    # 7b. Zone 3v3 on each map: the world fan is K7 alone, on town_map too
    for name, (env3, rows3) in team3.items():
        drive_path(f"Zone 3v3 {name}", env3, acts3, TEAM3_STEPS, rows3,
                   ("ray_fans_vs_tris", "ray_fans_culled", "fan_cell_order",
                    "ray_fans_culled_v9", "sphere_cast"), card,
                   expect={"fan_capsules": TEAM3_STEPS + 1,
                           "tail_fused": TEAM3_STEPS})
        expect_launches(rows3, "K7 ray_fans_vs_tris_flat", TEAM3_STEPS + 1)
        expect_launches(rows3, "K1 ray_vs_tris", TEAM3_STEPS)
    del team3, env3
    mark(7)

    # 8. the training path: full width on the card (float32, bfloat16,
    # float16), then the PBT population
    train_phase(card)
    pbt_phase(card)
    mark(8)

    # 9. kernel path vs plain path
    env_parity(mt, cfg, SCENE, 4, 16)
    env_parity(mt, cfg, TOWN, 4, 16)
    env_parity(mt, cfg3, SCENE, 4, 16)
    env_parity(mt, cfg3, TOWN, 4, 16)
    eval_parity(mt, 4, 16)
    train_parity()
    train_parity(flags=["--bf16"])
    pbt_parity()
    mark(9)

    # 10. the scripted bot: the golden, the vs-bot eval, cuda vs cpu
    bots_phase(mt, cfg, main_simple, town_rows, card)
    mark(10)

    # 11. every game mode and flag
    kernels += modes_phase(mt, card)
    mark(11)

    # 12. the full-team interface and policy, the world and spawn curricula
    kernels += curriculum_phase(mt, card)
    mark(12)

    # 13. the logging step, replay, the eval's dumps, the trajectory
    # curriculum
    kernels += record_phase(mt, cfg, card)
    mark(13)

    # phase 14's seeded checkpoint, which phase 17 exports
    keep = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        # 14. behaviour cloning end to end, the attention backbone
        bc_phase(mt, card, keep)
        mark(14)

        # 15. data parallelism: the CLI's --num-devices, two ranks on the
        # card, the scaling bench
        parallel_phase(main_simple, card)
        mark(15)

        # 16. the offline asset tools: make_town_map, the table builders
        # and verifiers (K4 dense, K1), golden --generate
        kernels += asset_tools_phase(card)
        mark(16)

        # 17. the viewing tools and the weight export: the viz server and
        # its live sim on cuda (K1, K2 / K7 / K6, K3, K4 culled, K4', K5),
        # convert_weights, the viewer's frame readers
        viz_phase(mt, cfg, rows, os.path.join(keep, "0.pt"), card)
        mark(17)
    finally:
        shutil.rmtree(keep, ignore_errors=True)

    # 18. results
    missing = [k["name"] for k in kernels if "launches" not in k]
    if missing:
        raise AssertionError(f"no path drove {missing}")
    line = {"kernels": [
        {k2: k[k2] for k2 in ("name", "route", "source", "replaces",
                              "launches", "max_abs_err", "ms", "plain_ms",
                              "bound_ms", "bound_by", "path")}
        | {"library_ms": k.get("library_ms")}
        | {k2: k[k2] for k2 in REDESIGN_KEYS if k2 in k}
        for k in kernels
    ]}
    print(json.dumps(line), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
