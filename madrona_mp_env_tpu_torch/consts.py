"""Game constants.

Mirrors the reference's compile-time constants (reference src/consts.hpp:8-73)
so trajectories are comparable. A copy of the JAX package's table, kept
here so the port imports nothing from that package.
"""

import math

max_team_size = 6
max_zones = 5
num_steps_per_zone = 600
zone_point_interval = 20
zone_win_points = 125
pose_transition_speed = 10

agent_radius = 15.0
stand_height = 65.0
crouch_height = 47.0
prone_height = 30.0

max_run_velocity = 400.0
max_walk_velocity = 200.0
max_crouch_velocity = 50.0
max_prone_velocity = 20.0
deaccelerate_rate = 1000.0

respawn_invincible_steps = 5
num_out_of_combat_steps_before_autoheal = 150
autoheal_amount_per_step = 5.0

episode_len = 3000

num_move_amount_buckets = 3
num_move_angle_buckets = 8
num_turn_buckets = 5

fwd_lidar_width = 32
fwd_lidar_height = 2
rear_lidar_width = 8
rear_lidar_height = 2

max_num_weapon_types = 3

delta_t = 0.05

a_star_policy_id = -1

discrete_aim_num_yaw_buckets = 13
discrete_aim_num_pitch_buckets = 7

fall_rate = 386.08858267717  # gravity-limited fall speed, u/s (sim.cpp:1051)

# discreteTurnDelta() (reference src/sim.cpp:293-298)
discrete_turn_delta = 10.0 / (num_turn_buckets // 2)

# explore tracker grid (reference src/types.hpp:500-508)
explore_grid_width = 81
explore_grid_height = 81
explore_grid_max_x = explore_grid_width // 2
explore_grid_max_y = explore_grid_height // 2

# breadcrumbs (reference src/sim.cpp:4845-4926)
breadcrumb_penalty = 1.0
breadcrumb_frequency = 10
breadcrumb_decay = 0.025
breadcrumb_radius_scale = 4.0  # * agent_radius

max_spawns = 128  # SpawnUsageCounter::maxNumSpawns (types.hpp:96)

pi = math.pi
