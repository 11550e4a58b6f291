"""Binary record, event and curriculum formats (numpy structured dtypes).

The layouts are the reference's raw struct dumps byte for byte (reference
src/types.hpp), the same as the JAX package's data/formats.py:

- ``StepLog`` of 12 ``AgentLogData`` (types.hpp:574-589): the
  full-precision record that replays a step, StepLog[num_worlds] appended
  per step (mgr.cpp:481-505);
- ``PackedStepSnapshot`` of 12 ``PackedPlayerSnapshot`` and a
  ``PackedMatchState`` (types.hpp:596-635): the quantized per-step
  snapshot of steps.bin;
- ``GameEvent`` (types.hpp:729-760): the tagged union of events.bin
  (writeGameEvents, mgr.cpp:104-117);
- ``CurriculumSnapshot`` (types.hpp:816-819): the snapshots a
  trajectory-curriculum reset restores (mgr.cpp:1424-1441);
- ``TeamConvexHull`` (types.hpp:724-727): the int16 XY hull of a team,
  a blob of the analytics DB (build_db.cpp:9-72).
"""

from __future__ import annotations

import numpy as np


class EventType:
    """EventType bitmask (types.hpp:712-718)."""

    NONE = 0
    CAPTURE = 1 << 0
    RELOAD = 1 << 1
    KILL = 1 << 2
    PLAYER_SHOT = 1 << 3


class PackedPlayerStateFlags:
    """PackedPlayerStateFlags (types.hpp:596-601)."""

    NONE = 0
    FIRED_SHOT = 1 << 1
    CROUCH = 1 << 2
    PRONE = 1 << 3


MAX_PLAYERS = 12  # two teams of consts.max_team_size


def _struct(fields, itemsize):
    """A packed structured dtype from (name, format, offset) triples."""
    names, formats, offsets = zip(*fields)
    return np.dtype({"names": list(names), "formats": list(formats),
                     "offsets": list(offsets), "itemsize": itemsize})


# AgentLogData, 72 bytes: position, aim (yaw, pitch, quaternion w x y z),
# hp, magazine, stand state, shotAgentIdx, firedShotT, kill flags, 2 pad
AGENT_LOG_DTYPE = _struct([
    ("pos", ("<f4", (3,)), 0),
    ("aim_yaw", "<f4", 12),
    ("aim_pitch", "<f4", 16),
    ("aim_rot", ("<f4", (4,)), 20),
    ("hp", "<f4", 36),
    ("mag_bullets", "<i4", 40),
    ("mag_reloading", "<i4", 44),
    ("stand_cur", "<i4", 48),
    ("stand_tgt", "<i4", 52),
    ("stand_transition", "<i4", 56),
    ("shot_agent_idx", "<i4", 60),
    ("fired_shot_t", "<f4", 64),
    ("was_killed", "u1", 68),
    ("successful_kill", "u1", 69),
], 72)

# StepLog, 868 bytes: 12 AgentLogData + curStep
STEP_LOG_DTYPE = _struct([
    ("agent_data", (AGENT_LOG_DTYPE, (MAX_PLAYERS,)), 0),
    ("cur_step", "<i4", 864),
], 868)

# PackedPlayerSnapshot, 14 bytes
PACKED_PLAYER_DTYPE = _struct([
    ("pos", ("<i2", (3,)), 0),
    ("yaw", "<i2", 6),
    ("pitch", "<i2", 8),
    ("mag_bullets", "u1", 10),
    ("is_reloading", "u1", 11),
    ("hp", "u1", 12),
    ("flags", "u1", 13),
], 14)

# PackedMatchState, 8 bytes
PACKED_MATCH_STATE_DTYPE = _struct([
    ("step", "<u2", 0),
    ("cur_zone", "u1", 2),
    ("cur_zone_controller", "i1", 3),
    ("zone_steps_remaining", "<u2", 4),
    ("steps_until_point", "<u2", 6),
], 8)

# PackedStepSnapshot, 192 bytes
PACKED_STEP_SNAPSHOT_DTYPE = _struct([
    ("num_events", "<u4", 0),
    ("event_mask", "<u4", 4),
    ("match_id", "<u8", 8),
    ("match_state", PACKED_MATCH_STATE_DTYPE, 16),
    ("players", (PACKED_PLAYER_DTYPE, (MAX_PLAYERS,)), 24),
], 192)

# GameEvent, 24 bytes. The 4-byte union at offset 20 as two u8 fields and
# one u16, which cover every variant:
#   Capture:    a = zone, b = capturing team, c = inZoneMask
#   Reload:     a = player, b = bullets at reload time
#   Kill:       a = killer, b = killed
#   PlayerShot: a = attacker, b = target
GAME_EVENT_DTYPE = _struct([
    ("type", "<u4", 0),
    ("match_id", "<u8", 8),
    ("step", "<u4", 16),
    ("a", "u1", 20),
    ("b", "u1", 21),
    ("c", "<u2", 22),
], 24)

# CurriculumSnapshot, 176 bytes
CURRICULUM_SNAPSHOT_DTYPE = _struct([
    ("match_state", PACKED_MATCH_STATE_DTYPE, 0),
    ("players", (PACKED_PLAYER_DTYPE, (MAX_PLAYERS,)), 8),
], 176)

# TeamConvexHull, 26 bytes: numVerts + 6 int16 XY vertices
TEAM_HULL_DTYPE = _struct([
    ("num_verts", "<i2", 0),
    ("verts", ("<i2", (6, 2)), 2),
], 26)

# the unpacked curriculum layout load_map takes: per snapshot the match
# state (step, zone, controller, steps remaining, until point) and per
# player (pos xyz, yaw, pitch, bullets, reloading, hp, flags)
CURRICULUM_DTYPE = np.dtype([("match_state", "<i4", (5,)),
                             ("players", "<f4", (MAX_PLAYERS, 9))])
MATCH_STATE_FIELDS = ("step", "cur_zone", "cur_zone_controller",
                      "zone_steps_remaining", "steps_until_point")


def make_match_id(world_idx, episode_idx) -> np.ndarray:
    """matchID = (worldIdx << 32) | curEpisodeIdx (sim.cpp:736-738)."""
    return (np.asarray(world_idx, np.uint64) << np.uint64(32)) | np.asarray(
        episode_idx, np.uint64)


def load_curriculum_snapshots(path: str) -> np.ndarray:
    """A CurriculumSnapshot file -> [S] records of CURRICULUM_DTYPE (the
    layout load_map takes); angles back to radians (i16 * pi / 32768)."""
    raw = np.fromfile(path, dtype=CURRICULUM_SNAPSHOT_DTYPE)
    out = np.zeros(len(raw), dtype=CURRICULUM_DTYPE)
    for j, name in enumerate(MATCH_STATE_FIELDS):
        out["match_state"][:, j] = raw["match_state"][name]
    pl, dst = raw["players"], out["players"]
    dst[:, :, 0:3] = pl["pos"]
    dst[:, :, 3] = pl["yaw"].astype(np.float32) * (np.pi / 32768.0)
    dst[:, :, 4] = pl["pitch"].astype(np.float32) * (np.pi / 32768.0)
    dst[:, :, 5] = pl["mag_bullets"]
    dst[:, :, 6] = pl["is_reloading"]
    dst[:, :, 7] = pl["hp"]
    dst[:, :, 8] = pl["flags"]
    return out


def save_curriculum_snapshots(path: str, match_state: np.ndarray,
                              players_quantized: np.ndarray) -> None:
    """Write CurriculumSnapshot records (build_trajectory_curriculum's
    output, build_trajectory_curriculum.cpp:150-160): match_state [S, 5]
    ints (MATCH_STATE_FIELDS), players_quantized [S, 12] of
    PACKED_PLAYER_DTYPE."""
    raw = np.zeros(len(match_state), dtype=CURRICULUM_SNAPSHOT_DTYPE)
    for j, name in enumerate(MATCH_STATE_FIELDS):
        raw["match_state"][name] = match_state[:, j]
    raw["players"] = players_quantized
    raw.tofile(path)
