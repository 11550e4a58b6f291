"""Static environment configuration.

The reference passes a TaskConfig struct of pointers + flags into the sim
(reference src/types.hpp:833-880, src/bindings.cpp:38-108). Here the
equivalent is a frozen, hashable dataclass read by the batched step.
Device-resident map data lives separately in assets.map_data.MapData.
The same values as the JAX package's config, so one config drives both.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

from . import consts


class Task(enum.IntEnum):
    """Game mode (reference src/types.hpp:45-51)."""

    Explore = 0
    TDM = 1
    Zone = 2
    Turret = 3
    ZoneCaptureDefend = 4


class RewardMode(enum.IntEnum):
    """Reward variant (reference src/types.hpp:828-831)."""

    Default = 0
    Flank = 1


class SimFlags(enum.IntFlag):
    """Config bitfield (reference src/sim_flags.hpp:7-21)."""

    Default = 0
    SpawnInMiddle = 1 << 0
    RandomizeHPMagazine = 1 << 1
    NavmeshSpawn = 1 << 2
    NoRespawn = 1 << 3
    StaggerStarts = 1 << 4
    EnableCurriculum = 1 << 5
    HardcodedSpawns = 1 << 6
    RandomFlipTeams = 1 << 7
    StaticFlipTeams = 1 << 8
    FullTeamPolicy = 1 << 9
    SimEvalMode = 1 << 10
    SubZones = 1 << 11


@dataclass(frozen=True)
class WeaponStats:
    """Per-weapon-type stats (reference src/types.hpp:53-58).

    Default values follow the single weapon type the reference manager
    installs (reference src/mgr.cpp:1383-1395).
    """

    mag_size: int = 30
    reload_time: int = 30
    dmg_per_bullet: float = 10.0
    accuracy_scale: float = 0.005


@dataclass(frozen=True)
class RewardHyperParamsDefaults:
    """Default reward coefficients (reference src/types.hpp:254-264).

    At runtime these live as a per-agent [A, 9] tensor (PBT-explorable,
    exported as `reward_coefs`); these defaults fill it.
    """

    team_spirit: float = 0.0
    shot_scale: float = 0.5
    explore_scale: float = 0.005
    in_zone_scale: float = 0.05
    zone_team_contest_scale: float = 0.01
    zone_team_ctrl_scale: float = 0.1
    zone_dist_scale: float = 0.0005
    zone_earned_point_scale: float = 1.0
    breadcrumb_scale: float = 0.1

    def as_tuple(self) -> tuple:
        return (
            self.team_spirit,
            self.shot_scale,
            self.explore_scale,
            self.in_zone_scale,
            self.zone_team_contest_scale,
            self.zone_team_ctrl_scale,
            self.zone_dist_scale,
            self.zone_earned_point_scale,
            self.breadcrumb_scale,
        )


# indices into the reward_coefs [A, 9] tensor
RC_TEAM_SPIRIT = 0
RC_SHOT_SCALE = 1
RC_EXPLORE_SCALE = 2
RC_IN_ZONE_SCALE = 3
RC_ZONE_TEAM_CONTEST_SCALE = 4
RC_ZONE_TEAM_CTRL_SCALE = 5
RC_ZONE_DIST_SCALE = 6
RC_ZONE_EARNED_POINT_SCALE = 7
RC_BREADCRUMB_SCALE = 8
NUM_REWARD_COEFS = 9


@dataclass(frozen=True)
class EnvConfig:
    """Hashable static config for the env step.

    Equivalent of the reference's Manager::Config + TaskConfig statics
    (reference src/mgr.hpp:30-52, src/types.hpp:833-880).
    """

    task: Task = Task.Zone
    sim_flags: SimFlags = SimFlags.Default
    reward_mode: RewardMode = RewardMode.Default
    team_size: int = consts.max_team_size
    auto_reset: bool = True
    weapons: tuple = (WeaponStats(),)
    reward_defaults: RewardHyperParamsDefaults = field(
        default_factory=RewardHyperParamsDefaults
    )
    episode_len: int = consts.episode_len
    # high-level movement mode: combat is auto-resolved (hlBattleSystem,
    # sim.cpp:1346-1441 replaces fireSystem — TaskConfig.highlevelMove)
    highlevel_move: bool = False
    # capacity of the per-world breadcrumb pool; the reference allocates
    # entities dynamically, we use a fixed ring (1 active crumb chain per
    # agent, decaying over penalty/decay = 40 steps; new crumb at most every
    # 10 steps -> <= 4 live crumbs per agent typical; 6/agent is safe).
    breadcrumb_pool_per_agent: int = 6
    # trajectory curriculum restore probability at reset
    # (level_gen.cpp:499); read only on a map with curriculum snapshots
    # (Env's curriculum_path, sim/reset.py)
    trajectory_curriculum_prob: float = 0.5
    # the navmesh spawn curriculum (reference src/sim.cpp:5915-5924) and
    # its Manager::Config::enableSpawnCurriculum gate: with probability
    # use_curriculum_spawn_prob an episode spawns both teams on a pair of
    # navmesh regions of a tier drawn from curriculum_tier_probs
    # (assets/spawn_curriculum.py, sim/reset.py, sim/spawn.py)
    enable_spawn_curriculum: bool = False
    use_curriculum_spawn_prob: float = 1.0
    curriculum_tier_probs: tuple = (0.0, 0.0, 0.3, 0.3, 0.4)

    @property
    def num_agents(self) -> int:
        if self.task == Task.Explore:
            return 1
        # Turret task: team 1's rows are the turrets (frozen in place,
        # driven by the auto-aim controller, sim/turret.py)
        return self.team_size * 2

    @property
    def effective_weapons(self) -> tuple:
        """Weapon table including the turret weapon for the Turret task
        (accuracy 0.15, dmg 10, auto-reload 15; sim.cpp:1728-1755)."""
        if self.task == Task.Turret:
            return self.weapons + (
                WeaponStats(mag_size=30, reload_time=15, dmg_per_bullet=10.0,
                            accuracy_scale=0.15),
            )
        return self.weapons

    @property
    def num_weapon_types(self) -> int:
        return len(self.effective_weapons)

    @property
    def breadcrumb_pool_size(self) -> int:
        return self.breadcrumb_pool_per_agent * self.num_agents

    def has_flag(self, flag: SimFlags) -> bool:
        return (self.sim_flags & flag) == flag
