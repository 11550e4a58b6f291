"""Record / replay, event logs and the analytics pipeline.

play -> events -> SQLite -> selected snapshots -> curriculum resets, the
reference's pipeline (src/mgr.cpp:376-505, src/build_db.cpp,
src/trajectory_db.cpp, src/build_trajectory_curriculum.cpp) as the JAX
package's data/ package runs it. The step's exports (export.py) are
tensors on the Env's device; everything else is numpy and sqlite3 on the
host, and the binary files are byte-compatible with the reference's and
the JAX package's.
"""

from .formats import (
    AGENT_LOG_DTYPE,
    CURRICULUM_SNAPSHOT_DTYPE,
    EventType,
    GAME_EVENT_DTYPE,
    PACKED_MATCH_STATE_DTYPE,
    PACKED_PLAYER_DTYPE,
    PACKED_STEP_SNAPSHOT_DTYPE,
    PackedPlayerStateFlags,
    STEP_LOG_DTYPE,
    TEAM_HULL_DTYPE,
    load_curriculum_snapshots,
)
from .recorder import (
    EventLogWriter,
    RecordLogWriter,
    ReplayLogReader,
    read_event_log,
    read_step_snapshots,
)
