"""Join the analytics DB with a BC dump -> the filtered BC and KL training
sets (the JAX package's tools/build_trajectory_training_dataset.py, the
reference's scripts/build_trajectory_training_dataset.py).

Inputs: (a) the SQLite analytics DB that data/build_db.py built from an
eval run's event log, (b) a DumpItem stream of selected trajectory steps
(step_id, team_id), e.g. from data/select_trajectories.py, and (c) the raw
BC dump of the same eval run (``--bc-dump-dir``). The join key is
match_steps.global_idx = step * num_worlds + world, the snapshot's write
order. Outputs, in the ``sequences`` layout that train/bc.py's
load_bc_data reads (per trajectory step the acting team's [team_size,
...] rows of each file, and a ``shapes`` JSON):

- the BC set: the selected trajectories;
- the KL set: steps that no selected trajectory covers, cut into
  trajectories of the same length, 10x as many as the BC set's, each step
  with a random team (numpy's default_rng(seed)).

The files are byte-equal to the JAX tool's. The JAX tool re-reads a whole
step block of every file for each (step, world, team) it copies; here
each file is memory-mapped and only the team's rows are read, many
trajectory steps at a time. The actor -> block map is the crossplay
routing the port's EvalManager writes its dump in
(train/infer.py block_assignment).

    python -m madrona_mp_env_tpu_torch.tools.build_trajectory_training_dataset \\
        NUM_WORLDS SQL_DB TRAJECTORIES BC_DUMP_DIR BC_OUT_DIR KL_OUT_DIR
"""

from __future__ import annotations

import json
import os
import sqlite3
import sys

import numpy as np

from ..data.trajectory_db import DUMP_ITEM_DTYPE
from ..train.infer import block_assignment

SEQ_LEN = 20  # trajectory length in steps (reference :71)
ROWS_PER_READ = 2048  # (step, world, team) triples per read


class BCDump:
    """Row access into a raw BC dump directory (EvalManager's layout: per
    step [P, B / P, ...] in policy-block order)."""

    def __init__(self, dump_dir: str, num_worlds: int, num_agents: int,
                 team_size: int):
        with open(os.path.join(dump_dir, "shapes")) as f:
            self.meta = json.load(f)
        self.dir = dump_dir
        self.W, self.A, self.ts = num_worlds, num_agents, team_size
        P = self.meta["actions"][0]
        _, perm = block_assignment(num_worlds, num_agents, team_size, P)
        # perm: block slot -> flat actor; inverted: flat actor -> (p, i)
        BP = num_worlds * num_agents // P
        flat_to_block = np.argsort(perm)
        self.block_p = flat_to_block // BP
        self.block_i = flat_to_block % BP

    def _blocks(self, steps, worlds, teams):
        """The (p, i) block slots [n, ts] of each triple's team."""
        agents = (worlds[:, None] * self.A + teams[:, None] * self.ts
                  + np.arange(self.ts))
        return steps[:, None], self.block_p[agents], self.block_i[agents]

    def team_rows(self, name, dtype, step_shape, steps, worlds, teams):
        """[n, ts, ...] of file ``name`` for n (step, world, team)."""
        mm = np.memmap(os.path.join(self.dir, name), dtype=dtype, mode="r")
        mm = mm.reshape(-1, *step_shape)
        return mm[self._blocks(steps, worlds, teams)]

    def team_rnn(self, steps, worlds, teams):
        """Recurrent states [n, ts, 2, 2, H] for n (step, world, team)."""
        t, p, i = self._blocks(steps, worlds, teams)
        mm = np.memmap(os.path.join(self.dir, "rnn_states"),
                       dtype=np.float32, mode="r")
        mm = mm.reshape(-1, *self.meta["rnn_states"])  # [S, 2, 2, P, BP, H]
        return mm[t, :, :, p, i]  # the indexed axes go first


def dump_trajectories(db: sqlite3.Connection, bc_dump: BCDump,
                      items: np.ndarray, out_dir: str) -> None:
    """items [N, seq_len, 2] (step_id, team_id) -> the ``sequences`` files
    in ``out_dir``: every trajectory step's team rows in order."""
    if items.size == 0:
        raise ValueError("no trajectory steps to write")
    os.makedirs(out_dir, exist_ok=True)
    ids, gis, worlds = (np.asarray(c, np.int64) for c in zip(*db.execute(
        "SELECT id, global_idx, world_id FROM match_steps ORDER BY id")))
    step_ids = items[..., 0].reshape(-1)
    teams = items[..., 1].reshape(-1).astype(np.int64)
    at = np.minimum(np.searchsorted(ids, step_ids), len(ids) - 1)
    missing = ids[at] != step_ids
    if missing.any():
        raise AssertionError(f"no match_steps row {step_ids[missing][0]}")
    gi, world = gis[at], worlds[at]
    steps = gi // bc_dump.W
    if (gi % bc_dump.W != world).any():
        raise AssertionError("global_idx does not match world_id")

    meta = bc_dump.meta
    files = [(k, np.float32, meta["obs"][k]) for k in meta["obs"]]
    files += [("actions", np.int32, meta["actions"]),
              ("action_logits", np.float32, meta["action_logits"]),
              ("rewards", np.float32, meta["rewards"])]
    shapes = {}
    outs = {name: open(os.path.join(out_dir, name), "wb")
            for name in [f[0] for f in files] + ["rnn_states"]}
    try:
        for s in range(0, len(steps), ROWS_PER_READ):
            sl = slice(s, s + ROWS_PER_READ)
            picked = (steps[sl], world[sl], teams[sl])
            for name, dtype, step_shape in files:
                rows = bc_dump.team_rows(name, dtype, step_shape, *picked)
                rows.tofile(outs[name])
                shapes[name] = list(rows.shape[1:])
            rnn = bc_dump.team_rnn(*picked)
            rnn.tofile(outs["rnn_states"])
            shapes["rnn_states"] = list(rnn.shape[1:])
    finally:
        for f in outs.values():
            f.close()
    out_meta = {"layout": "sequences",
                "obs": {k: shapes[k] for k in meta["obs"]}}
    out_meta.update({k: shapes[k] for k in ("actions", "action_logits",
                                            "rewards", "rnn_states")})
    with open(os.path.join(out_dir, "shapes"), "w") as f:
        json.dump(out_meta, f, indent=2)


def build(db_path: str, trajectories_path: str, bc_dump_dir: str,
          bc_out_dir: str, kl_out_dir: str, num_worlds: int,
          team_size: int = 6, seq_len: int = SEQ_LEN, seed: int = 0) -> None:
    db = sqlite3.connect(db_path)
    items = np.fromfile(trajectories_path, dtype=DUMP_ITEM_DTYPE)
    assert len(items) % seq_len == 0
    trajs = np.stack(
        [items["step_id"], items["team_id"]], axis=-1
    ).reshape(-1, seq_len, 2)

    bc_dump = BCDump(bc_dump_dir, num_worlds, 2 * team_size, team_size)
    dump_trajectories(db, bc_dump, trajs, bc_out_dir)

    # KL set: steps not covered by any selected trajectory
    all_steps = np.asarray(
        [
            r[0]
            for r in db.execute(
                "SELECT id FROM match_steps ORDER BY match_id, step_idx"
            ).fetchall()
        ]
    )
    missing = all_steps[~np.isin(all_steps, trajs[..., 0].ravel())]
    truncated = len(missing) // seq_len * seq_len
    missing = missing[:truncated].reshape(-1, seq_len)
    rng = np.random.default_rng(seed)
    take = rng.permutation(missing.shape[0])[: 10 * trajs.shape[0]]
    missing = missing[take]
    teams = rng.integers(0, 2, size=missing.shape)
    kl_trajs = np.stack([missing, teams], axis=-1)
    dump_trajectories(db, bc_dump, kl_trajs, kl_out_dir)
    db.close()


def main(argv=None):
    argv = sys.argv if argv is None else argv
    if len(argv) != 7:
        print(
            f"usage: {argv[0]} NUM_WORLDS SQL_DB TRAJECTORIES "
            "BC_DUMP_DIR BC_OUT_DIR KL_OUT_DIR",
            file=sys.stderr,
        )
        sys.exit(1)
    build(
        db_path=argv[2],
        trajectories_path=argv[3],
        bc_dump_dir=argv[4],
        bc_out_dir=argv[5],
        kl_out_dir=argv[6],
        num_worlds=int(argv[1]),
    )


if __name__ == "__main__":
    main()
