"""Preview the PBT world -> (team policy, team policy) assignment table
(the JAX package's tools/print_assignments.py, the reference's
scripts/print_assignments.py): every ordered pair of policies, each for
num_worlds // P^2 consecutive worlds.

    python -m madrona_mp_env_tpu_torch.tools.print_assignments \\
        <num_worlds> <num_policies>
"""

from __future__ import annotations

import sys
from itertools import product


def print_assignments(num_worlds: int, num_policies: int) -> None:
    num_world_digits = len(str(num_worlds))
    assignments = list(product(range(num_policies), repeat=2))
    num_repeats = num_worlds // len(assignments)

    cur_world_idx = 0
    for assignment in assignments:
        for _ in range(num_repeats):
            print(f"{cur_world_idx:{num_world_digits}}: {assignment}")
            cur_world_idx += 1


if __name__ == "__main__":
    print_assignments(int(sys.argv[1]), int(sys.argv[2]))
