"""Write the Zone 3v3 fixture of the PyTorch port's tests.

Runs the JAX package's Env on the CPU with make_slice_fixture.py's
configuration and actions at team_size 3 (Zone 3v3 on data/simple_map, 2
worlds, seed 5, StaggerStarts | RandomFlipTeams, Default reward, policy
agents, the unfused scalar tail, 16 steps). Each agent's LOS run holds
4 x 3 = 12 rays, not a multiple of 8, so the JAX package sends its
sensor fans to the stacked-direction fallback (K7 on the TPU, the dense
sweep on the CPU), an odd team size's path. Records the actions and the
per-step leaves as make_slice_fixture.py does into
zone3v3_simple_map_slice.npz beside this file, which
tests/test_torch_team3.py replays through the port.

Regenerate (only after a deliberate change of the JAX reference):

    JAX_PLATFORMS=cpu python tests/fixtures_torch/make_team3_fixture.py
"""

from __future__ import annotations

import os

import numpy as np

import make_slice_fixture as fx

HERE = os.path.dirname(os.path.abspath(__file__))
PATH = os.path.join(HERE, "zone3v3_simple_map_slice.npz")
TEAM_SIZE = 3


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    hist = fx.jax_rollout(team_size=TEAM_SIZE)
    np.savez_compressed(PATH, **hist)
    print(f"wrote {PATH} ({os.path.getsize(PATH)} bytes)")


if __name__ == "__main__":
    main()
