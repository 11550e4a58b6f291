"""Write the town_map fixture of the PyTorch port's tests.

Runs the JAX package's Env on the CPU with make_slice_fixture.py's
configuration and actions (Zone 2v2, 2 worlds, seed 5, StaggerStarts |
RandomFlipTeams, Default reward, policy agents, the unfused scalar tail,
16 steps) on data/town_map, the big map: 6,108 triangles padded to 6,144,
with PVS cell tables (culling.npz). The JAX CPU path sweeps the whole
soup everywhere (its culled fan and packed casts are TPU kernels), so
this rollout is the canon the port's culled path is held to. Records the
actions and the per-step leaves as make_slice_fixture.py does, and the
full state leaves after the steps in FAN_STEPS (``state<s>/<leaf>``),
whose sensor fans tests/test_torch_town.py sweeps.

Regenerate (only after a deliberate change of the JAX reference):

    JAX_PLATFORMS=cpu python tests/fixtures_torch/make_town_fixture.py
"""

from __future__ import annotations

import os

import numpy as np

import make_slice_fixture as fx

HERE = os.path.dirname(os.path.abspath(__file__))
PATH = os.path.join(HERE, "zone_town_map_slice.npz")
SCENE = "town_map"
FAN_STEPS = (0, 8, 15)  # the reset and two later steps


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    states = {}

    def keep(s, state):
        if s + 1 in FAN_STEPS:
            states.update({
                f"state{s + 1}/{k}": np.asarray(getattr(state, k))
                for k in state.__dataclass_fields__
            })

    hist = fx.jax_rollout(scene=SCENE, on_step=keep)
    hist.update(states)
    np.savez_compressed(PATH, **hist)
    print(f"wrote {PATH} ({os.path.getsize(PATH)} bytes)")


if __name__ == "__main__":
    main()
