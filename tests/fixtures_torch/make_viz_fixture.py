"""Write the live-session fixture of the PyTorch port's viewer tests.

Runs the JAX package's viz server session (tools/viz_server.py
LiveSession: Zone 2v2 on data/simple_map, 1 world, seed 0, every agent
the scripted A* bot, the jitted step) on the CPU through CALLS, the same
step / reset sequence tests/test_torch_viz.py sends the port's server,
and writes the JSON frame of each step call to viz_live_jax.json beside
this file: {"scene", "team_size", "seed", "calls", "frames"}.

Regenerate (only after a deliberate change of the JAX reference):

    JAX_PLATFORMS=cpu python tests/fixtures_torch/make_viz_fixture.py

(~1 min: the jit of the step). It refuses any JAX backend other than the
CPU.
"""

from __future__ import annotations

import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
PATH = os.path.join(HERE, "viz_live_jax.json")
SCENE = "simple_map"
TEAM_SIZE = 2
SEED = 0
# ("step", n) answers a frame; ("reset", 0) answers {"ok": true}
CALLS = (("step", 2), ("step", 1), ("reset", 0), ("step", 1))


def run(session) -> list:
    """The frames ``session`` (a LiveSession of either package) answers
    to CALLS' step calls, in order."""
    frames = []
    for call, n in CALLS:
        if call == "step":
            frames.append(session.step(n))
        else:
            session.reset()
    return frames


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    if jax.default_backend() != "cpu":
        raise RuntimeError("the viz fixture needs the CPU backend; run with "
                           "JAX_PLATFORMS=cpu")
    sys.path.insert(0, REPO)
    from madrona_mp_env_tpu.tools.viz_server import LiveSession

    session = LiveSession(os.path.join(REPO, "data", SCENE),
                          team_size=TEAM_SIZE, seed=SEED)
    out = {"scene": SCENE, "team_size": TEAM_SIZE, "seed": SEED,
           "calls": [list(c) for c in CALLS], "frames": run(session)}
    with open(PATH, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(f"wrote {PATH}")


if __name__ == "__main__":
    main()
