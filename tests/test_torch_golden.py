"""The port against the committed 100-step golden
tests/goldens/zone_simple_map.npz (the JAX package's CPU trajectory of
scripted-bot self-play: Zone 2v2 on simple_map, 2 worlds, seed 7, every
agent a bot), through madrona_mp_env_tpu_torch.tools.golden on the CPU.

Bar (tools/golden.py): pos within 1e-4 * max(1, |pos|) marks the first
divergence; up to it hp and team points exact and reward within 1e-4 *
max(1, |reward|). Measured on the CPU (tools/golden.py --cpu, the plain
path): pos holds for all 100 steps (largest error 2.80e-5 relative), yaw
within 1.71e-7, reward within 6.72e-6 (not bit-exact: the jitted JAX
step fuses and rewrites its float arithmetic, ROADMAP Queue 3), hp and
team points exact. The test asserts that the first divergence comes no
earlier than step 100.
"""

import os
import sys

import numpy as np
import pytest

from madrona_mp_env_tpu_torch.tools import golden

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "fixtures_torch"))
from torch_threads import one_thread_under_xdist  # noqa: E402,F401

FIRST_DIVERGENCE = 100  # no step of the golden leaves the pos bar


@pytest.fixture(scope="module")
def want():
    with np.load(golden.DEFAULT_PATH) as z:
        return {k: z[k] for k in golden.FIELDS}


@pytest.fixture(scope="module")
def got():
    return golden.rollout("cpu")


def test_golden_holds_on_cpu(got):
    report = golden.check(golden.DEFAULT_PATH, "cpu",
                          min_steps=FIRST_DIVERGENCE, verbose=False, got=got)
    assert report["first_divergence_step"] >= FIRST_DIVERGENCE
    assert report["hp_exact"] and report["team_points_exact"]
    assert report["max_hp_err"] == report["max_team_points_err"] == 0.0
    assert report["max_pos_err"] <= golden.REL
    assert report["max_reward_err"] <= golden.REL
    # the bots walked and turned
    assert np.abs(got["pos"][-1] - got["pos"][0]).max() > 10.0
    assert np.abs(got["yaw"][-1] - got["yaw"][0]).max() > 0.1


@pytest.mark.parametrize("field", ["hp", "team_points", "reward"])
def test_golden_check_raises_on_drift(want, field):
    """A discrete field that differs, or a reward off by more than the
    bar, before the first pos divergence fails the check."""
    got = {k: v.copy() for k, v in want.items()}
    got[field][10, 0, 0] += 3
    with pytest.raises(AssertionError, match=field):
        golden.compare(got, want)


def test_golden_check_reports_first_divergence(want):
    got = {k: v.copy() for k, v in want.items()}
    got["pos"][40:, 1, 2, 0] += 1.0
    got["hp"][60:, 0, 0] -= 5.0  # after the divergence: not held
    report = golden.compare(got, want)
    assert report["first_divergence_step"] == 40
    assert report["hp_exact"] and report["max_pos_err"] == 0.0
    with pytest.raises(AssertionError, match="before step 50"):
        golden.compare(got, want, min_steps=50)
