"""Golden-trajectory check of the port (the check half of the JAX
package's tools/golden.py).

The committed golden ``tests/goldens/zone_simple_map.npz`` records a
fixed-seed scripted-bot self-play rollout of the JAX package's CPU path:
Zone 2v2 on data/simple_map, SimFlags.Default, episode_len 200, 2 worlds,
seed 7, every agent the A* bot, zero actions, 100 steps; per step pos,
yaw, hp, reward and team_points after the step. ``check`` replays that
seed through the port and reports

- the first step whose pos leaves the bar (|d pos| <= 1e-4 * max(1,
  |pos|), the slice tests' bar: XLA's CPU backend and ATen round sin, cos
  and fused products differently, so trajectories start an ulp apart and
  part where a bot's decision or a contact meets a tie);
- each field's max error up to that step (relative for pos, yaw and
  reward, absolute for hp and team_points);
- whether hp, team_points and reward are exact up to that step,

and raises when hp or team_points differ before that step, when reward
leaves 1e-4 * max(1, |reward|) before it, or when it comes before
``min_steps``.

    python -m madrona_mp_env_tpu_torch.tools.golden            # on the card
    python -m madrona_mp_env_tpu_torch.tools.golden --cpu      # plain path
    python -m madrona_mp_env_tpu_torch.tools.golden --generate --path g.npz

``--generate`` writes a golden from the port's rollout, in the JAX file's
keys and dtypes, on the CPU only (the JAX tool's hard rule: a golden made
on an accelerator would launder kernel divergence into the contract), so
it pins the plain path and ``generate`` refuses any other device.
``--check`` (the default) then compares against it. The committed golden
stays the JAX package's CPU trajectory: ``--generate`` needs a ``--path``.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Optional

import numpy as np
import torch

from ..config import EnvConfig, SimFlags, Task
from ..sim.env import Env, resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_PATH = os.path.join(REPO, "tests", "goldens", "zone_simple_map.npz")
SCENE = os.path.join(REPO, "data", "simple_map")

NUM_WORLDS = 2
TEAM_SIZE = 2
NUM_STEPS = 100
SEED = 7
EPISODE_LEN = 200
FIELDS = ("pos", "yaw", "hp", "reward", "team_points")
REL = 1e-4  # pos and reward: the slice tests' bar, times max(1, |x|)
EXACT = ("hp", "team_points")


def rollout(device=None, num_steps: int = NUM_STEPS) -> Dict[str, np.ndarray]:
    """The golden's rollout through the port on ``device`` (None: the
    first CUDA device): {field: [steps, W, ...]} numpy arrays."""
    cfg = EnvConfig(task=Task.Zone, team_size=TEAM_SIZE,
                    sim_flags=SimFlags.Default, episode_len=EPISODE_LEN)
    env = Env(cfg, SCENE, num_worlds=NUM_WORLDS, seed=SEED,
              device=resolve_device(device))
    state, _ = env.reset()
    state = state.replace(policy_idx=torch.full_like(state.policy_idx, -1))
    actions = env.zero_actions()
    hist = {k: [] for k in FIELDS}
    for _ in range(num_steps):
        state, out = env.step(state, actions)
        for k in FIELDS:
            v = out["reward"] if k == "reward" else getattr(state, k)
            hist[k].append(v.clone())
    return {k: torch.stack(v).cpu().numpy() for k, v in hist.items()}


def _errors(got: Dict[str, np.ndarray], want: Dict[str, np.ndarray]):
    """{field: [steps] max error}: relative for floats, absolute else."""
    out = {}
    for k in FIELDS:
        g, w = got[k].astype(np.float64), want[k].astype(np.float64)
        err = np.abs(g - w)
        if k not in EXACT:
            err = err / np.maximum(1.0, np.abs(w))
        out[k] = err.reshape(err.shape[0], -1).max(-1)
    return out


def compare(got: Dict[str, np.ndarray], want: Dict[str, np.ndarray],
            min_steps: int = 0) -> dict:
    """The report of ``check`` for two rollouts (``want`` the reference);
    raises when the bars fail (module docstring)."""
    steps = min(len(got["pos"]), len(want["pos"]))
    got = {k: v[:steps] for k, v in got.items()}
    want = {k: v[:steps] for k, v in want.items()}
    err = _errors(got, want)
    out = np.nonzero(err["pos"] > REL)[0]
    first = int(out[0]) if len(out) else steps
    upto = slice(0, first)
    report = {
        "steps": steps,
        "first_divergence_step": first,
        **{f"max_{k}_err": float(err[k][upto].max()) if first else 0.0
           for k in FIELDS},
        **{f"{k}_exact": bool(np.array_equal(got[k][upto], want[k][upto]))
           for k in ("hp", "team_points", "reward")},
        "max_pos_err_full": float(err["pos"].max()),
    }
    bad = [k for k in EXACT if not report[f"{k}_exact"]]
    if report["max_reward_err"] > REL:
        bad.append("reward")
    if bad:
        raise AssertionError(f"golden: {bad} leave their bars before the "
                             f"first pos divergence (step {first}): "
                             f"{report}")
    if first < min_steps:
        raise AssertionError(f"golden: pos diverges at step {first}, before "
                             f"step {min_steps}: {report}")
    return report


def check(path: str = DEFAULT_PATH, device=None, min_steps: int = 0,
          verbose: bool = True, got: Optional[dict] = None) -> dict:
    """Replay the golden seed through the port on ``device`` (or take the
    rollout ``got``) and compare it with the golden at ``path``."""
    with np.load(path) as z:
        want = {k: z[k] for k in FIELDS}
    if got is None:
        got = rollout(device, num_steps=len(want["pos"]))
    report = compare(got, want, min_steps)
    if verbose:
        print(f"golden {os.path.basename(path)} on "
              f"{resolve_device(device)}:")
        for k, v in report.items():
            print(f"  {k}: {v}")
    return report


def generate(path: str, device="cpu",
             num_steps: int = NUM_STEPS) -> Dict[str, np.ndarray]:
    """Write the golden rollout of ``num_steps`` steps to ``path``
    (np.savez_compressed, the JAX tool's keys); only on the CPU."""
    device = resolve_device(device)
    if device.type != "cpu":
        raise RuntimeError(
            f"golden generation requires the CPU, got {device}: the golden "
            "is the plain path's trajectory")
    hist = rollout(device, num_steps)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **hist)
    print(f"wrote golden ({num_steps} steps) to {path}")
    return hist


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", type=str, default=None,
                    help="the golden (default: the committed one; "
                         "--generate needs a path of its own)")
    ap.add_argument("--min-steps", type=int, default=0,
                    help="fail if pos diverges before this step")
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain PyTorch path on the CPU")
    ap.add_argument("--generate", action="store_true",
                    help="write the golden from the CPU path's rollout")
    ap.add_argument("--check", action="store_true",
                    help="compare with the golden (the default without "
                         "--generate)")
    ap.add_argument("--num-steps", type=int, default=NUM_STEPS,
                    help="steps of a generated golden")
    args = ap.parse_args(argv)
    if args.generate:
        if args.path is None:
            ap.error("--generate needs --path: the committed golden is the "
                     "JAX package's CPU trajectory")
        generate(args.path, "cpu", args.num_steps)
        if not args.check:
            return None
    device = resolve_device("cpu" if args.cpu else None)
    return check(args.path or DEFAULT_PATH, device, args.min_steps)


if __name__ == "__main__":
    main()
