"""The port's logging step, replay and eval dumps against the JAX package,
on the CPU.

Replays fixtures_torch/zone_record.npz (make_record_fixture.py: the eager
JAX Env, Zone 2v2 on simple_map, 2 worlds, episode_len 8, 12 steps of
tests/test_data.py's actions, Env(collect_log=True)):

- export: the port's logging rollout gives every step's step log,
  packed snapshot and game events bit for bit (int views of floats too),
  and its record file and event log (events.bin, steps.bin) are
  byte-equal to the JAX package's;
- the exports on planted edge states (a yaw of exactly +-pi, hp below 0,
  above 255 and NaN, positions beyond int16) equal the JAX exports,
  whose float -> int casts saturate (XLA), and ``saturate`` and the
  glibc sine / cosine equal XLA's on their own;
- replay: Env.replay_step over the JAX record equals the JAX replay
  (snapshot, events and done exact; observations within 1e-3 * max(1,
  |x|), reward within 1e-4, the bars of tests/test_torch_slice.py), and
  replaying the port's own record reproduces its snapshots' match-state
  stream; the logging step keeps the fused tail (K5) off;
- eval: the eval CLI with --record, --event-log and --bc-dump-dir at 2
  worlds x 10 steps on the eval fixture's weights writes the record and
  event files of an Env(collect_log=True) run of the same actions, and
  the BC dump the JAX EvalManager._dump_bc writes for the same outputs.
"""

import functools
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import madrona_mp_env_tpu_torch as mt
from madrona_mp_env_tpu_torch.data import (EventLogWriter, RecordLogWriter,
                                           ReplayLogReader,
                                           read_step_snapshots)
from madrona_mp_env_tpu_torch.data import export
from madrona_mp_env_tpu_torch.ops import tail_fused as tf
from madrona_mp_env_tpu_torch.sim import step as step_mod
from madrona_mp_env_tpu_torch.sim.types import world_state_from_numpy
from madrona_mp_env_tpu_torch.train import EvalConfig, EvalManager, infer
from madrona_mp_env_tpu_torch.train.convert import flatten

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "fixtures_torch"))
sys.path.insert(0, HERE)
import make_eval_fixture as ex  # noqa: E402
import make_record_fixture as rx  # noqa: E402
from policy_weights import random_flax_params  # noqa: E402
from test_torch_infer import _env_with_seed  # noqa: E402
from torch_threads import one_thread_under_xdist  # noqa: E402,F401

GROUPS = ("step_log", "snapshot", "game_events")
FILES = {"record": "record.bin", "events": "events/events.bin",
         "steps": "events/steps.bin"}


@pytest.fixture(scope="module")
def data():
    return dict(np.load(rx.PATH))


def group(data, prefix):
    n = len(prefix) + 1
    return {k[n:]: v for k, v in data.items() if k.startswith(prefix + "/")}


def bits(x):
    """Equal-as-bits form: floats viewed as ints, bools as uint8."""
    x = np.asarray(x)
    if x.dtype.kind == "f":
        return x.view(np.int32 if x.itemsize == 4 else np.int64)
    return x.astype(np.int64)


def assert_bits(name, got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    bad = np.argwhere(bits(got) != bits(want))
    assert not bad.size, (name, bad[:5].tolist())


def log_rollout(env, acts, out_dir, sim_ctrl=None):
    """``acts`` ([steps, W, A] each) through the logging ``env`` from its
    reset, the record and event log written into ``out_dir``: each
    step's exports stacked, {"<group>/<key>": [steps, ...]}."""
    rec = {}
    state, _ = env.reset(sim_ctrl)
    with RecordLogWriter(str(out_dir / FILES["record"])) as rw, \
            EventLogWriter(str(out_dir / "events")) as ew:
        for s in range(len(acts["fire"])):
            a = env.zero_actions().replace(
                **{k: torch.as_tensor(v[s]) for k, v in acts.items()})
            state, out = env.step(state, a, sim_ctrl)
            rw.append(out["step_log"])
            ew.append(out["snapshot"], out["game_events"])
            for g in GROUPS:
                for k, v in out[g].items():
                    rec.setdefault(f"{g}/{k}", []).append(v.numpy())
    return {k: np.stack(v) for k, v in rec.items()}


@pytest.fixture(scope="module")
def rollout(data, tmp_path_factory):
    """The fixture's recorded run through the port: (exports, env, the
    directory of its files)."""
    tmp = tmp_path_factory.mktemp("record")
    env = mt.Env(rx.make_cfg(mt), "data/simple_map",
                 num_worlds=rx.REC_WORLDS, seed=rx.SEED, device="cpu",
                 collect_log=True)
    return log_rollout(env, rx.record_actions(), tmp), env, tmp


def test_step_exports_match_jax(data, rollout):
    rec, _, _ = rollout
    want = group(data, "rec")
    assert set(rec) == set(want)
    for k, v in want.items():
        assert_bits(k, rec[k], v)
    # the window holds a reset and reload events
    assert (np.diff(rec["snapshot/match_step"], axis=0) < 0).any()
    assert rec["game_events/reload_event"].any()


@pytest.mark.parametrize("name", sorted(FILES))
def test_record_files_byte_equal_jax(data, rollout, name):
    _, _, tmp = rollout
    got = np.frombuffer((tmp / FILES[name]).read_bytes(), np.uint8)
    assert got.size and np.array_equal(got, data[f"files/{name}"])


def test_exports_on_edge_states_match_xla(data):
    """A yaw of +-pi (+-32768 before the cast), hp of -5.5, 300.7, 255.9
    and NaN, positions of +-40000, 3e37 and +-inf, magazines beyond 255:
    the snapshot, the events and the step log equal the JAX exports."""
    cfg = rx.make_cfg(mt)
    state = world_state_from_numpy(group(data, "edge/state"))
    fire = {k: torch.as_tensor(v) for k, v in group(data, "edge/fire").items()}
    ev = export.event_export(cfg, state, fire, torch.tensor([True]))
    snap = export.packed_snapshot_export(cfg, state, ev["num_events"],
                                         ev["event_mask"])
    log = export.step_log_export(cfg, state)
    for name, got in (("events", ev), ("snapshot", snap),
                      ("step_log", log)):
        want = group(data, f"edge/{name}")
        assert set(got) == set(want), name
        for k, v in want.items():
            assert_bits(f"{name}/{k}", got[k].numpy(), v)


@pytest.mark.parametrize("dtype", ["int16", "uint8"])
def test_saturate_is_xla_conversion(dtype):
    x = np.array([32768, -32769, 40000, -1.5, 255.7, 256, 300, -3, -0.9,
                  np.nan, np.inf, -np.inf, 3e37, 32767.9], np.float32)
    want = np.asarray(jnp.asarray(x).astype(dtype))
    got = export.saturate(torch.from_numpy(x), getattr(torch, dtype))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("fn", ["sin", "cos"])
def test_sinf_cosf_are_xla_cpu(fn):
    """The aim quaternion's sine and cosine (glibc's float32 routines in
    float64 tensor ops) equal XLA's CPU sin / cos bit for bit: half
    angles, the quadrant range, tiny values and the branch edges."""
    g = np.random.default_rng(3)
    x = np.concatenate([g.uniform(-1.6, 1.6, 20000),
                        g.uniform(-6.0, 6.0, 20000),
                        g.uniform(-1e-3, 1e-3, 2000),
                        [0.0, -0.0, np.pi / 4, -np.pi / 4, np.pi / 2,
                         2.0 ** -12, 0.7853981, 0.78539819, 3.1415925]]
                       ).astype(np.float32)
    want = np.asarray(getattr(jnp, fn)(x))
    got = getattr(export, fn + "f")(torch.from_numpy(x)).numpy()
    assert_bits(fn, got, want)


def test_replay_of_jax_record_matches_jax(data, tmp_path):
    path = tmp_path / "record.bin"
    path.write_bytes(data["files/record"].tobytes())
    reader = ReplayLogReader(str(path), rx.REC_WORLDS)
    assert len(reader) == rx.REC_STEPS
    env = mt.Env(rx.make_cfg(mt), "data/simple_map",
                 num_worlds=rx.REC_WORLDS, seed=rx.SEED, device="cpu")
    state, _ = env.reset()
    want = group(data, "replay")
    for s in range(len(reader)):
        state, out = env.replay_step(state, reader.step(s))
        for g in ("snapshot", "game_events"):
            for k, v in out[g].items():
                assert_bits(f"step {s} {g}/{k}", v.numpy(),
                            want[f"{g}/{k}"][s])
        assert np.array_equal(out["done"].numpy(), want["done"][s])
        for k, bar in [("reward", 1e-4)] + [("obs_" + k, 1e-3)
                                            for k in rx.OBS_KEYS]:
            got = (out[k] if k == "reward" else out["obs"][k[4:]]).numpy()
            w = want[k][s]
            err = np.abs(got.astype(np.float64) - w) / np.maximum(1.0,
                                                                  np.abs(w))
            assert err.max() <= bar, (s, k, float(err.max()))


def test_replay_reproduces_own_match_state(rollout):
    """Replaying the port's own record drives the match-state stream of
    its recorded snapshots (tests/test_data.py:110-129)."""
    _, env, tmp = rollout
    reader = ReplayLogReader(str(tmp / FILES["record"]), rx.REC_WORLDS)
    recorded = read_step_snapshots(str(tmp / "events"))["match_state"]
    recorded = recorded.reshape(len(reader), rx.REC_WORLDS)
    logs = reader.tensors()
    state, _ = env.reset()
    for s in range(len(reader)):
        state, out = env.replay_step(state, {k: v[s] for k, v in
                                             logs.items()})
        snap = out["snapshot"]
        for field, key in (("step", "match_step"), ("cur_zone", "cur_zone"),
                           ("cur_zone_controller", "cur_zone_controller"),
                           ("zone_steps_remaining", "zone_steps_remaining"),
                           ("steps_until_point", "steps_until_point")):
            assert np.array_equal(
                snap[key].numpy().astype(recorded[field].dtype),
                recorded[field][s]), (s, field)


def test_logging_step_keeps_fused_tail_off(monkeypatch):
    """The logging step takes the unfused chain: the step log is read
    between the zone system and match info (the JAX gate's collect_log);
    without logging the step's outputs stay as they were."""
    cfg = rx.make_cfg(mt)
    assert tf.use_tail_fused(cfg) and not tf.use_tail_fused(cfg, True)

    def fused(*args, **kw):
        raise AssertionError("the fused tail on the logging step")

    monkeypatch.setattr(step_mod, "fused_tail", fused)
    env = mt.Env(cfg, "data/simple_map", num_worlds=1, device="cpu",
                 collect_log=True)
    state, _ = env.reset()
    _, out = env.step(state, env.zero_actions())
    assert set(GROUPS) <= set(out)
    plain = mt.Env(cfg, "data/simple_map", num_worlds=1, device="cpu",
                   map_data=env.map_data)
    monkeypatch.undo()
    _, out = plain.step(plain.reset()[0], plain.zero_actions())
    assert not set(GROUPS) & set(out)


def _eval_npz(tmp_path):
    want = dict(np.load(ex.PATH))
    tree = {"params": random_flax_params(ex.WEIGHT_SEED, ex.NUM_POLICIES),
            "normalizer": {
                "mu": {k.split("/")[1]: v for k, v in want.items()
                       if k.startswith("norm_mu/")},
                "var": {k.split("/")[1]: v for k, v in want.items()
                        if k.startswith("norm_var/")},
                "count": want["norm_count"]},
            "elo": want["elo0"]}
    path = str(tmp_path / "policy.npz")
    np.savez(path, **flatten(tree))
    return path


class _Recording(EvalManager):
    def run(self, *args, **kw):
        self.chunks = []
        return super().run(*args, iter_cb=self.chunks.append, **kw)


def test_eval_cli_dumps(tmp_path, monkeypatch, simple_map_dir):
    """--record, --event-log and --bc-dump-dir on the CPU: the record and
    event files equal an Env(collect_log=True) run of the actions the
    eval took, and the BC dump equals the JAX writer's for the same
    outputs."""
    from madrona_mp_env_tpu.train.infer import EvalManager as JaxEval

    monkeypatch.setattr(infer, "EvalConfig", functools.partial(
        EvalConfig, chunk_steps=ex.CHUNK_STEPS, seed=ex.EVAL_SEED))
    monkeypatch.setattr(infer, "EnvConfig", functools.partial(
        mt.EnvConfig, episode_len=ex.EPISODE_LEN))
    monkeypatch.setattr(infer, "Env", functools.partial(_env_with_seed,
                                                        ex.ENV_SEED))
    monkeypatch.setattr(infer, "EvalManager", _Recording)
    mgr, _ = infer.main([
        "--cpu", "--num-worlds", str(ex.NUM_WORLDS), "--num-steps",
        str(ex.NUM_STEPS), "--team-size", str(ex.TEAM_SIZE), "--scene",
        simple_map_dir, "--ckpt-path", _eval_npz(tmp_path),
        "--record", str(tmp_path / "record.bin"), "--event-log",
        str(tmp_path / "events"), "--bc-dump-dir", str(tmp_path / "bc")])
    assert mgr.env.collect_log
    stats = mgr.dump_stats
    assert {s["steps"] for s in stats.values()} == {ex.NUM_STEPS}

    # the same actions through a logging Env
    acts = {}
    for c in mgr.chunks:
        for t in range(c["actions"]["discrete"].shape[0]):
            da = mgr.from_blocks(c["actions"]["discrete"][t])
            aa = mgr.from_blocks(c["actions"]["aim"][t])
            for j, k in enumerate(("move_amount", "move_angle", "fire",
                                   "stand")):
                acts.setdefault(k, []).append(da[..., j].numpy())
            for j, k in enumerate(("aim_yaw", "aim_pitch")):
                acts.setdefault(k, []).append(aa[..., j].numpy())
    acts = {k: np.stack(v) for k, v in acts.items()}
    env = mt.Env(mgr.cfg, simple_map_dir, ex.NUM_WORLDS, seed=ex.ENV_SEED,
                 device="cpu", collect_log=True)
    ref = tmp_path / "ref"
    ref.mkdir()
    log_rollout(env, acts, ref, sim_ctrl=(1, 0, 0))
    for name, rel in FILES.items():
        got = (tmp_path / rel).read_bytes()
        assert got and got == (ref / rel).read_bytes(), name

    # the BC dump against the JAX writer on the same outputs
    jdir = tmp_path / "bc_jax"
    jdir.mkdir()
    files = {}
    for c in mgr.chunks:
        # the JAX eval's scan hands its writer a pytree: dict keys sorted
        outs = {
            "obs": {k: _host(c["obs"][k]) for k in sorted(c["obs"])},
            "actions": {k: _host(v) for k, v in c["actions"].items()},
            "logits": _host(c["logits"]), "rewards": _host(c["rewards"]),
            "rnn_states_pre": _host(c["rnn_states_pre"]),
        }
        for t in range(outs["logits"].shape[0]):
            JaxEval._dump_bc(None, files, str(jdir), outs, t)
    for f in files.values():
        f.close()
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(tmp_path / "bc"))
    assert len(names) == len(mgr.chunks[0]["obs"]) + 5
    for n in names:
        assert (jdir / n).read_bytes() == (tmp_path / "bc" / n).read_bytes(), n


def _host(x):
    return x.numpy()


def test_eval_refuses_logs_without_a_logging_env(simple_map_dir):
    env = mt.Env(mt.EnvConfig(team_size=2), simple_map_dir, num_worlds=2,
                 device="cpu")
    mgr = EvalManager(env.cfg, EvalConfig(num_worlds=2, num_eval_steps=1),
                      env, 2, device="cpu")
    with pytest.raises(ValueError, match="collect_log"):
        mgr.run([None, None], None, torch.zeros(2), record_path="x")
