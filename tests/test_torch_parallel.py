"""The port's data parallelism on the CPU, over gloo: parallel/, the
trainer's sharded path, the train CLI's --num-devices and
tools/scaling_bench.py.

One module fixture launches a 2-rank group once (parallel.launch, a
file:// rendezvous under tmp_path, one ATen thread a rank); each rank runs
fixtures_torch/parallel_worker.py's scenarios and writes its results,
while this process runs the one-process references. The cases hold:

- the 2-rank run at 2 worlds (1 a rank) to zone_train.npz at
  test_torch_train.py's bars: actions equal where the Gumbel top-two
  margin exceeds 1e-4, rewards, values, dones and log probs up to the
  first step an action differs, and where every action agreed the
  bootstrap, the BPTT start states and the key; after one PPO update the
  params within 2.5 lr, and where every action agreed within 0.5 lr and
  JAX's direction, the loss terms within 1e-4 relative;
- the 2-rank run at 8 worlds (4 a rank) to zone_pbt.npz at
  test_torch_pbt.py's bars: the initial tables, update_iter and
  update_iter after a rotation (actions where decided, match results,
  the key, the train params, the past params unchanged, the loss terms),
  and eval_elo (best actions, match results, the finished count, the
  ratings);
- each rank's env state after global_init (and shard_train_state of the
  one-process state) and after each rollout, bit for bit the slice of the
  one-process run's (after a rollout, in the worlds where every action
  agreed); its normalizer within 1e-6 * max(1, |x|) of the one-process
  run's; the replicated state bit-equal across the ranks;
- the train CLI with --cpu --num-devices 2 in the group: two updates,
  metrics and checkpoints from rank 0, a restore to a third; with
  --num-devices 1 (a one-rank group in this process) bit-equal to the
  plain CLI, params, Adam state, normalizer and env state included;
- scaling_bench at one rank in this process and at two in the group;
- W % N != 0 raising, and the ragged Blocks and the Gumbel draw by rows
  equal to the one-process layout and draw.
"""

import contextlib
import io
import json
import os
import sys
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import madrona_mp_env_tpu_torch as mt
from madrona_mp_env_tpu_torch.parallel import (Blocks, DataMesh, launch,
                                               shard_train_state)
from madrona_mp_env_tpu_torch.tools import scaling_bench
from madrona_mp_env_tpu_torch.train import TrainConfig, TrainingManager
from madrona_mp_env_tpu_torch.train import train as train_cli
from madrona_mp_env_tpu_torch.train.distributions import (
    DISCRETE_BUCKETS, DiscreteActionDistributions)
from madrona_mp_env_tpu_torch.train.pbt import PBTConfig, make_matchmaking
from madrona_mp_env_tpu_torch.train.trainer import slot_permutations
from madrona_mp_env_tpu_torch.utils import rng

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "fixtures_torch"))
import make_pbt_fixture as pfx  # noqa: E402
import make_train_fixture as tfx  # noqa: E402
import parallel_worker as pw  # noqa: E402
from torch_threads import one_thread_under_xdist  # noqa: E402,F401

MARGIN = 1e-4
RANKS = 2


def _close(got, want, rel, atol=0.0):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want)
    assert np.all(err <= atol + rel * np.maximum(np.abs(want), 1.0)), float(
        err.max())


def _bits(x):
    x = x.detach().cpu()
    ints = {torch.float32: torch.int32, torch.float64: torch.int64}
    return x.view(ints[x.dtype]) if x.dtype in ints else x


def _bit_equal(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        _bits(a), _bits(b))


# ------------------------------------------------------------- the group

@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """The 2-rank run's results (``ranks``), and meanwhile in this
    process: the one-process references (``one``), the train CLI plain
    and with --num-devices 1 (``ws1``) and scaling_bench at one rank
    (``bench1``)."""
    out = tmp_path_factory.mktemp("ranks")
    failed = []

    def ranks():
        try:
            launch(pw.run_rank, RANKS, (str(out),), "gloo",
                   init_method="file://" + str(out / "rendezvous"),
                   threads=1, timeout_s=300)
        except RuntimeError as e:
            failed.append(e)

    th = threading.Thread(target=ranks)
    th.start()
    try:
        one = pw.reference()
        with pytest.MonkeyPatch.context() as mp_:
            mp_.setitem(sys.modules, "torch.utils.tensorboard", None)
            ws1 = {}
            for name, extra in (("plain", []), ("ws1", ["--num-devices",
                                                         "1"])):
                tmp = tmp_path_factory.mktemp(name)
                ws1[name] = train_cli.main(pw.cli_args(str(tmp)) + [
                    "--num-updates", "1"] + extra)
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                lines = scaling_bench.main(pw.BENCH_ARGS + [
                    "--train", "--steps-per-update", "4",
                    "--num-updates", "1"])
    finally:
        th.join()
    if failed:
        raise failed[0]
    res = [torch.load(out / f"rank{r}.pt", weights_only=False)
           for r in range(RANKS)]
    return SimpleNamespace(ranks=res, one=one, ws1=ws1,
                           bench1=(lines, buf.getvalue()), out=out)


def _worlds(group, scenario, key, name):
    """A recorded world-layout field [n, W / N, ...] of every rank, joined
    on the world axis."""
    return torch.cat([r[scenario][key][name] if key else r[scenario][name]
                      for r in group.ranks], 1)


def _rows(group, name, n):
    """The train scenario's output ``name`` ([..., M, ...] on each rank's
    block rows, the block axis at -1 or, for the BPTT start states, -2)
    placed into the global [..., n, ...]."""
    parts = []
    for r in group.ranks:
        x = r["train"]["outs"].get(name) if name in r["train"]["outs"] \
            else r["train"][name]
        parts.append((r["train"]["rows"], x))
    axis = -2 if name == "rnn_starts" else -1
    x0 = parts[0][1]
    shape = list(x0.shape)
    shape[axis] = n
    out = torch.zeros(shape, dtype=x0.dtype)
    for rows, x in parts:
        out.index_copy_(axis % out.dim(), rows, x)
    return out


# ------------------------------------------------------- units, no group

def test_worlds_must_divide_over_the_ranks():
    with pytest.raises(ValueError, match="do not shard"):
        DataMesh(9, 0, 2)
    mesh = DataMesh(8, 1, 2)
    assert (mesh.local_worlds, mesh.world_lo, mesh.world_hi) == (4, 4, 8)
    cfg = mt.EnvConfig(task=mt.Task.Zone, team_size=2)
    env = mt.Env(cfg, pw.SCENE, num_worlds=4, device="cpu")
    with pytest.raises(ValueError, match="rank 1 owns"):
        TrainingManager(cfg, TrainConfig(num_worlds=8), env, device="cpu",
                        mesh=mesh)


def test_ragged_blocks_match_the_dense_layout():
    """Each rank's members of a PBT block table (ragged counts), placed
    by their rows, give the dense gather; scatter inverts gather."""
    pbt = PBTConfig(num_train_policies=2, num_past_policies=2,
                    self_play_portion=0.25, cross_play_portion=0.5,
                    past_play_portion=0.25)
    W, A = 8, 4
    assign, _ = make_matchmaking(W, A, 2, pbt)
    tp, _ = slot_permutations(assign, 2, 2)
    perm = torch.as_tensor(tp)
    x = torch.arange(W * A * 3, dtype=torch.float32).reshape(W, A, 3)
    dense = Blocks(perm).gather(x)
    placed = torch.zeros((perm.numel(), 3))
    counts = []
    for r in range(RANKS):
        lo, hi = r * W * A // RANKS, (r + 1) * W * A // RANKS
        b = Blocks(perm, lo=lo, hi=hi)
        local = b.gather(x[r * W // RANKS:(r + 1) * W // RANKS])
        placed[b.rows] = local
        counts.append(b.counts)
        flat = torch.zeros((hi - lo, 3))
        b.scatter(flat, local)
        owned = torch.zeros(hi - lo, dtype=torch.bool)
        owned[b.loc] = True
        assert torch.equal(flat[owned], x.reshape(-1, 3)[lo:hi][owned])
        assert [p.shape[0] for p in b.split(local)] == b.counts
        assert torch.equal(b.join(b.split(local)), local)
    assert torch.equal(placed, dense.reshape(-1, 3))
    assert [sum(c) for c in zip(*counts)] == [perm.shape[1]] * 2
    assert counts[0] != counts[1]  # the shares are ragged


def test_gumbel_draw_by_rows_is_the_global_draw():
    g = np.random.default_rng(0)
    S = sum(DISCRETE_BUCKETS)
    logits = torch.as_tensor(g.normal(size=(2, 5, S)).astype(np.float32))
    key = rng.prng_key(7)
    want, want_lp = DiscreteActionDistributions(
        logits, DISCRETE_BUCKETS).sample(key)
    rows = torch.tensor([9, 0, 4, 5])
    got, got_lp = DiscreteActionDistributions(
        logits.reshape(10, S)[rows], DISCRETE_BUCKETS).sample(key, rows)
    assert torch.equal(got, want.reshape(10, -1)[rows])
    assert torch.equal(got_lp, want_lp.reshape(10)[rows])


# ------------------------------------------------ one rank, this process

def test_num_devices_one_is_the_plain_path(group):
    """A one-rank group calls no collective: the update is bit-equal."""
    plain, ws1 = group.ws1["plain"], group.ws1["ws1"]
    assert ws1.update_idx == plain.update_idx == 1
    pairs = [(a[k], b[k]) for a, b in zip(ws1.params, plain.params)
             for k in a]
    pairs += [(getattr(a, f)[k], getattr(b, f)[k])
              for a, b in zip(ws1.opt_state, plain.opt_state)
              for f in ("mu", "nu") for k in a.mu]
    pairs += [(getattr(ws1.normalizer, f)[k], getattr(plain.normalizer, f)[k])
              for f in ("mu", "var") for k in plain.normalizer.mu]
    pairs += [(v, plain.env_state.leaves()[k])
              for k, v in ws1.env_state.leaves().items()]
    pairs += [(ws1.key, plain.key), (ws1.elo, plain.elo),
              (ws1.rnn_states, plain.rnn_states)]
    assert len(pairs) > 100 and all(_bit_equal(a, b) for a, b in pairs)


def test_scaling_bench_one_rank(group):
    lines, printed = group.bench1
    (line,) = lines
    assert json.loads(printed) == line
    assert (line["metric"], line["devices"], line["num_worlds"]) == (
        "scaling", 1, 2)
    assert line["env_steps_per_sec"] > 0 and line[
        "train_env_steps_per_sec"] > 0
    assert line["efficiency_vs_1dev"] == 1.0
    assert line["device"] == {"platform": "cpu"}


# ------------------------------------------------------- the 2-rank runs

@pytest.mark.parametrize("scenario", ["train", "pbt"])
def test_initial_state_is_the_slice(group, scenario):
    """global_init on each rank: shard_train_state of the one-process
    init, bit for bit; the replicated tables equal on every rank."""
    ts = group.one[scenario]["init_ts"]
    W = ts.assignment.shape[0]
    for r, res in enumerate(group.ranks):
        want = shard_train_state(DataMesh(W, r, RANKS), ts)
        got = res[scenario]["init_env"]
        assert got.keys() == want.env_state.leaves().keys()
        for k, v in want.env_state.leaves().items():
            assert _bit_equal(got[k], v), k
        assert int(got["world_idx"][0]) == r * W // RANKS
    if scenario == "pbt":
        want = dict(np.load(pfx.PATH))
        init = [r["pbt"]["init"] for r in group.ranks]
        np.testing.assert_array_equal(
            torch.cat([i["assignment"] for i in init]).numpy(),
            want["init/assignment"])
        for k in ("train_perm", "past_perm", "key", "elo"):
            for i in init:
                np.testing.assert_array_equal(i[k].numpy(), want["init/" + k])
        np.testing.assert_array_equal(group.ranks[1]["pbt"]["init_lr"],
                                      want["init/lr"])


def test_train_rollout_matches_fixture(group):
    fx = dict(np.load(tfx.PATH))
    T, n = tfx.STEPS, tfx.NUM_WORLDS * 2 * tfx.TEAM_SIZE
    act = _worlds(group, "train", "rollout", "actions").reshape(
        T, n, 6).numpy()
    decided = _worlds(group, "train", "rollout", "margins").reshape(
        T, n).numpy() > MARGIN
    want_act = fx["act_pack"].reshape(T, n, 6)

    def steps(name):
        return _rows(group, name, n).reshape(T, n).numpy()

    compared = 0
    for t in range(T):
        same = (act[t] == want_act[t]).all(-1)
        assert same[decided[t]].all(), f"step {t}: decided actions differ"
        _close(steps("rewards")[t], fx["rewards"].reshape(T, n)[t], 1e-4)
        _close(steps("values")[t], fx["values"].reshape(T, n)[t], 1e-3)
        np.testing.assert_array_equal(steps("dones")[t],
                                      fx["dones"].reshape(T, n)[t])
        for head in ("discrete", "aim"):
            lp = torch.cat([r["train"]["outs"]["log_probs"][head]
                            for r in group.ranks], -1)
            _close(lp.reshape(T, n).numpy()[t][same],
                   fx[f"log_probs_{head}"].reshape(T, n)[t][same], 1e-4)
        compared += 1
        if not same.all():
            break
    assert compared >= 4
    if compared == T:
        for r in group.ranks:
            np.testing.assert_array_equal(r["train"]["key1"].numpy(),
                                          fx["key1"])
        _close(_rows(group, "bootstrap", n), fx["bootstrap"].reshape(n),
               1e-3)
        _close(_rows(group, "rnn_starts", n),
               fx["rnn_starts"].reshape(fx["rnn_starts"].shape[:3] + (
                   n, -1)), 1e-4)


def test_train_update_matches_fixture(group):
    fx = dict(np.load(tfx.PATH))
    act = _worlds(group, "train", "rollout", "actions").numpy()
    same = bool((act.reshape(-1) == fx["act_pack"].reshape(-1)).all())
    lr = 1e-4
    res = group.ranks[0]["train"]
    assert int(res["count"]) == int(fx["update/count"][0])
    moved = 0
    for name, got in res["delta"].items():
        want = fx["delta/" + name.split("/", 1)[1]]
        got = got.numpy()
        _close(got, want, 0.0, atol=2.5 * lr)
        if same:
            _close(got, want, 0.0, atol=0.5 * lr)
            big = np.abs(want) > lr
            assert (np.sign(got[big]) == np.sign(want[big])).all(), name
        moved += int((got != 0).sum())
    assert moved > 0
    for k in ("loss", "pg_loss", "v_loss"):
        assert np.isfinite(res["metrics"][k].numpy()).all()
        if same:
            _close(res["metrics"][k], fx["update/" + k], 1e-4)


@pytest.mark.parametrize("name", ["update", "rotupd"])
def test_pbt_update_matches_fixture(group, name):
    """zone_pbt.npz's update (from the initial state, or after a
    rotation): test_torch_pbt.py's _check_update on the joined ranks."""
    want = dict(np.load(pfx.PATH))
    act = _worlds(group, "pbt", name, "actions").numpy()
    margins = _worlds(group, "pbt", name, "margins").numpy()
    win = _worlds(group, "pbt", name, "win_result").numpy()
    fin = _worlds(group, "pbt", name, "match_finished").numpy()
    compared = 0
    for t in range(pfx.STEPS):
        same_t = (act[t] == want[name + "/actions"][t]).all(-1)
        assert same_t[margins[t] > MARGIN].all(), f"step {t}: differ"
        np.testing.assert_array_equal(win[t], want[name + "/win_result"][t])
        np.testing.assert_array_equal(fin[t],
                                      want[name + "/match_finished"][t])
        compared += 1
        if not same_t.all():
            break
    assert compared >= 2
    same = bool((act == want[name + "/actions"]).all())
    np.testing.assert_array_equal(
        torch.cat([r["pbt"][name]["assignment"] for r in group.ranks]),
        want[name + "/assignment"])
    for r in group.ranks:
        res = r["pbt"][name]
        np.testing.assert_array_equal(res["key"].numpy(), want[name + "/key"])
        assert res["past_same"]
        lr = res["lr"].numpy()
        for k, got in res["delta"].items():
            e, leaf = k.split("/", 1)
            _close(got.numpy(), want[f"{name}/delta{e}/{leaf}"], 0.0,
                   atol=(0.5 if same else 2.5) * lr[int(e)])
        for k in ("loss", "pg_loss", "v_loss"):
            assert np.isfinite(res["metrics"][k].numpy()).all()
            if same:
                _close(res["metrics"][k], want[f"{name}/{k}"], 1e-4)


def test_eval_elo_matches_fixture(group):
    want = dict(np.load(pfx.PATH))
    act = _worlds(group, "pbt", "eval", "actions").numpy()
    margins = _worlds(group, "pbt", "eval", "margins").numpy()
    win = _worlds(group, "pbt", "eval", "win_result").numpy()
    fin = _worlds(group, "pbt", "eval", "match_finished").numpy()
    compared = 0
    for t in range(pfx.EVAL_STEPS):
        same = (act[t] == want["eval/actions"][t]).all(-1)
        assert same[margins[t] > MARGIN].all(), f"step {t}: differ"
        np.testing.assert_array_equal(win[t], want["eval/win_result"][t])
        np.testing.assert_array_equal(fin[t], want["eval/match_finished"][t])
        compared += 1
        if not same.all():
            break
    for r in group.ranks:
        res = r["pbt"]["eval"]
        assert res["pending"]
        finished = int(res["finished"])
        assert finished > pfx.NUM_WORLDS
        if compared == pfx.EVAL_STEPS:
            assert finished == int(want["eval/finished"])
            np.testing.assert_array_equal(res["elo"].numpy(),
                                          want["eval/elo"])
        else:
            late = want["eval/match_finished"][compared:].sum()
            _close(res["elo"], want["eval/elo"], 0.0, atol=32.0 * late)


@pytest.mark.parametrize("scenario", ["train", "update", "rotupd"])
def test_rollout_env_state_is_the_slice(group, scenario):
    """Each rank's env state after the rollout, bit for bit the
    one-process run's in every world whose actions all agreed."""
    if scenario == "train":
        one = group.one["train"]
        one_act = one["rollout"]["actions"]
        got = [(r["train"]["rollout"]["actions"], r["train"]["env"])
               for r in group.ranks]
    else:
        one = group.one["pbt"][scenario]
        one_act = one["actions"]
        got = [(r["pbt"][scenario]["actions"], r["pbt"][scenario]["env"])
               for r in group.ranks]
    Wl = got[0][0].shape[1]
    compared = 0
    for r, (act, env) in enumerate(got):
        sl = slice(r * Wl, (r + 1) * Wl)
        agreed = (act == one_act[:, sl]).all(-1).all(-1).all(0)
        compared += int(agreed.sum())
        for k, v in env.items():
            assert _bit_equal(v[agreed], one["env"][k][sl][agreed]), k
    assert compared >= RANKS


@pytest.mark.parametrize("scenario", ["train", "update", "rotupd"])
def test_normalizer_matches_one_process(group, scenario):
    """The batch over every rank's train actors (two all-reduces): within
    1e-6 * max(1, |x|) of the one-process fold, bit-equal across ranks."""
    one = group.one["train"] if scenario == "train" else \
        group.one["pbt"][scenario]
    res = [r["train"] if scenario == "train" else r["pbt"][scenario]
           for r in group.ranks]
    for i in range(2):  # mu, var
        for k, want in one["normalizer"][i].items():
            _close(res[0]["normalizer"][i][k], want, 1e-6)
            assert _bit_equal(res[1]["normalizer"][i][k],
                              res[0]["normalizer"][i][k])


def test_replicated_state_agrees_across_ranks(group):
    a, b = (r["pbt"] for r in group.ranks)
    for name in ("update", "rotupd"):
        for pa, pb in zip(a[name]["params"], b[name]["params"]):
            assert all(_bit_equal(pa[k], pb[k]) for k in pa)
        assert all(_bit_equal(a[name]["delta"][k], b[name]["delta"][k])
                   for k in a[name]["delta"])
        assert all(_bit_equal(a[name]["metrics"][k], b[name]["metrics"][k])
                   for k in a[name]["metrics"])
    assert _bit_equal(a["eval"]["elo"], b["eval"]["elo"])
    ta, tb = (r["train"] for r in group.ranks)
    assert all(_bit_equal(ta["delta"][k], tb["delta"][k])
               for k in ta["delta"])


def test_train_cli_num_devices_two(group):
    """--cpu --num-devices 2 inside the group: 2 worlds a rank, two
    updates, then a restore from 2.pt to the third; every metric row
    written once (rank 0 alone) and the checkpoint holding the ranks'
    params."""
    cli = [r["cli"] for r in group.ranks]
    for c in cli:
        assert c["update_idx"] == (2, 3) and c["local_worlds"] == 2
        # 3 updates of 2 epochs x 1 minibatch, of 2 rollout steps
        assert (c["count"], c["norm_count"]) == (3 * 2, 3 * 2)
    rows = [json.loads(line) for line in open(
        group.out / "tb" / "r" / "metrics.jsonl")]
    keys = [(r["tag"], r["step"]) for r in rows]
    assert len(keys) == len(set(keys)) and {r["step"] for r in rows} == {
        1, 2, 3}
    ck = torch.load(group.out / "ck" / "r" / "2.pt", weights_only=True)
    assert sorted(os.listdir(group.out / "ck" / "r")) == ["1.pt", "2.pt",
                                                          "3.pt"]
    for c in cli:
        assert all(_bit_equal(ck["params"][0][k], v)
                   for k, v in c["params"].items())


def test_scaling_bench_two_ranks(group):
    lines = group.ranks[0]["bench"]
    assert group.ranks[1]["bench"] == []
    assert [(x["devices"], x["num_worlds"]) for x in lines] == [(1, 2),
                                                                 (2, 4)]
    assert all(x["env_steps_per_sec"] > 0 for x in lines)
    assert lines[0]["efficiency_vs_1dev"] == 1.0
    assert lines[1]["efficiency_vs_1dev"] > 0
    assert all(x["device"] == {"platform": "cpu"} for x in lines)
