"""The port's PBT population against the JAX package, on the CPU.

Units against JAX calls on small inputs: ``ParamExplore.perturb`` (the
draw, the clip), ``update_population`` on a 4-policy pytree (ELO ties and
distinct ratings: donors, copied params and Adam moments, ratings,
perturbed lr), ``elo_update`` / ``elo_update_masked`` on decided
matches, and the trainer's fold of match results into the ratings
(``TrainingManager._match_elo`` against the JAX trainer's own fold on
planted decided matches, a rotated assignment and unequal ratings) are
exact (the port's threefry draws JAX's bits; on the CPU
index_add_ adds in index order as XLA's CPU scatter does).

The trainer against fixtures_torch/zone_pbt.npz (make_pbt_fixture.py:
the JAX TrainingManager at tests/test_pbt.py's configuration, Zone 2v2,
8 worlds, episode_len 40 for the eval's matches to end, E = 2, P = 2,
play portions 0.25 / 0.5 / 0.25, seeded full-width weights), started
from the same weights, env seed and key:

- the initial state (key, lr spread, ELO [E + P], matchmaking tables)
  and the six rotations (assignment, train_perm, past_perm, key) exact,
  every slot's actor count kept;
- one update_iter, and one after a rotation (a forced reset of every
  world on its first step): every environment step's actions, train and
  past actors alike, equal where the Gumbel top-two margin exceeds 1e-4,
  match results exact, up to the first step where an action differs;
  the train params within 2.5 lr (0.5 lr and the loss terms within 1e-4
  relative where every action agreed), the past params bit-unchanged,
  the key exact;
- store_past_policy and update_population, from the update's state with
  set ratings and from the initial state with every rating 1000 (ties):
  which policy lands in which slot, the ratings, the perturbed lr, the
  pointer and the key exact; the copies bit-equal to their donors, Adam
  state too;
- eval_elo at 50 steps: the best actions equal where the top-two logit
  gap exceeds 1e-4, match results exact, the same count of finished
  matches (more than the W that the reset at step 0 ends: 16 of 8
  worlds) and the ratings exact once every step agreed
  (within 32 per later finished match otherwise). At this size every
  match ends in a draw (random weights, 40-step episodes), so the
  ratings stay 1000; the arithmetic on decided matches is the unit
  above. eval_elo leaves every tensor of the training state bit-equal;
- the train CLI's loop after the update (eval_elo, store, population,
  rotation, update): ratings, pointer, lr, key and tables exact, the
  update's losses finite and the past params it acted with unchanged.

A checkpoint with past params round-trips, and convert.pbt_fields_from_jax
carries the JAX state's PBT leaves across.
"""

import dataclasses
import os
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_mp_env_tpu.train import elo as jelo
from madrona_mp_env_tpu.train import pbt as jpbt

import madrona_mp_env_tpu_torch as mt
from madrona_mp_env_tpu_torch.train import (PPOConfig, TrainConfig,
                                            TrainingManager, params_from_jax,
                                            pbt_fields_from_jax)
from madrona_mp_env_tpu_torch.train import elo as telo
from madrona_mp_env_tpu_torch.train import pbt as tpbt
from madrona_mp_env_tpu_torch.train.trainer import AdamState, slot_permutations
from madrona_mp_env_tpu_torch.utils import rng

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
SCENE = os.path.join(REPO, "data", "simple_map")
sys.path.insert(0, os.path.join(HERE, "fixtures_torch"))
import make_pbt_fixture as fx  # noqa: E402
from make_train_fixture import sample_index  # noqa: E402
from policy_weights import random_flax_params  # noqa: E402
from torch_threads import one_thread_under_xdist  # noqa: E402,F401
from test_torch_train import _gumbel_margin  # noqa: E402

MARGIN = 1e-4
LR_EXPLORE = dict(base=1e-4, min_scale=0.1, max_scale=10.0, log10_scale=True)


def _key(seed):
    return torch.as_tensor(np.asarray(jax.random.PRNGKey(seed), np.int64))


def _close(got, want, rel, atol=0.0):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want)
    assert np.all(err <= atol + rel * np.maximum(np.abs(want), 1.0)), float(
        err.max())


# ------------------------------------------------------------------ units

def test_param_explore_perturb_matches_jax():
    g = np.random.default_rng(0)
    vals = (10.0 ** g.uniform(-5.2, -2.8, 64)).astype(np.float32)
    jp = jpbt.ParamExplore(**LR_EXPLORE)
    tp = tpbt.ParamExplore(**LR_EXPLORE)
    assert (tpbt.PERTURB_LO, tpbt.PERTURB_HI) == (jp.perturb_lo,
                                                  jp.perturb_hi)
    for seed in (1, 2):
        want = jax.jit(jp.perturb)(jax.random.PRNGKey(seed), vals)
        got = tp.perturb(_key(seed), torch.as_tensor(vals))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    lo, hi = np.float32(tp.lo), np.float32(tp.hi)
    assert got.min().item() >= lo and got.max().item() <= hi


@pytest.mark.parametrize("elo", [[1000.0] * 4, [800.0, 1200.0, 1000.0,
                                                900.0]])
def test_update_population_matches_jax(elo):
    E = 4
    g = np.random.default_rng(1)
    w = g.standard_normal((E, 3, 2)).astype(np.float32)
    m = g.standard_normal((E, 3, 2)).astype(np.float32)
    lr = np.array([1e-4, 2e-4, 3e-4, 4e-4], np.float32)
    elo = np.asarray(elo, np.float32)
    explore = {"lr": jpbt.ParamExplore(**LR_EXPLORE)}
    jw, jm, jhp, jelo_ = jax.jit(
        lambda k, p, o, h, e: jpbt.update_population(
            k, p, o, h, e, explore, 0.25))(
        jax.random.PRNGKey(3), {"w": w}, {"m": m}, {"lr": lr}, elo)
    params = [{"w": torch.as_tensor(w[e])} for e in range(E)]
    opt = [AdamState(count=torch.tensor(e, dtype=torch.int32),
                     mu={"w": torch.as_tensor(m[e])},
                     nu={"w": torch.as_tensor(m[e]) ** 2})
           for e in range(E)]
    p2, o2, hp2, elo2 = tpbt.update_population(
        _key(3), params, opt, {"lr": torch.as_tensor(lr)},
        torch.as_tensor(elo), {"lr": tpbt.ParamExplore(**LR_EXPLORE)})
    for e in range(E):
        np.testing.assert_array_equal(p2[e]["w"].numpy(), jw["w"][e])
        np.testing.assert_array_equal(o2[e].mu["w"].numpy(), jm["m"][e])
        (src,) = np.nonzero((w == np.asarray(jw["w"][e])).all((1, 2)))[0]
        assert int(o2[e].count) == src
        assert torch.equal(o2[e].nu["w"], opt[src].nu["w"])
        if src != e:  # a copy, not the donor's tensors
            assert p2[e]["w"].data_ptr() != params[src]["w"].data_ptr()
    np.testing.assert_array_equal(hp2["lr"].numpy(), np.asarray(jhp["lr"]))
    np.testing.assert_array_equal(elo2.numpy(), np.asarray(jelo_))


def test_elo_updates_match_jax():
    g = np.random.default_rng(2)
    M, E = 200, 4
    ratings = g.uniform(900, 1100, E).astype(np.float32)
    pairs = g.integers(0, E, (M, 2)).astype(np.int32)
    win = g.integers(-1, 3, M).astype(np.int32)
    jpairs, score, valid = jelo.accumulate_match_scores(
        jnp.asarray(win), jnp.asarray(pairs))
    tpairs, tscore, tvalid = telo.accumulate_match_scores(
        torch.as_tensor(win), torch.as_tensor(pairs))
    np.testing.assert_array_equal(tscore.numpy(), np.asarray(score))
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(valid))
    want = jax.jit(jelo.elo_update_masked)(ratings, jpairs, score, valid)
    got = telo.elo_update_masked(torch.as_tensor(ratings), tpairs, tscore,
                                 tvalid)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = jax.jit(jelo.elo_update)(ratings, jpairs, score)
    got = telo.elo_update(torch.as_tensor(ratings), tpairs, tscore)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _jax_trainer_fold(team_size, ratings, assignment, win, finished):
    """The JAX TrainingManager's own ELO fold (_update_impl, jitted) on
    planted match results [..., W]: its rollout and PPO update stubbed to
    hand back the plants."""
    from madrona_mp_env_tpu.train import trainer as jtrainer

    mgr = object.__new__(jtrainer.TrainingManager)
    mgr.cfg = SimpleNamespace(team_size=team_size)
    blank = {f.name: None for f in dataclasses.fields(jtrainer.TrainState)}

    def fold(ratings, assignment, win, finished):
        outs = {"rewards": jnp.zeros(1), "values": jnp.zeros(1),
                "win_result": win, "match_finished": finished}
        mgr._rollout = lambda ts: (ts, None, outs, None)
        mgr._ppo_update = lambda ts, *_: (ts, {})
        ts = jtrainer.TrainState(**blank).replace(
            elo=ratings, assignment=assignment, update_idx=jnp.int32(0))
        return mgr._update_impl(ts)[0].elo

    return np.asarray(jax.jit(fold)(ratings, assignment, win, finished))


@pytest.mark.parametrize("shape,ratings", [
    ((2, 5), [1010.0, 940.0, 1105.0, 980.0]),  # an update's [K, L, W]
    ((12,), [1000.0] * 4)])  # eval_elo's [T, W], ratings restarted
def test_match_elo_matches_jax_trainer(shape, ratings):
    """TrainingManager._match_elo against the JAX trainer's fold on
    decided matches: a rotated assignment (rot/2 of zone_pbt.npz), team 0
    or 1 winning, draws, unfinished steps and finished steps without a
    result. Exact: on the CPU both add in index order."""
    want = dict(np.load(fx.PATH))
    assignment = want["rot/2/assignment"]  # [8, 4], E + P = 4 slots
    g = np.random.default_rng(4)
    W = assignment.shape[0]
    win = g.integers(-1, 3, shape + (W,)).astype(np.int32)
    finished = g.random(shape + (W,)) < 0.5
    decided = finished & (win >= 0) & (win <= 1)
    assert decided.sum() > 10 and len(set(win[decided])) == 2
    ratings = np.asarray(ratings, np.float32)
    # the JAX update folds [K, L, W]; its eval_elo folds [T, W] by the
    # same lines, in the same flat order as [1, T, W]
    lead = (1,) * (3 - win.ndim)
    jwant = _jax_trainer_fold(fx.TEAM_SIZE, ratings, assignment,
                              win.reshape(lead + win.shape),
                              finished.reshape(lead + win.shape))
    mgr = SimpleNamespace(cfg=SimpleNamespace(team_size=fx.TEAM_SIZE))
    got = TrainingManager._match_elo(
        mgr, torch.as_tensor(ratings), torch.as_tensor(assignment),
        torch.as_tensor(win), torch.as_tensor(finished))
    np.testing.assert_array_equal(got.numpy(), jwant)
    # the plants decide the ratings: the teams' results swapped move them
    swapped = np.where(win == 0, 1, np.where(win == 1, 0, win)).astype(
        np.int32)
    assert not np.array_equal(jwant, _jax_trainer_fold(
        fx.TEAM_SIZE, ratings, assignment, swapped.reshape(lead + win.shape),
        finished.reshape(lead + win.shape)))
    assert np.abs(jwant - ratings).max() > 1.0


def test_slot_permutations():
    tp, pp = slot_permutations(np.array([[0, 0, 2, 2], [1, 1, 3, 3]]), 2, 2)
    assert tp.tolist() == [[0, 1], [4, 5]] and pp.tolist() == [[2, 3],
                                                               [6, 7]]
    tp, pp = slot_permutations(np.array([[0, 0, 1, 1], [1, 1, 0, 0]]), 2, 0)
    assert tp.tolist() == [[0, 1, 6, 7], [2, 3, 4, 5]] and pp.shape == (0, 0)
    with pytest.raises(ValueError, match="train"):
        slot_permutations(np.array([[0, 0, 1, 1], [0, 0, 2, 2]]), 2, 1)


# ------------------------------------------------- trainer vs the fixture

class Recorder:
    """Each env step's actions [W, A, 6] and match results, and each
    policy apply's distributions, of a TrainingManager."""

    def __init__(self, mgr):
        self.steps, self.dists = [], []
        step, apply = mgr.env.step, mgr.apply_blocks

        def recording_step(state, a, *args):
            state, out = step(state, a, *args)
            res = out["episode_result"]
            self.steps.append((torch.stack(
                [a.move_amount, a.move_angle, a.fire, a.stand, a.aim_yaw,
                 a.aim_pitch], -1).numpy(), res["win_result"].numpy(),
                res["match_finished"].numpy()))
            return state, out

        def recording_apply(*args):
            out = apply(*args)
            self.dists.append(out[0])
            return out

        mgr.env.step, mgr.apply_blocks = recording_step, recording_apply

    def take(self):
        steps, dists = self.steps, self.dists
        self.steps, self.dists = [], []
        return [np.stack(x) for x in zip(*steps)], dists


def _world_layout(mgr, train, past, tperm, pperm):
    """Train [E, BE] and past [P, BPp] values -> [W, A]."""
    flat = torch.zeros(mgr.B, dtype=train.dtype)
    flat[tperm.reshape(-1)] = train.reshape(-1)
    flat[pperm.reshape(-1)] = past.reshape(-1)
    return flat.reshape(mgr.W, mgr.A).numpy()


def _best_margin(d):
    """Smallest top-two logit gap over the heads (best() decides)."""
    gaps = []
    for g in (d.discrete, d.aim):
        o = 0
        for b in g.buckets:
            two = torch.topk(g.logits[..., o:o + b], 2, dim=-1).values
            gaps.append(two[..., 0] - two[..., 1])
            o += b
    return torch.stack(gaps).amin(0)


def _margins(mgr, ts, dists, steps, sampled):
    """Per step [W, A] margins of the actions the run took from ts."""
    keys = rng.split(rng.split(ts.key, 2)[1], steps) if sampled else None
    out = []
    for t in range(steps):
        if sampled:
            k = rng.split(keys[t], 2)
            tm = _gumbel_margin(dists[2 * t], k[0])
            pm = _gumbel_margin(dists[2 * t + 1], k[1])
        else:
            tm, pm = _best_margin(dists[2 * t]), _best_margin(
                dists[2 * t + 1])
        out.append(_world_layout(mgr, tm, pm, ts.train_perm, ts.past_perm))
    return np.stack(out)


def _compare_steps(got, want, margins, prefix):
    """Actions equal where decided (margins None: not held) and match
    results exact, up to the first step where an action differs; returns
    the steps compared."""
    (act, win, fin) = got
    steps = act.shape[0]
    for t in range(steps):
        same = (act[t] == want[prefix + "actions"][t]).all(-1)
        if margins is not None:
            assert same[margins[t] > MARGIN].all(), f"step {t}: differ"
        np.testing.assert_array_equal(win[t], want[prefix + "win_result"][t])
        np.testing.assert_array_equal(fin[t],
                                      want[prefix + "match_finished"][t])
        if not same.all():
            return t + 1
    return steps


def _tables(ts, want, prefix, elo=True):
    for k in ("assignment", "train_perm", "past_perm", "key"):
        np.testing.assert_array_equal(np.asarray(getattr(ts, k)),
                                      want[prefix + k], err_msg=prefix + k)
    assert ts.past_ptr == int(want[prefix + "past_ptr"])
    assert ts.pending_reset == bool(want[prefix + "pending_reset"])
    np.testing.assert_array_equal(ts.hyper_params["lr"].numpy(),
                                  want[prefix + "lr"])
    if elo:
        np.testing.assert_array_equal(ts.elo.numpy(), want[prefix + "elo"])


@pytest.fixture(scope="module")
def pbt():
    want = dict(np.load(fx.PATH))
    cfg = mt.EnvConfig(task=mt.Task.Zone, team_size=fx.TEAM_SIZE,
                       episode_len=fx.EPISODE_LEN)
    tcfg = TrainConfig(
        num_worlds=fx.NUM_WORLDS, steps_per_update=fx.STEPS,
        num_bptt_chunks=fx.CHUNKS, num_train_policies=fx.E,
        pbt=tpbt.PBTConfig(
            num_train_policies=fx.E, num_past_policies=fx.P,
            self_play_portion=fx.PORTIONS[0],
            cross_play_portion=fx.PORTIONS[1],
            past_play_portion=fx.PORTIONS[2]),
        lr_explore=tpbt.ParamExplore(**LR_EXPLORE),
        ppo=PPOConfig(num_epochs=fx.EPOCHS, num_minibatches=fx.MINIBATCHES),
        seed=fx.SEED)
    env = mt.Env(cfg, SCENE, num_worlds=fx.NUM_WORLDS, seed=fx.SEED,
                 device="cpu")
    mgr = TrainingManager(cfg, tcfg, env, device="cpu")
    params = params_from_jax(random_flax_params(fx.WEIGHT_SEED, fx.E))
    rec = Recorder(mgr)

    def fresh():
        ts = mgr.init(params=params)
        rec.take()
        return ts

    ts0 = fresh()
    ts1, m1 = mgr.update_iter(ts0)
    update = (ts1, m1) + rec.take()
    return SimpleNamespace(want=want, mgr=mgr, rec=rec, fresh=fresh,
                           ts0=ts0, update=update)


def test_initial_state_matches_fixture(pbt):
    ts, mgr = pbt.fresh(), pbt.mgr
    assert (mgr.E, mgr.P, mgr.BE, mgr.BPp) == (2, 2, 14, 2)
    _tables(ts, pbt.want, "init/")
    assert len(ts.past_params) == fx.P and ts.past_rnn_states.shape[2:4] \
        == (fx.P, mgr.BPp)
    for p in range(fx.P):
        for k, v in ts.params[p % fx.E].items():
            assert torch.equal(ts.past_params[p][k], v)
    assert torch.equal(ts.env_state.policy_idx, ts.assignment)


def test_rotations_match_fixture(pbt):
    mgr, ts = pbt.mgr, pbt.fresh()
    counts = np.bincount(ts.assignment.reshape(-1).numpy(),
                         minlength=mgr.E + mgr.P)
    pairs = set()
    for r in range(fx.ROTATIONS):
        ts = mgr.resample_matchmaking(ts)
        _tables(ts, pbt.want, f"rot/{r}/")
        a = ts.assignment.numpy()
        assert np.array_equal(np.bincount(a.reshape(-1),
                                          minlength=mgr.E + mgr.P), counts)
        assert torch.equal(ts.env_state.policy_idx, ts.assignment)
        assert not ts.rnn_states.any() and not ts.past_rnn_states.any()
        pairs |= {tuple(sorted(p)) for p in a[:, ::fx.TEAM_SIZE]}
    assert len(pairs) >= 4


def _check_update(mgr, ts0, result, want, prefix):
    """An update_iter from ts0 against the fixture's (see the module
    docstring); returns whether every action agreed."""
    ts1, metrics, steps, dists = result
    margins = _margins(mgr, ts0, dists, fx.STEPS, sampled=True)
    compared = _compare_steps(steps, want, margins, prefix)
    same = compared == fx.STEPS and np.array_equal(steps[0],
                                                   want[prefix + "actions"])
    same = same and all((steps[0][t] == want[prefix + "actions"][t]).all()
                        for t in range(fx.STEPS))
    assert compared >= 2
    np.testing.assert_array_equal(ts1.key.numpy(), want[prefix + "key"])
    assert ts1.pending_reset is False
    lr = ts0.hyper_params["lr"].numpy()
    for e in range(fx.E):
        for k, p0 in ts0.params[e].items():
            i = torch.as_tensor(sample_index(k, p0.numel()))
            got = (ts1.params[e][k] - p0).reshape(-1)[i].numpy()
            _close(got, want[f"{prefix}delta{e}/{k}"], 0.0,
                   atol=(0.5 if same else 2.5) * lr[e])
    for p in range(fx.P):  # the past policies acted but never learn
        for k, v in ts0.past_params[p].items():
            assert torch.equal(ts1.past_params[p][k], v)
    for k in ("loss", "pg_loss", "v_loss"):
        assert np.isfinite(metrics[k].numpy()).all()
        if same:
            _close(metrics[k], want[prefix + k], 1e-4)
    return same


def test_update_matches_fixture(pbt):
    _check_update(pbt.mgr, pbt.ts0, pbt.update, pbt.want, "update/")


def test_update_after_rotation_matches_fixture(pbt):
    mgr = pbt.mgr
    ts0 = mgr.resample_matchmaking(pbt.fresh())
    assert ts0.pending_reset
    ts1, m = mgr.update_iter(ts0)
    _check_update(mgr, ts0, (ts1, m) + pbt.rec.take(), pbt.want, "rotupd/")


def _check_store_pop(mgr, ts, want, prefix):
    s = mgr.store_past_policy(ts)
    _tables(s, want, prefix + "store/")
    src = [next((j for j in range(fx.E) if all(
        torch.equal(s.past_params[p][k], ts.params[j][k])
        for k in ts.params[j])), -1) for p in range(fx.P)]
    assert src == want[prefix + "store/past_src"].tolist()
    p = mgr.update_population(s)
    _tables(p, want, prefix + "pop/")
    src = want[prefix + "pop/src"].tolist()
    for e, d in enumerate(src):
        for k in s.params[d]:
            assert torch.equal(p.params[e][k], s.params[d][k])
            assert torch.equal(p.opt_state[e].mu[k], s.opt_state[d].mu[k])
            assert torch.equal(p.opt_state[e].nu[k], s.opt_state[d].nu[k])
        assert int(p.opt_state[e].count) == int(want[prefix + "pop/count"][e])
    return p


@pytest.mark.parametrize("case", ["pop", "tie"])
def test_store_and_population_match_fixture(pbt, case):
    if case == "pop":
        ts = dataclasses.replace(pbt.update[0], elo=torch.tensor(fx.SET_ELO))
    else:
        ts = pbt.fresh()
    _check_store_pop(pbt.mgr, ts, pbt.want, case + "/")


def _snapshot(ts):
    return [x.clone() for x in (
        list(vars(ts.env_state).values()) + list(ts.cur_obs.values())
        + [ts.rnn_states, ts.past_rnn_states]
        + [v for p in ts.params + ts.past_params for v in p.values()])
        if isinstance(x, torch.Tensor)]


def _check_eval(mgr, rec, ts0, want, prefix, same_start=True):
    """eval_elo from ts0 against the fixture's; with same_start False
    (ts0's params within the update's bars of JAX's) the actions are not
    held, only the steps before they part."""
    before = _snapshot(ts0)
    ts, elo = mgr.eval_elo(ts0, num_steps=fx.EVAL_STEPS)
    steps, dists = rec.take()
    after = _snapshot(ts0)
    assert len(before) == len(after) > 50
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert ts.pending_reset and ts.env_state is ts0.env_state
    margins = _margins(mgr, ts0, dists, fx.EVAL_STEPS, sampled=False) \
        if same_start else None
    compared = _compare_steps(steps, want, margins, prefix)
    # the reset at step 0 ends the W matches in progress; more than W
    # means matches reached their end inside the eval
    finished = int(mgr.eval_matches)
    assert finished > fx.NUM_WORLDS
    if compared == fx.EVAL_STEPS:
        assert finished == int(want.get(prefix + "finished", finished))
        np.testing.assert_array_equal(elo.numpy(), want[prefix + "elo"])
    else:
        late = want[prefix + "match_finished"][compared:].sum()
        _close(elo, want[prefix + "elo"], 0.0, atol=32.0 * late)
    return ts


def test_eval_elo_matches_fixture(pbt):
    _check_eval(pbt.mgr, pbt.rec, pbt.fresh(), pbt.want, "eval/")


def test_train_loop_slice_matches_fixture(pbt):
    """train.py's PBT step after the update: eval_elo, store, population,
    rotation, then one more update."""
    mgr, want = pbt.mgr, pbt.want
    ts = _check_eval(mgr, pbt.rec, pbt.update[0], want, "slice/eval/",
                     same_start=False)
    _tables(ts, want, "slice/eval/")
    ts = _check_store_pop(mgr, ts, want, "slice/")
    ts = mgr.resample_matchmaking(ts)
    _tables(ts, want, "slice/rot/")
    ts2, m = mgr.update_iter(ts)
    pbt.rec.take()
    np.testing.assert_array_equal(ts2.key.numpy(), want["slice/update/key"])
    for k in ("loss", "pg_loss", "v_loss"):
        assert np.isfinite(m[k].numpy()).all()
    for p in range(fx.P):
        for k, v in ts.past_params[p].items():
            assert torch.equal(ts2.past_params[p][k], v)


def test_checkpoint_round_trip_with_past_params(pbt, tmp_path):
    mgr = pbt.mgr
    ts = dataclasses.replace(mgr.store_past_policy(pbt.update[0]),
                             elo=torch.tensor([1010.0, 990.0, 1005.0, 995.0]))
    path = mgr.save_ckpt(ts, str(tmp_path))
    back = mgr.restore_ckpt(pbt.fresh(), path)
    assert back.past_ptr == ts.past_ptr == 1 and back.update_idx == 1
    assert torch.equal(back.elo, ts.elo)
    assert torch.equal(back.hyper_params["lr"], ts.hyper_params["lr"])
    for a, b in zip(back.past_params + back.params,
                    ts.past_params + ts.params):
        assert all(torch.equal(a[k], b[k]) for k in b)


def test_pbt_fields_from_jax(pbt):
    want = pbt.want
    tree = random_flax_params(fx.WEIGHT_SEED, fx.E)
    jts = SimpleNamespace(
        past_params=jax.tree_util.tree_map(lambda x: x[[1, 0]], tree),
        elo=want["pop/pop/elo"], past_ptr=want["pop/pop/past_ptr"],
        hyper_params={"lr": want["pop/pop/lr"]},
        assignment=want["rot/2/assignment"],
        train_perm=want["rot/2/train_perm"],
        past_perm=want["rot/2/past_perm"],
        pending_reset=want["rot/2/pending_reset"])
    ts = dataclasses.replace(pbt.fresh(), **pbt_fields_from_jax(jts))
    assert ts.past_ptr == 1 and ts.pending_reset is True
    np.testing.assert_array_equal(ts.elo.numpy(), want["pop/pop/elo"])
    np.testing.assert_array_equal(ts.train_perm.numpy(),
                                  want["rot/2/train_perm"])
    assert ts.assignment.dtype == torch.int32
    params = params_from_jax(tree)
    for k, v in params[1].items():
        assert torch.equal(ts.past_params[0][k], v)
