"""Write the PBT fixture of the PyTorch port's tests.

Runs the JAX package's TrainingManager on the CPU at tests/test_pbt.py's
configuration: Zone 2v2 on data/simple_map with episode_len 40, 8 worlds,
E = 2 train and P = 2 past policies, play portions 0.25 / 0.5 / 0.25
(self / cross / past), the lr explored log-uniform x/÷10 around 1e-4, 4
steps per update in 2 BPTT chunks, 1 epoch of 2 minibatches, seed 11 (env
and trainer), weights from a seed (policy_weights.random_flax_params) in
place of flax's initializers, the past ring seeded with copies of train
policies p % E as init() seeds it. Every environment step's actions are
recorded in world layout [W, A, 6] (discrete then aim; train and past
actors alike) with the step's win_result and match_finished, through a
jax.debug.callback around the env's step. Records into zone_pbt.npz
beside this file:

- ``init/``: the initial key, lr spread, ELO and matchmaking tables;
- ``rot/``: six successive resample_matchmaking rotations from the
  initial state (assignment, train_perm, past_perm, key each);
- ``update/``: one update_iter from the initial state (the env actions,
  loss terms, the key after it, the train params' change on a fixed
  sample of every leaf as make_train_fixture.py takes it);
- ``pop/``: from that update's state with the ELO set to SET_ELO,
  store_past_policy (which train policy went to which past slot, ELO,
  pointer), then update_population (each slot's donor, ELO, lr, key);
  ``tie/``: the same from the initial state, every ELO 1000;
- ``rotupd/``: one rotation from the initial state, then one update_iter
  (env actions, loss terms, the train params' change);
- ``eval/``: eval_elo from the initial state at EVAL_STEPS steps (the
  ratings, env actions, win_result, match_finished and the count of
  finished matches);
- ``slice/``: the loop of train.py from the update's state: eval_elo,
  store_past_policy, update_population, resample_matchmaking and one
  update_iter (the ELO, lr, pointer, key and tables after each, the last
  update's env actions and loss terms).

tests/test_torch_pbt.py starts the port's TrainingManager from the same
point and holds it to these.

Regenerate (only after a deliberate change of the JAX reference):

    JAX_PLATFORMS=cpu python tests/fixtures_torch/make_pbt_fixture.py

It refuses any JAX backend other than the CPU (about four minutes).
"""

from __future__ import annotations

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
PATH = os.path.join(HERE, "zone_pbt.npz")

NUM_WORLDS = 8
TEAM_SIZE = 2
EPISODE_LEN = 40
E, P = 2, 2
PORTIONS = (0.25, 0.5, 0.25)  # self, cross, past
STEPS = 4
CHUNKS = 2
MINIBATCHES = 2
EPOCHS = 1
SEED = 11  # env and trainer
WEIGHT_SEED = 3
EVAL_STEPS = 50
ROTATIONS = 6
SET_ELO = (1000.0, 1100.0, 1000.0, 1000.0)


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    if jax.default_backend() != "cpu":
        raise RuntimeError("the PBT fixture needs the CPU backend; run "
                           "with JAX_PLATFORMS=cpu")
    import jax.numpy as jnp

    sys.path.insert(0, REPO)
    sys.path.insert(0, HERE)
    import madrona_mp_env_tpu as mp
    from madrona_mp_env_tpu.train.pbt import ParamExplore, PBTConfig
    from madrona_mp_env_tpu.train.ppo import PPOConfig
    from madrona_mp_env_tpu.train.trainer import TrainConfig, TrainingManager
    from madrona_mp_env_tpu_torch.train.convert import params_from_jax
    from make_train_fixture import sample_index
    from policy_weights import random_flax_params

    cfg = mp.EnvConfig(task=mp.Task.Zone, team_size=TEAM_SIZE,
                       episode_len=EPISODE_LEN)
    pbt = PBTConfig(num_train_policies=E, num_past_policies=P,
                    self_play_portion=PORTIONS[0],
                    cross_play_portion=PORTIONS[1],
                    past_play_portion=PORTIONS[2])
    tcfg = TrainConfig(
        num_worlds=NUM_WORLDS, steps_per_update=STEPS, num_bptt_chunks=CHUNKS,
        num_train_policies=E, pbt=pbt,
        lr_explore=ParamExplore(base=1e-4, min_scale=0.1, max_scale=10.0,
                                log10_scale=True),
        ppo=PPOConfig(num_epochs=EPOCHS, num_minibatches=MINIBATCHES),
        seed=SEED)
    env = mp.Env(cfg, os.path.join(REPO, "data", "simple_map"),
                 num_worlds=NUM_WORLDS, seed=SEED)

    # every env step's actions and match results, in call order
    steps = []
    raw_step_fn = env.step_fn

    def recording_step_fn():
        f = raw_step_fn()

        def g(state, actions, sim_ctrl, force_reset):
            state, out = f(state, actions, sim_ctrl, force_reset)
            act = jnp.stack([actions.move_amount, actions.move_angle,
                             actions.fire, actions.stand, actions.aim_yaw,
                             actions.aim_pitch], axis=-1)
            res = out["episode_result"]
            jax.debug.callback(
                lambda a, w, m: steps.append((np.asarray(a), np.asarray(w),
                                              np.asarray(m))),
                act, res["win_result"], res["match_finished"], ordered=True)
            return state, out

        return g

    env.step_fn = recording_step_fn
    mgr = TrainingManager(cfg, tcfg, env)
    weights = random_flax_params(WEIGHT_SEED, E)

    def fresh():
        """The initial state with the seeded weights (update_iter donates
        its input, so each stage starts from a new one)."""
        ts = mgr.init()
        params = jax.tree_util.tree_map(jnp.asarray, weights)
        src = jnp.arange(P) % E
        return ts.replace(
            params=params, opt_state=jax.vmap(mgr.tx.init)(params),
            past_params=jax.tree_util.tree_map(lambda x: x[src], params))

    def tables(prefix, ts):
        return {f"{prefix}assignment": np.asarray(ts.assignment),
                f"{prefix}train_perm": np.asarray(ts.train_perm),
                f"{prefix}past_perm": np.asarray(ts.past_perm),
                f"{prefix}key": np.asarray(ts.key),
                f"{prefix}elo": np.asarray(ts.elo),
                f"{prefix}lr": np.asarray(ts.hyper_params["lr"]),
                f"{prefix}past_ptr": np.asarray(ts.past_ptr),
                f"{prefix}pending_reset": np.asarray(ts.pending_reset)}

    def recorded(prefix):
        """The env steps recorded since the last call."""
        act, win, fin = (np.stack(x) for x in zip(*steps))
        steps.clear()
        return {f"{prefix}actions": act, f"{prefix}win_result": win,
                f"{prefix}match_finished": fin}

    def update(prefix, ts):
        """One update_iter, its env steps, loss terms and the train
        params' change (port names and layouts, sampled)."""
        before = params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                        ts.params))
        ts, m = mgr.update_iter(ts)
        out = recorded(prefix)
        for name in ("loss", "pg_loss", "v_loss"):
            out[f"{prefix}{name}"] = np.asarray(m[name])
        after = params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                       ts.params))
        for e in range(E):
            for key, v0 in before[e].items():
                i = sample_index(key, v0.numel())
                out[f"{prefix}delta{e}/{key}"] = (
                    after[e][key].reshape(-1)[i] - v0.reshape(-1)[i]).numpy()
        out.update(tables(prefix, ts))
        return ts, out

    def leaf(tree, i):
        return np.asarray(tree["actor_head_aim"]["Dense_0"]["kernel"][i])

    def donors(tree, ref):
        """For each slot of tree, the slot of ref holding the same params
        (-1: none)."""
        n = len(leaf(tree, slice(None)))
        return np.array([next((j for j in range(E) if np.array_equal(
            leaf(tree, i), leaf(ref, j))), -1) for i in range(n)])

    def store_pop(prefix, ts):
        out = {}
        s = mgr.store_past_policy(ts)
        out.update(tables(prefix + "store/", s))
        out[prefix + "store/past_src"] = donors(s.past_params, ts.params)
        p = mgr.update_population(s)
        out.update(tables(prefix + "pop/", p))
        out[prefix + "pop/src"] = donors(p.params, s.params)
        out[prefix + "pop/count"] = np.asarray(p.opt_state[1].count)
        return p, out

    out = {"train_seed": np.int64(SEED)}
    ts0 = fresh()
    steps.clear()
    out.update(tables("init/", ts0))
    ts = ts0
    for r in range(ROTATIONS):
        ts = mgr.resample_matchmaking(ts)
        out.update(tables(f"rot/{r}/", ts))
        assert np.array_equal(np.asarray(ts.env_state.policy_idx),
                              np.asarray(ts.assignment))

    ts1, o = update("update/", fresh())
    out.update(o)
    _, o = store_pop("pop/", ts1.replace(elo=jnp.asarray(SET_ELO,
                                                          jnp.float32)))
    out.update(o)
    _, o = store_pop("tie/", fresh())
    out.update(o)

    _, o = update("rotupd/", mgr.resample_matchmaking(fresh()))
    out.update(o)

    _, elo = mgr.eval_elo(fresh(), num_steps=EVAL_STEPS)
    out.update(recorded("eval/"))
    out["eval/elo"] = np.asarray(elo)
    out["eval/finished"] = np.int64(
        (out["eval/match_finished"] & (out["eval/win_result"] >= 0)).sum())

    # the train CLI's PBT loop after ts1's update
    ts, elo = mgr.eval_elo(ts1, num_steps=EVAL_STEPS)
    out.update(recorded("slice/eval/"))
    out.update(tables("slice/eval/", ts))
    ts, o = store_pop("slice/", ts)
    out.update(o)
    ts = mgr.resample_matchmaking(ts)
    out.update(tables("slice/rot/", ts))
    _, o = update("slice/update/", ts)
    out.update(o)

    np.savez_compressed(PATH, **out)
    print(f"wrote {PATH}: {len(out)} arrays, "
          f"{os.path.getsize(PATH) / 1024:.0f} KB; eval finished "
          f"{int(out['eval/finished'])} matches, ELO {out['eval/elo']}, "
          f"slice ELO {out['slice/eval/elo']}")


if __name__ == "__main__":
    main()
