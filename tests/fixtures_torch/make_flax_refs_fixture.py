"""Write the flax reference fixture of the PyTorch port's tests
(flax_refs_jax.npz beside this file): flax modules of the JAX package
applied under jax.jit on the CPU, on inputs and weights made from seeds
with numpy, for the tests that would otherwise compile them in every run:

- ``lstm/<dt>/{xs,start,dones,want}`` and ``lstm/<dt>/params/<path>``:
  PolicyLSTM(hidden_dim=16).sequence over [5, 3, 8] inputs with dones,
  in float32 (``f32``: tests/test_torch_train.py) and bfloat16 (``bf16``:
  tests/test_torch_mixed_precision.py); the weights are flax's tree of
  the module (model.init), each leaf then drawn from N(0, 0.5^2) in the
  tree's order from the same generator as the inputs (``lstm_case``);
- ``full_team/<case>/<key>``: FullTeamActorCriticNet's forward (logits,
  value, recurrent state, sampled actions) and sequence (log probs,
  entropies, values) outputs, test_torch_full_team._flax without the
  gradient, on test_torch_full_team._case's inputs and weights: team size
  6 in float32 (``ts6``) and team size 2 in bfloat16 (``bf16``, seed 3).
  Every float output is stored as float32 (a bfloat16 one exactly).

Regenerate (only after a deliberate change of the JAX reference):

    JAX_PLATFORMS=cpu python tests/fixtures_torch/make_flax_refs_fixture.py

About 20 seconds; it refuses any JAX backend other than the CPU.
"""

from __future__ import annotations

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
PATH = os.path.join(HERE, "flax_refs_jax.npz")

LSTM_SEED = 2
LSTM_SHAPE = dict(C=8, H=16, T=5, B=3)
FULL_TEAM = {"ts6": (6, "float32", 0), "bf16": (2, "bfloat16", 3)}


def lstm_inputs():
    """(generator, xs [T, B, C], start [2, B, H], dones [T, B]): the
    LSTM cases' inputs, the generator left where the weights are drawn."""
    s = LSTM_SHAPE
    g = np.random.default_rng(LSTM_SEED)
    xs = g.normal(size=(s["T"], s["B"], s["C"])).astype(np.float32)
    start = g.normal(size=(2, s["B"], s["H"])).astype(np.float32)
    dones = (g.uniform(size=(s["T"], s["B"])) < 0.3).astype(np.float32)
    return g, xs, start, dones


def lstm_case(dt: str):
    """flax PolicyLSTM.sequence in ``dt`` under jax.jit: (xs, start,
    dones, params tree, output as float32)."""
    import jax
    import jax.numpy as jnp

    from madrona_mp_env_tpu.train import models as jmodels

    g, xs, start, dones = lstm_inputs()
    model = jmodels.PolicyLSTM(hidden_dim=LSTM_SHAPE["H"],
                               dtype=getattr(jnp, dt))
    tree = jax.jit(model.init, static_argnames="method")(
        jax.random.PRNGKey(0), start, dones, xs, method=model.sequence)
    tree = jax.tree_util.tree_map(
        lambda x: g.normal(size=x.shape).astype(np.float32) * 0.5,
        tree["params"])
    want = jax.jit(lambda p: model.apply({"params": p}, start, dones, xs,
                                         method=model.sequence))(tree)
    return xs, start, dones, tree, np.asarray(want.astype(jnp.float32))


def _flat(tree, prefix):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)
    return out


def load_lstm(data, dt: str):
    """(xs, start, dones, params tree, want) of ``lstm/<dt>`` in the loaded
    fixture ``data`` (a dict of arrays)."""
    head = f"lstm/{dt}/"
    tree = {}
    for key, v in data.items():
        if key.startswith(head + "params/"):
            node = tree
            *path, leaf = key[len(head + "params/"):].split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = v
    return (data[head + "xs"], data[head + "start"], data[head + "dones"],
            tree, data[head + "want"])


def load_full_team(data, case: str) -> dict:
    """The flax outputs of ``full_team/<case>`` in the loaded fixture."""
    head = f"full_team/{case}/"
    return {k[len(head):]: v for k, v in data.items() if k.startswith(head)}


def main() -> None:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    import jax.numpy as jnp

    if jax.default_backend() != "cpu":
        raise SystemExit("run with JAX_PLATFORMS=cpu")
    sys.path[:0] = [REPO, os.path.dirname(HERE)]
    import test_torch_full_team as tft

    out = {}
    for dt, name in (("f32", "float32"), ("bf16", "bfloat16")):
        xs, start, dones, tree, want = lstm_case(name)
        out.update({f"lstm/{dt}/xs": xs, f"lstm/{dt}/start": start,
                    f"lstm/{dt}/dones": dones, f"lstm/{dt}/want": want})
        out.update(_flat(jax.tree_util.tree_map(np.asarray, tree),
                         f"lstm/{dt}/params"))
    for case, (ts, dtype, seed) in FULL_TEAM.items():
        want, _ = tft._flax(ts, getattr(jnp, dtype), *tft._case(ts, seed),
                            grad=False)
        for k, v in want.items():
            v = np.asarray(v)
            if v.dtype.kind not in "iub":
                v = v.astype(np.float32)
            out[f"full_team/{case}/{k}"] = v
    np.savez_compressed(PATH, **out)
    print(f"wrote {PATH}: {len(out)} arrays")


if __name__ == "__main__":
    main()
