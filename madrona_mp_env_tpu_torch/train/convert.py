"""Carry the JAX package's trained weights across to the port.

The JAX trainer checkpoints (orbax) a flax param tree with a leading
policy axis P on every leaf, the shared EMA normalizer and the per-policy
ELO. ``tests/fixtures_torch/export_policy.py`` (which runs with JAX)
writes such a checkpoint to an ``.npz`` of flat "/"-joined keys:

    params/<flax path>              [P, ...]
    normalizer/{mu,var}/<obs key>   [F]
    normalizer/count                []
    elo                             [P]

``load_policy_npz`` reads that file with numpy alone and builds the
port's policies; ``params_from_jax`` and ``normalizer_from_jax`` do the
mapping on nested dicts of arrays.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from .normalizer import EMANormalizerState
from .policy import ActorCriticNet, build_actor_critic

_LSTM_GATES = ("i", "f", "g", "o")
_EMBEDS = ("fwd_lidar_embed", "rear_lidar_embed", "self_embed",
           "teammates_embed", "opponents_embed", "opponents_last_known_embed")


def flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts -> {"a/b/c": leaf}."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, key + "/"))
        else:
            out[key] = np.asarray(v)
    return out


def unflatten(flat: Dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _ln(flat, src, dst, out):
    out[f"{dst}.weight"] = flat.pop(f"{src}/LayerNorm_0/scale")
    out[f"{dst}.bias"] = flat.pop(f"{src}/LayerNorm_0/bias")


def _dense(flat, src, dst, out, bias):
    out[f"{dst}.weight"] = flat.pop(f"{src}/kernel").T
    if bias:
        out[f"{dst}.bias"] = flat.pop(f"{src}/bias")


def _policy_state_dict(flat: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """One policy's flax leaves (no P axis) -> the port's state_dict."""
    flat = dict(flat)
    out: Dict[str, np.ndarray] = {}
    for name in _EMBEDS:
        _dense(flat, f"prefix/{name}/Dense_0", f"prefix.{name}.dense", out,
               bias=False)
        _ln(flat, f"prefix/{name}/LayerNorm_0", f"prefix.{name}.ln", out)
    for net in ("actor_net", "critic_net"):
        for i in range(3):
            _dense(flat, f"{net}/MLP_0/dense_{i}",
                   f"{net}.mlp.layers.{i}.dense", out, bias=False)
            _ln(flat, f"{net}/MLP_0/LayerNorm_{i}",
                f"{net}.mlp.layers.{i}.ln", out)
    for rnn in ("actor_rnn", "critic_rnn"):
        cell = f"{rnn}/OptimizedLSTMCell_0"
        # LSTMCellParams: columns of Wi, Wh and b concatenated in (i, f, g,
        # o) order; the port's Linear weights are their transposes
        out[f"{rnn}.x_proj.weight"] = np.concatenate(
            [flat.pop(f"{cell}/i{g}/kernel") for g in _LSTM_GATES], -1).T
        out[f"{rnn}.h_proj.weight"] = np.concatenate(
            [flat.pop(f"{cell}/h{g}/kernel") for g in _LSTM_GATES], -1).T
        out[f"{rnn}.h_proj.bias"] = np.concatenate(
            [flat.pop(f"{cell}/h{g}/bias") for g in _LSTM_GATES], -1)
        _ln(flat, f"{rnn}/LayerNorm_0", f"{rnn}.out_ln", out)
    for head in ("actor_head_discrete", "actor_head_aim", "critic_head"):
        _dense(flat, f"{head}/Dense_0", f"{head}.dense", out, bias=True)
    if flat:
        raise ValueError(f"unmapped flax params: {sorted(flat)}")
    return out


def params_from_jax(tree) -> List[Dict[str, torch.Tensor]]:
    """The flax param tree (nested dicts of arrays, every leaf [P, ...])
    -> P state_dicts of ActorCriticNet, float32 on the CPU."""
    flat = flatten(tree)
    P = {v.shape[0] for v in flat.values()}
    if len(P) != 1:
        raise ValueError(f"leaves disagree on the policy axis: {P}")
    return [
        {k: torch.tensor(np.ascontiguousarray(v), dtype=torch.float32)
         for k, v in _policy_state_dict(
             {k: v[p] for k, v in flat.items()}).items()}
        for p in range(P.pop())
    ]


def normalizer_from_jax(d) -> EMANormalizerState:
    """{"mu": {key: [F]}, "var": {key: [F]}, "count": []} (shared by all
    policies, as the checkpoint stores it) -> EMANormalizerState on the
    CPU."""
    def t(x):
        return torch.tensor(np.asarray(x), dtype=torch.float32)

    return EMANormalizerState(
        mu={k: t(v) for k, v in d["mu"].items()},
        var={k: t(v) for k, v in d["var"].items()},
        count=torch.tensor(np.asarray(d["count"]), dtype=torch.int32))


def load_policy_npz(path: str, device=None
                    ) -> Tuple[List[ActorCriticNet], EMANormalizerState,
                               torch.Tensor]:
    """(P policies, normalizer, elo [P]) from an export_policy.py file, on
    ``device`` (None: the first CUDA device)."""
    with np.load(path) as z:
        tree = unflatten({k: z[k] for k in z.files})
    nets = [build_actor_critic(sd, device=device)
            for sd in params_from_jax(tree["params"])]
    dev = next(nets[0].parameters()).device
    norm = normalizer_from_jax(tree["normalizer"]).to(dev)
    elo = torch.tensor(tree["elo"], dtype=torch.float32, device=dev)
    return nets, norm, elo
