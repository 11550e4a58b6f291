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
mapping on nested dicts of arrays, ``full_team_params_from_jax`` for the
full-team policy (train/full_team_policy.py). ``opt_state_from_jax`` carries a JAX
TrainState's Adam moments (the optax chain's ScaleByAdamState, stacked
[E, ...] like the params) across, and ``pbt_fields_from_jax`` its PBT
leaves (past params, ELO, the past ring's pointer, hyperparameters and
the matchmaking tables), so a port trainer can start where a JAX one
stands. ``params_to_jax`` and ``full_team_params_to_jax`` are the
inverse maps, port state_dicts -> flax trees (tools/convert_weights.py
writes the port's checkpoints in flax's names and layouts); each rule of
the map is written once for both directions (_ToPort, _ToFlax).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from .normalizer import EMANormalizerState
from .policy import (ATTENTION_HEADS, ActorCriticNet,
                     build_actor_critic)
from .trainer import AdamState

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


class _ToPort:
    """flax leaves {"a/b/kernel": array} (one policy) -> the port's
    state_dict as numpy; each rule pops the leaves it maps."""

    def __init__(self, flat):
        self.src = dict(flat)
        self.out: Dict[str, np.ndarray] = {}

    def has(self, flax_key, port_key) -> bool:
        return flax_key in self.src

    def ln(self, src, dst):
        self.out[f"{dst}.weight"] = self.src.pop(f"{src}/LayerNorm_0/scale")
        self.out[f"{dst}.bias"] = self.src.pop(f"{src}/LayerNorm_0/bias")

    def dense(self, src, dst, bias):
        self.out[f"{dst}.weight"] = self.src.pop(f"{src}/kernel").T
        if bias:
            self.out[f"{dst}.bias"] = self.src.pop(f"{src}/bias")

    def conv(self, src, dst):
        """flax Conv [k..., in, out] -> torch [out, in, k...]."""
        k = self.src.pop(f"{src}/kernel")
        self.out[f"{dst}.weight"] = np.moveaxis(k, (-1, -2), (0, 1))
        self.out[f"{dst}.bias"] = self.src.pop(f"{src}/bias")

    def dense_general(self, src, dst):
        """flax DenseGeneral: query / key / value kernels [in, heads,
        head_dim] with biases [heads, head_dim], the out projection's
        kernel [heads, head_dim, out] -> Linear weights [out, in] over the
        flattened heads."""
        k = self.src.pop(f"{src}/kernel")
        if dst.endswith(".out"):
            k = k.reshape(-1, k.shape[-1])
        else:
            k = k.reshape(k.shape[0], -1)
        self.out[f"{dst}.weight"] = k.T
        self.out[f"{dst}.bias"] = self.src.pop(f"{src}/bias").reshape(-1)

    def lstm(self, rnn):
        """LSTMCellParams: columns of Wi, Wh and b concatenated in (i, f,
        g, o) order; the port's Linear weights are their transposes."""
        cell = f"{rnn}/OptimizedLSTMCell_0"
        for proj, pre in (("x_proj", "i"), ("h_proj", "h")):
            self.out[f"{rnn}.{proj}.weight"] = np.concatenate(
                [self.src.pop(f"{cell}/{pre}{g}/kernel")
                 for g in _LSTM_GATES], -1).T
        self.out[f"{rnn}.h_proj.bias"] = np.concatenate(
            [self.src.pop(f"{cell}/h{g}/bias") for g in _LSTM_GATES], -1)
        self.ln(f"{rnn}/LayerNorm_0", f"{rnn}.out_ln")

    def done(self) -> Dict[str, np.ndarray]:
        if self.src:
            raise ValueError(f"unmapped flax params: {sorted(self.src)}")
        return self.out


class _ToFlax:
    """The port's state_dict (one policy; tensors or arrays) -> flax
    leaves {"a/b/kernel": array} as numpy, the inverse of _ToPort rule
    for rule: each rule pops the entries it maps."""

    def __init__(self, state_dict):
        self.src = {k: v.detach().cpu().numpy() if torch.is_tensor(v)
                    else np.asarray(v) for k, v in state_dict.items()}
        self.out: Dict[str, np.ndarray] = {}

    def has(self, flax_key, port_key) -> bool:
        return port_key in self.src

    def ln(self, src, dst):
        self.out[f"{src}/LayerNorm_0/scale"] = self.src.pop(f"{dst}.weight")
        self.out[f"{src}/LayerNorm_0/bias"] = self.src.pop(f"{dst}.bias")

    def dense(self, src, dst, bias):
        self.out[f"{src}/kernel"] = self.src.pop(f"{dst}.weight").T
        if bias:
            self.out[f"{src}/bias"] = self.src.pop(f"{dst}.bias")

    def conv(self, src, dst):
        """torch [out, in, k...] -> flax Conv [k..., in, out]."""
        w = self.src.pop(f"{dst}.weight")
        self.out[f"{src}/kernel"] = np.moveaxis(w, (0, 1), (-1, -2))
        self.out[f"{src}/bias"] = self.src.pop(f"{dst}.bias")

    def dense_general(self, src, dst):
        """Linear weights [out, in] over the flattened heads -> the
        DenseGeneral kernels split into the policy's ATTENTION_HEADS heads
        again."""
        k = self.src.pop(f"{dst}.weight").T
        b = self.src.pop(f"{dst}.bias")
        if dst.endswith(".out"):
            k = k.reshape(ATTENTION_HEADS, -1, k.shape[-1])
        else:
            k = k.reshape(k.shape[0], ATTENTION_HEADS, -1)
            b = b.reshape(ATTENTION_HEADS, -1)
        self.out[f"{src}/kernel"] = k
        self.out[f"{src}/bias"] = b

    def lstm(self, rnn):
        """The concatenated (i, f, g, o) columns split back into the
        cell's i{g} / h{g} kernels and h{g} biases."""
        cell = f"{rnn}/OptimizedLSTMCell_0"
        for proj, pre in (("x_proj", "i"), ("h_proj", "h")):
            cols = np.split(self.src.pop(f"{rnn}.{proj}.weight").T, 4, -1)
            for g, k in zip(_LSTM_GATES, cols):
                self.out[f"{cell}/{pre}{g}/kernel"] = k
        for g, b in zip(_LSTM_GATES,
                        np.split(self.src.pop(f"{rnn}.h_proj.bias"), 4, -1)):
            self.out[f"{cell}/h{g}/bias"] = b
        self.ln(f"{rnn}/LayerNorm_0", f"{rnn}.out_ln")

    def done(self) -> Dict[str, np.ndarray]:
        if self.src:
            raise ValueError(f"unmapped port params: {sorted(self.src)}")
        return self.out


def _attention_net(m, net):
    """EntitySelfAttentionNet: EmbedBlock_0..3, the attention, its
    LayerNorm and the 2-layer MLP."""
    for i in range(4):
        m.dense(f"{net}/EmbedBlock_{i}/Dense_0", f"{net}.embeds.{i}.dense",
                bias=False)
        m.ln(f"{net}/EmbedBlock_{i}/LayerNorm_0", f"{net}.embeds.{i}.ln")
    for proj in ("query", "key", "value", "out"):
        m.dense_general(f"{net}/MultiHeadDotProductAttention_0/{proj}",
                        f"{net}.attn.{proj}")
    m.ln(f"{net}/LayerNorm_0", f"{net}.ln")
    for i in range(2):
        m.dense(f"{net}/MLP_0/dense_{i}", f"{net}.mlp.layers.{i}.dense",
                bias=False)
        m.ln(f"{net}/MLP_0/LayerNorm_{i}", f"{net}.mlp.layers.{i}.ln")


def uses_attention(state_dict) -> bool:
    """Whether an ActorCriticNet state_dict is of the attention backbone."""
    return "actor_net.attn.query.weight" in state_dict


def uses_full_team(state_dict) -> bool:
    """Whether a state_dict is of the full-team policy
    (train/full_team_policy.py)."""
    return "prefix.global_embed.weight" in state_dict


def _tensors(out) -> Dict[str, torch.Tensor]:
    return {k: torch.tensor(np.ascontiguousarray(v), dtype=torch.float32)
            for k, v in out.items()}


def _policy(m) -> Dict[str, np.ndarray]:
    """ActorCriticNet (MaxPoolNet or attention backbone), one policy, in
    either direction (``m``: _ToPort or _ToFlax)."""
    for name in _EMBEDS:
        m.dense(f"prefix/{name}/Dense_0", f"prefix.{name}.dense", bias=False)
        m.ln(f"prefix/{name}/LayerNorm_0", f"prefix.{name}.ln")
    for net in ("actor_net", "critic_net"):
        if m.has(f"{net}/EmbedBlock_0/Dense_0/kernel",
                 f"{net}.embeds.0.dense.weight"):
            _attention_net(m, net)
            continue
        for i in range(3):
            m.dense(f"{net}/MLP_0/dense_{i}", f"{net}.mlp.layers.{i}.dense",
                    bias=False)
            m.ln(f"{net}/MLP_0/LayerNorm_{i}", f"{net}.mlp.layers.{i}.ln")
    for rnn in ("actor_rnn", "critic_rnn"):
        m.lstm(rnn)
    for head in ("actor_head_discrete", "actor_head_aim", "critic_head"):
        m.dense(f"{head}/Dense_0", f"{head}.dense", bias=True)
    return m.done()


def _full_team(m) -> Dict[str, np.ndarray]:
    """FullTeamActorCriticNet, one policy, in either direction."""
    m.dense("prefix/global_embed", "prefix.global_embed", bias=True)
    for name in ("my_embed", "enemy_embed", "last_known_enemy_embed"):
        m.dense(f"prefix/{name}/Dense_0", f"prefix.{name}.dense", bias=True)
        m.ln(f"prefix/{name}/LayerNorm_0", f"prefix.{name}.ln")
    for name in ("fwd_lidar_conv", "rear_lidar_conv"):
        for i in range(3):
            m.conv(f"prefix/{name}/Conv_{i}", f"prefix.{name}.convs.{i}")
        m.ln(f"prefix/{name}/LayerNorm_0", f"prefix.{name}.ln")
    for net in ("actor_net", "critic_net"):
        for i in range(3):
            m.conv(f"{net}/ConvBackbone_0/Conv_{i}",
                   f"{net}.backbone.convs.{i}")
        m.ln(f"{net}/ConvBackbone_0/LayerNorm_0", f"{net}.backbone.ln")
    for rnn in ("actor_rnn", "critic_rnn"):
        m.lstm(rnn)
    m.dense("actor_head/actor_merge", "actor_head.actor_merge", bias=True)
    m.ln("actor_head/LayerNorm_0", "actor_head.ln")
    for i, head in enumerate(("discrete", "aim")):
        m.dense(f"actor_head/DenseLayerDiscreteActor_{i}/Dense_0",
                f"actor_head.{head}.dense", bias=True)
    m.dense("critic_head/Dense_0", "critic_head.dense", bias=True)
    return m.done()


def full_team_params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """The flax param tree of the JAX package's FullTeamActorCriticNet
    (nested dicts of arrays, one policy) -> the state_dict of
    train/full_team_policy.py's FullTeamActorCriticNet, float32 on the
    CPU. Also maps a gradient tree the same way."""
    return _tensors(_full_team(_ToPort(flatten(tree))))


def full_team_params_to_jax(state_dict) -> dict:
    """The inverse of full_team_params_from_jax: a FullTeamActorCriticNet
    state_dict (one policy, any device) -> the flax param tree (nested
    dicts of numpy arrays). Raises ValueError on an entry it does not
    map."""
    return unflatten(_full_team(_ToFlax(state_dict)))


def params_to_jax(state_dicts) -> dict:
    """The inverse of params_from_jax: P ActorCriticNet state_dicts (of
    the MaxPoolNet or the attention backbone, any device) -> the flax
    param tree, nested dicts of numpy arrays with a leading policy axis P
    on every leaf. Raises ValueError on an entry it does not map."""
    flats = [_policy(_ToFlax(sd)) for sd in state_dicts]
    if any(f.keys() != flats[0].keys() for f in flats):
        raise ValueError("the policies' state_dicts hold different params")
    return unflatten({k: np.stack([f[k] for f in flats]) for k in flats[0]})


def params_from_jax(tree) -> List[Dict[str, torch.Tensor]]:
    """The flax param tree (nested dicts of arrays, every leaf [P, ...])
    -> P state_dicts of ActorCriticNet (of its attention backbone where
    the tree holds EntitySelfAttentionNets), float32 on the CPU."""
    flat = flatten(tree)
    P = {v.shape[0] for v in flat.values()}
    if len(P) != 1:
        raise ValueError(f"leaves disagree on the policy axis: {P}")
    return [
        _tensors(_policy(_ToPort({k: v[p] for k, v in flat.items()})))
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


def opt_state_from_jax(mu, nu, count) -> List[AdamState]:
    """ScaleByAdamState leaves (mu, nu: flax param trees with [E, ...]
    leaves; count [E]) -> E AdamStates with the port's parameter names,
    float32 on the CPU."""
    count = np.asarray(count).reshape(-1)
    return [AdamState(count=torch.tensor(int(c), dtype=torch.int32),
                      mu=m, nu=n)
            for c, m, n in zip(count, params_from_jax(mu),
                               params_from_jax(nu))]


def pbt_fields_from_jax(jts, device=None) -> dict:
    """The PBT leaves of a JAX TrainState (or any object with its
    attributes, as numpy or JAX arrays) -> the port's TrainState fields:
    ``dataclasses.replace(ts, **pbt_fields_from_jax(jts, ts.elo.device))``
    continues from them."""
    def t(x, dtype):
        return torch.tensor(np.asarray(x), dtype=dtype, device=device)

    return {
        "past_params": [{k: v.to(device) for k, v in p.items()}
                        for p in params_from_jax(jts.past_params)],
        "elo": t(jts.elo, torch.float32),
        "past_ptr": int(np.asarray(jts.past_ptr)),
        "hyper_params": {k: t(v, torch.float32)
                         for k, v in jts.hyper_params.items()},
        "assignment": t(jts.assignment, torch.int32),
        "train_perm": t(jts.train_perm, torch.int64),
        "past_perm": t(jts.past_perm, torch.int64),
        "pending_reset": bool(np.asarray(jts.pending_reset)),
    }


def load_policy_npz(path: str, device=None, dtype=torch.float32
                    ) -> Tuple[List[ActorCriticNet], EMANormalizerState,
                               torch.Tensor]:
    """(P policies computing in ``dtype``, normalizer, elo [P]) from an
    export_policy.py file, on ``device`` (None: the first CUDA device)."""
    with np.load(path) as z:
        tree = unflatten({k: z[k] for k in z.files})
    nets = [build_actor_critic(sd, device=device, dtype=dtype,
                               use_attention=uses_attention(sd))
            for sd in params_from_jax(tree["params"])]
    dev = next(nets[0].parameters()).device
    norm = normalizer_from_jax(tree["normalizer"]).to(dev)
    elo = torch.tensor(tree["elo"], dtype=torch.float32, device=dev)
    return nets, norm, elo
