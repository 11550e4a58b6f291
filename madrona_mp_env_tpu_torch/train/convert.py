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
stands.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from .normalizer import EMANormalizerState
from .policy import ActorCriticNet, build_actor_critic
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


def _ln(flat, src, dst, out):
    out[f"{dst}.weight"] = flat.pop(f"{src}/LayerNorm_0/scale")
    out[f"{dst}.bias"] = flat.pop(f"{src}/LayerNorm_0/bias")


def _dense(flat, src, dst, out, bias):
    out[f"{dst}.weight"] = flat.pop(f"{src}/kernel").T
    if bias:
        out[f"{dst}.bias"] = flat.pop(f"{src}/bias")


def _conv(flat, src, dst, out):
    """flax Conv [k..., in, out] -> torch [out, in, k...]."""
    k = flat.pop(f"{src}/kernel")
    out[f"{dst}.weight"] = np.moveaxis(k, (-1, -2), (0, 1))
    out[f"{dst}.bias"] = flat.pop(f"{src}/bias")


def _dense_general(flat, src, dst, out):
    """flax DenseGeneral: query / key / value kernels [in, heads, head_dim]
    with biases [heads, head_dim], the out projection's kernel [heads,
    head_dim, out] -> Linear weights [out, in] over the flattened heads."""
    k = flat.pop(f"{src}/kernel")
    if dst.endswith(".out"):
        k = k.reshape(-1, k.shape[-1])
    else:
        k = k.reshape(k.shape[0], -1)
    out[f"{dst}.weight"] = k.T
    out[f"{dst}.bias"] = flat.pop(f"{src}/bias").reshape(-1)


def _attention_net(flat, net, out):
    """EntitySelfAttentionNet: EmbedBlock_0..3, the attention, its
    LayerNorm and the 2-layer MLP."""
    for i in range(4):
        _dense(flat, f"{net}/EmbedBlock_{i}/Dense_0",
               f"{net}.embeds.{i}.dense", out, bias=False)
        _ln(flat, f"{net}/EmbedBlock_{i}/LayerNorm_0",
            f"{net}.embeds.{i}.ln", out)
    for proj in ("query", "key", "value", "out"):
        _dense_general(flat, f"{net}/MultiHeadDotProductAttention_0/{proj}",
                       f"{net}.attn.{proj}", out)
    _ln(flat, f"{net}/LayerNorm_0", f"{net}.ln", out)
    for i in range(2):
        _dense(flat, f"{net}/MLP_0/dense_{i}", f"{net}.mlp.layers.{i}.dense",
               out, bias=False)
        _ln(flat, f"{net}/MLP_0/LayerNorm_{i}", f"{net}.mlp.layers.{i}.ln",
            out)


def uses_attention(state_dict) -> bool:
    """Whether an ActorCriticNet state_dict is of the attention backbone."""
    return "actor_net.attn.query.weight" in state_dict


def _lstm(flat, rnn, out):
    cell = f"{rnn}/OptimizedLSTMCell_0"
    # LSTMCellParams: columns of Wi, Wh and b concatenated in (i, f, g, o)
    # order; the port's Linear weights are their transposes
    out[f"{rnn}.x_proj.weight"] = np.concatenate(
        [flat.pop(f"{cell}/i{g}/kernel") for g in _LSTM_GATES], -1).T
    out[f"{rnn}.h_proj.weight"] = np.concatenate(
        [flat.pop(f"{cell}/h{g}/kernel") for g in _LSTM_GATES], -1).T
    out[f"{rnn}.h_proj.bias"] = np.concatenate(
        [flat.pop(f"{cell}/h{g}/bias") for g in _LSTM_GATES], -1)
    _ln(flat, f"{rnn}/LayerNorm_0", f"{rnn}.out_ln", out)


def _checked(flat, out) -> Dict[str, torch.Tensor]:
    if flat:
        raise ValueError(f"unmapped flax params: {sorted(flat)}")
    return {k: torch.tensor(np.ascontiguousarray(v), dtype=torch.float32)
            for k, v in out.items()}


def _policy_state_dict(flat: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """One policy's flax leaves (no P axis) -> the port's state_dict."""
    flat = dict(flat)
    out: Dict[str, np.ndarray] = {}
    for name in _EMBEDS:
        _dense(flat, f"prefix/{name}/Dense_0", f"prefix.{name}.dense", out,
               bias=False)
        _ln(flat, f"prefix/{name}/LayerNorm_0", f"prefix.{name}.ln", out)
    for net in ("actor_net", "critic_net"):
        if f"{net}/EmbedBlock_0/Dense_0/kernel" in flat:
            _attention_net(flat, net, out)
            continue
        for i in range(3):
            _dense(flat, f"{net}/MLP_0/dense_{i}",
                   f"{net}.mlp.layers.{i}.dense", out, bias=False)
            _ln(flat, f"{net}/MLP_0/LayerNorm_{i}",
                f"{net}.mlp.layers.{i}.ln", out)
    for rnn in ("actor_rnn", "critic_rnn"):
        _lstm(flat, rnn, out)
    for head in ("actor_head_discrete", "actor_head_aim", "critic_head"):
        _dense(flat, f"{head}/Dense_0", f"{head}.dense", out, bias=True)
    if flat:
        raise ValueError(f"unmapped flax params: {sorted(flat)}")
    return out


def full_team_params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """The flax param tree of the JAX package's FullTeamActorCriticNet
    (nested dicts of arrays, one policy) -> the state_dict of
    train/full_team_policy.py's FullTeamActorCriticNet, float32 on the
    CPU. Also maps a gradient tree the same way."""
    flat = flatten(tree)
    out: Dict[str, np.ndarray] = {}
    _dense(flat, "prefix/global_embed", "prefix.global_embed", out,
           bias=True)
    for name in ("my_embed", "enemy_embed", "last_known_enemy_embed"):
        _dense(flat, f"prefix/{name}/Dense_0", f"prefix.{name}.dense", out,
               bias=True)
        _ln(flat, f"prefix/{name}/LayerNorm_0", f"prefix.{name}.ln", out)
    for name in ("fwd_lidar_conv", "rear_lidar_conv"):
        for i in range(3):
            _conv(flat, f"prefix/{name}/Conv_{i}",
                  f"prefix.{name}.convs.{i}", out)
        _ln(flat, f"prefix/{name}/LayerNorm_0", f"prefix.{name}.ln", out)
    for net in ("actor_net", "critic_net"):
        for i in range(3):
            _conv(flat, f"{net}/ConvBackbone_0/Conv_{i}",
                  f"{net}.backbone.convs.{i}", out)
        _ln(flat, f"{net}/ConvBackbone_0/LayerNorm_0", f"{net}.backbone.ln",
            out)
    for rnn in ("actor_rnn", "critic_rnn"):
        _lstm(flat, rnn, out)
    _dense(flat, "actor_head/actor_merge", "actor_head.actor_merge", out,
           bias=True)
    _ln(flat, "actor_head/LayerNorm_0", "actor_head.ln", out)
    for i, head in enumerate(("discrete", "aim")):
        _dense(flat, f"actor_head/DenseLayerDiscreteActor_{i}/Dense_0",
               f"actor_head.{head}.dense", out, bias=True)
    _dense(flat, "critic_head/Dense_0", "critic_head.dense", out, bias=True)
    return _checked(flat, out)


def params_from_jax(tree) -> List[Dict[str, torch.Tensor]]:
    """The flax param tree (nested dicts of arrays, every leaf [P, ...])
    -> P state_dicts of ActorCriticNet (of its attention backbone where
    the tree holds EntitySelfAttentionNets), float32 on the CPU."""
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
