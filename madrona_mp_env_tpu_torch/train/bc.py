"""Behaviour-cloning fine-tune of a checkpoint (the JAX package's
train/bc.py, the reference's scripts/filter_bc_train.py).

Restore a TrainingManager checkpoint (``save_ckpt``'s ``<update>.pt``),
run epochs of minibatched behaviour cloning on a BC data directory (the
negative mean log prob of the stored actions, each sample run from its
stored recurrent state, with an optional KL(old || new) term against the
stored logits), then save the checkpoint with only its parameters
replaced under the new run name, where ``restore_ckpt`` resumes PPO from
it. Each of the checkpoint's E policies has its own Adam state
(optax.adam(lr), no clipping) and its own shard of every epoch's
permutation of the samples (the JAX key stream: PRNGKey(seed), split once
per epoch).

Data layouts (``load_bc_data``): the eval's ``--bc-dump-dir`` step blocks
(per step [P, B / P, ...]) and ``"layout": "sequences"`` from
tools/build_trajectory_training_dataset.py (per step [team_size, ...]).
The whole set goes to the device once; minibatches are indexed there.

    python -m madrona_mp_env_tpu_torch.train.bc --ckpt-dir ckpts \\
        --in-run-name zone6v6 --out-run-name zone6v6-bc \\
        --start-update 5000 --bc-data-dir bc_data --num-epochs 100

It runs on the first CUDA device; ``--cpu`` runs on the CPU. As in the
JAX package, ``--kl-data-dir`` is accepted and not read: the KL term uses
the BC set's own stored logits.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.func import functional_call

from ..sim.env import resolve_device
from ..utils import rng
from .distributions import AIM_BUCKETS, DISCRETE_BUCKETS
from .policy import ActorCriticNet
from .trainer import AdamState, Params, adam_step, init_adam

N_DISCRETE = len(DISCRETE_BUCKETS)


def load_bc_data(data_dir: str, device=None) -> Dict:
    """A BC data directory as tensors on ``device`` (None: the first CUDA
    device), one sample per row: {"obs": {key: [N, ...]}, "actions" [N, 6]
    int32, "action_logits" [N, 37], "rewards" [N], "rnn_states" [N, 2, 2,
    H]}. Step blocks flatten (S, P, B / P) to N; sequences (S, team_size),
    their recurrent states already [2, 2, H] a sample."""
    dev = resolve_device(device)
    with open(os.path.join(data_dir, "shapes")) as f:
        meta = json.load(f)
    sequences = meta.get("layout") == "sequences"
    lead = 1 if sequences else 2  # the sample axes within one step

    def raw(name, dtype, step_shape):
        arr = np.fromfile(os.path.join(data_dir, name), dtype=dtype)
        return torch.from_numpy(arr).to(dev).reshape(-1, *step_shape)

    def read(name, dtype, step_shape):
        return raw(name, dtype, step_shape).reshape(-1, *step_shape[lead:])

    rnn = raw("rnn_states", np.float32, meta["rnn_states"])
    if sequences:  # [S, ts, 2, 2, H]
        rnn = rnn.reshape(-1, *rnn.shape[2:])
    else:  # [S, 2, 2, P, B, H]: (P, B) up front
        rnn = rnn.movedim((3, 4), (1, 2)).reshape(-1, 2, 2, rnn.shape[-1])
    return {
        "obs": {k: read(k, np.float32, s) for k, s in meta["obs"].items()},
        "actions": read("actions", np.int32, meta["actions"]),
        "action_logits": read("action_logits", np.float32,
                              meta["action_logits"]),
        "rewards": read("rewards", np.float32, meta["rewards"]),
        "rnn_states": rnn,
    }


def log_softmax(x):
    """jax.nn.log_softmax over the last axis: x - max, minus the log of
    the sum of its exp."""
    shifted = x - x.amax(-1, keepdim=True)
    return shifted - torch.log(torch.exp(shifted).sum(-1, keepdim=True))


def bc_loss(model: ActorCriticNet, params: Params, batch, kl_coef=0.0):
    """(loss, bc_loss) of one policy on a minibatch (leaves [mb, ...],
    rnn_states [mb, 2, 2, H]): bc_loss = -(mean discrete log prob + mean
    aim log prob), plus kl_coef x the sum over heads of the mean
    KL(old || new) against the stored logits."""
    rnn = batch["rnn_states"].movedim(0, 2)  # [2, 2, mb, H]
    dists, _, _ = functional_call(model, params, (rnn, batch["obs"]))
    acts = batch["actions"]
    log_probs, _ = dists.action_stats({"discrete": acts[..., :N_DISCRETE],
                                       "aim": acts[..., N_DISCRETE:]})
    bc = -(log_probs["discrete"].mean() + log_probs["aim"].mean())
    kl = 0.0
    if kl_coef > 0.0:
        new = torch.cat([dists.discrete.packed_log_probs(),
                         dists.aim.packed_log_probs()], dim=-1)
        off = 0
        for n in DISCRETE_BUCKETS + AIM_BUCKETS:
            old = log_softmax(batch["action_logits"][..., off:off + n])
            kl = kl + (torch.exp(old) * (old - new[..., off:off + n])).sum(
                -1).mean()
            off += n
    return bc + kl_coef * kl, bc


def gather(data, idx):
    """Rows ``idx`` of every leaf of a load_bc_data dict."""
    return {"obs": {k: v[idx] for k, v in data["obs"].items()},
            "actions": data["actions"][idx],
            "action_logits": data["action_logits"][idx],
            "rnn_states": data["rnn_states"][idx]}


def flatten(params: Params):
    """A policy's parameters as one float32 tensor, and its layout."""
    layout = [(k, v.shape) for k, v in params.items()]
    return torch.cat([v.reshape(-1) for v in params.values()]), layout


def unflatten(flat: torch.Tensor, layout) -> Params:
    """Views of ``flat`` in ``layout``'s names and shapes."""
    sizes = [math.prod(shape) for _, shape in layout]
    return {k: v.view(shape) for (k, shape), v in
            zip(layout, torch.split(flat, sizes))}


def bc_update(model: ActorCriticNet, flats: List[torch.Tensor],
              opt_state: List[AdamState], layout, data, idx, lr: float,
              kl_coef: float = 0.0):
    """One minibatch step of every policy: policy e (its parameters flat,
    ``flatten``) on rows idx[e] of ``data``, its gradient through one
    optax.adam(lr) step over the flat tensor (the same elementwise
    arithmetic as leaf by leaf, in a dozen launches). Returns (flats,
    opt_state, bc_loss [E] before the step)."""
    flats, opt_state, losses = list(flats), list(opt_state), []
    for e in range(len(flats)):
        flat = flats[e].detach().requires_grad_(True)
        loss, bc = bc_loss(model, unflatten(flat, layout),
                           gather(data, idx[e]), kl_coef)
        # the critic takes no part in the loss: its gradient is zero
        (grad,) = torch.autograd.grad(loss, flat)
        with torch.no_grad():
            new, opt_state[e] = adam_step({"flat": flats[e]},
                                          {"flat": grad}, opt_state[e], lr,
                                          None)
        flats[e] = new["flat"]
        losses.append(bc.detach())
    return flats, opt_state, torch.stack(losses)


@dataclass
class BCRun:
    params: List[Params]
    losses: np.ndarray  # [epochs, minibatches, E] bc_loss before each step
    epoch_seconds: List[float]  # wall s of each epoch's steps
    path: str  # the checkpoint written


def run_bc(in_ckpt: str, out_ckpt_dir: str, bc_data_dir: str,
           kl_data_dir: Optional[str] = None, lr: float = 0.01,
           num_epochs: int = 100, minibatch_size: int = 2048,
           kl_coef: float = 0.0, dtype: torch.dtype = torch.float32,
           seed: int = 7, device=None, verbose: bool = True) -> BCRun:
    """BC epochs on ``bc_data_dir`` from the save_ckpt file ``in_ckpt``;
    writes ``<out_ckpt_dir>/<update_idx>.pt`` (the input with its params
    replaced). ``kl_data_dir`` is not read, as in the JAX package."""
    dev = resolve_device(device)
    ckpt = torch.load(in_ckpt, map_location=dev, weights_only=True)
    params = [{k: v.to(torch.float32) for k, v in p.items()}
              for p in ckpt["params"]]
    E = len(params)
    data = load_bc_data(bc_data_dir, dev)
    N = data["actions"].shape[0]
    if N % E:
        raise ValueError(f"{N} samples not divisible by {E} policies")
    model = ActorCriticNet(dtype).to(dev).requires_grad_(False)
    flats, layouts = zip(*(flatten(p) for p in params))
    flats, layout = list(flats), layouts[0]
    opt_state = [init_adam({"flat": f}) for f in flats]
    per_e = N // E
    mb = min(minibatch_size, per_e)
    num_mb = per_e // mb
    key = rng.prng_key(seed, device=dev)
    losses, seconds = [], []
    for epoch in range(num_epochs):
        key, sub = rng.split(key, 2)
        # each policy trains on its own shard of the samples
        order = rng.permutation(sub, N).reshape(E, per_e)
        t0 = time.perf_counter()
        epoch_losses = []
        for mi in range(num_mb):
            flats, opt_state, bc = bc_update(
                model, flats, opt_state, layout, data,
                order[:, mi * mb:(mi + 1) * mb], lr, kl_coef)
            epoch_losses.append(bc)
        epoch_losses = torch.stack(epoch_losses).cpu().numpy()
        seconds.append(time.perf_counter() - t0)
        losses.append(epoch_losses)
        if verbose:
            print(f"epoch {epoch}: bc_loss {epoch_losses.mean():.4f}")
    params = [{k: v.clone() for k, v in unflatten(f, layout).items()}
              for f in flats]
    # save under the new run name, PPO-resumable
    out = dict(ckpt)
    out["params"] = params
    os.makedirs(out_ckpt_dir, exist_ok=True)
    path = os.path.join(os.path.abspath(out_ckpt_dir),
                        f"{int(ckpt['update_idx'])}.pt")
    torch.save(out, path)
    return BCRun(params=params, losses=np.stack(losses),
                 epoch_seconds=seconds, path=path)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt-dir", type=str, required=True)
    ap.add_argument("--in-run-name", type=str, required=True)
    ap.add_argument("--out-run-name", type=str, required=True)
    ap.add_argument("--start-update", type=int, required=True)
    ap.add_argument("--bc-data-dir", type=str, required=True)
    ap.add_argument("--kl-data-dir", type=str, default=None)
    ap.add_argument("--kl-coef", type=float, default=0.0)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--num-epochs", type=int, default=100)
    ap.add_argument("--minibatch-size", type=int, default=2048)
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    return ap.parse_args(argv)


def main(argv=None) -> BCRun:
    args = parse_args(argv)
    return run_bc(
        in_ckpt=os.path.join(args.ckpt_dir, args.in_run_name,
                             f"{args.start_update}.pt"),
        out_ckpt_dir=os.path.join(args.ckpt_dir, args.out_run_name),
        bc_data_dir=args.bc_data_dir, kl_data_dir=args.kl_data_dir,
        lr=args.lr, num_epochs=args.num_epochs,
        minibatch_size=args.minibatch_size, kl_coef=args.kl_coef,
        dtype=torch.bfloat16 if args.bf16 else torch.float32,
        device="cpu" if args.cpu else None)


if __name__ == "__main__":
    main()
