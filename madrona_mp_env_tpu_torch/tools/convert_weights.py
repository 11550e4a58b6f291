"""A training checkpoint of the port -> raw per-policy weight arrays (the
JAX package's tools/convert_weights.py).

Equivalent of the reference's scripts/convert_weights.py, which exports
policy weights to the flat binary format its in-engine C++ DNN evaluator
loads (reference src/dnn.cpp loadPolicyWeights): one file per parameter,
``int32 ndim, int32 shape[ndim-1], float data`` with the leading policy
axis split into per-policy directories. The files carry flax's names
(the tree's path joined by "_") and layouts, as the JAX tool writes them
from its orbax checkpoint: ``convert`` reads the port's own checkpoint
(``<update>.pt`` of TrainingManager.save_ckpt) and maps its E
state_dicts back to the flax tree (train/convert.py params_to_jax, or
full_team_params_to_jax for the full-team policy) before writing.

A host tool: it reads the checkpoint onto the CPU and does no device
work.

Usage: python -m madrona_mp_env_tpu_torch.tools.convert_weights \\
    <ckpt_path> <out_dir>
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from ..train.convert import (flatten, full_team_params_to_jax,
                             params_to_jax, unflatten, uses_full_team)


def save_arrays(d, out_dir: str, prefix: str = "", verbose: bool = True):
    for key, value in d.items():
        new_prefix = f"{prefix}_{key}" if prefix else key
        if isinstance(value, dict):
            save_arrays(value, out_dir, prefix=new_prefix, verbose=verbose)
            continue
        if value is None:
            continue
        value = np.asarray(value)
        if value.ndim < 2:
            continue
        # leading axis = policy index
        for i in range(value.shape[0]):
            file_dir = os.path.join(out_dir, str(i))
            os.makedirs(file_dir, exist_ok=True)
            filename = os.path.join(file_dir, new_prefix)
            if i == 0 and verbose:
                print(f"Saving {filename}... {value[i].shape} {value.dtype}")
            with open(filename, "wb") as f:
                np.array([value.ndim - 1], dtype=np.int32).tofile(f)
                np.array(value.shape[1:], dtype=np.int32).tofile(f)
                value[i].tofile(f)


def checkpoint_params(ckpt_path: str) -> dict:
    """The flax param tree (every leaf [E, ...], numpy) of a save_ckpt
    file's E policies: ActorCriticNet (MaxPoolNet or the attention
    backbone) or the full-team policy, told apart by their keys."""
    ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    sds = ckpt["params"]
    if not uses_full_team(sds[0]):
        return params_to_jax(sds)
    flats = [flatten(full_team_params_to_jax(sd)) for sd in sds]
    return unflatten({k: np.stack([f[k] for f in flats]) for k in flats[0]})


def convert(ckpt_path: str, out_dir: str, verbose: bool = True) -> None:
    save_arrays(checkpoint_params(ckpt_path), out_dir, verbose=verbose)


if __name__ == "__main__":
    convert(sys.argv[1], sys.argv[2])
