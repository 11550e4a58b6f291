"""Export a JAX training checkpoint for the PyTorch port.

    JAX_PLATFORMS=cpu python tests/fixtures_torch/export_policy.py \
        artifacts/zone6v6_r5_policy0 /path/to/policy.npz

Reads the orbax checkpoint with the JAX package's own loader
(madrona_mp_env_tpu.train.infer.eval_load_ckpt) and writes its param tree
(every leaf [P, ...]), the shared normalizer and the ELO to one ``.npz`` of
"/"-joined keys, the layout madrona_mp_env_tpu_torch.train.convert.
load_policy_npz reads with numpy alone:

    params/<flax path>, normalizer/{mu,var}/<obs key>, normalizer/count, elo
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))


def load_checkpoint(ckpt_path: str) -> dict:
    """{"params": tree, "normalizer": {"mu", "var", "count"}, "elo"} as
    numpy, through the JAX package's loader."""
    sys.path.insert(0, REPO)
    from madrona_mp_env_tpu.train.infer import eval_load_ckpt

    params, norm, elo, _ = eval_load_ckpt(ckpt_path)
    return {
        "params": params,
        "normalizer": {"mu": dict(norm.mu), "var": dict(norm.var),
                       "count": np.asarray(norm.count)},
        "elo": np.asarray(elo),
    }


def export(ckpt_path: str, out_path: str) -> str:
    ckpt = load_checkpoint(ckpt_path)  # puts the repo on sys.path
    from madrona_mp_env_tpu_torch.train.convert import flatten

    np.savez(out_path, **flatten(ckpt))
    return out_path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("ckpt", help="orbax checkpoint directory")
    ap.add_argument("out", help="output .npz path")
    args = ap.parse_args(argv)
    import jax

    jax.config.update("jax_platforms", "cpu")
    print(f"wrote {export(args.ckpt, args.out)}")


if __name__ == "__main__":
    main()
