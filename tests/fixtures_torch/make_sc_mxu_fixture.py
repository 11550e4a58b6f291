"""Write the tensor-core sphere-cast probe fixture (P4) of the PyTorch
port's tests.

The JAX package's tools/probes/sc_mxu_probe.py cannot be imported: it
times itself at import and reads the map from a fixed checkout path. This
maker executes its source up to its timing tail (lines 1-161: the map, the
24,576 casts, the ``dirm`` / ``orgm`` / ``cons`` matrices, ``mxu_kernel``
and ``mxu_call``) with the checkout path replaced by this repository's
and ``pl.pallas_call`` run by the Pallas interpreter (``interpret=True``)
on the CPU, builds the probe's ``planes`` as its line 165 does, and runs
``mxu_call`` on all 24,576 casts.

It stores the first ``KEEP`` casts' origins and directions (``o``,
``d``) and their ``t`` (row 0 of the kernel's output), plus ``dirm``,
``orgm`` and ``cons``, into sc_mxu_probe.npz beside this file.
tests/test_torch_sc_mxu.py holds the port's tables and plain version
(madrona_mp_env_tpu_torch/tools/probes/sc_mxu_probe.py) to it.

Regenerate (only after a deliberate change of the JAX probe):

    JAX_PLATFORMS=cpu python tests/fixtures_torch/make_sc_mxu_fixture.py
"""

from __future__ import annotations

import functools
import os
import re
import sys
from unittest import mock

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
PATH = os.path.join(HERE, "sc_mxu_probe.npz")
PROBE = os.path.join(REPO, "tools", "probes", "sc_mxu_probe.py")
HEAD_LINES = 161  # the probe up to mxu_call; its timing tail follows
KEEP = 2048


def main():
    sys.path.insert(0, REPO)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from jax.experimental import pallas

    with open(PROBE) as f:
        head = "".join(f.readlines()[:HEAD_LINES])
    # the checkout path the probe reads its map from, replaced by ours
    fixed = re.search(r'load_map\("(.*)/data/simple_map"', head).group(1)
    head = head.replace(fixed, REPO)
    ns = {"__name__": "sc_mxu_probe", "__file__": PROBE}
    interpret = functools.partial(pallas.pallas_call, interpret=True)
    with mock.patch.object(pallas, "pallas_call", interpret):
        exec(compile(head, PROBE, "exec"), ns)
        z = jnp.zeros((ns["N"],), jnp.float32)
        planes = jnp.stack([ns["ox"], ns["oy"], ns["oz"], ns["dx"],
                            ns["dy"], ns["dz"], z, z], axis=0)
        t = np.asarray(ns["mxu_call"](planes)[0])
    np.savez_compressed(
        PATH, o=ns["o"][:KEEP], d=ns["d"][:KEEP], t=t[:KEEP],
        dirm=np.asarray(ns["dirm"]), orgm=np.asarray(ns["orgm"]),
        cons=np.asarray(ns["cons"]))
    print(f"wrote {PATH} ({os.path.getsize(PATH)} bytes); "
          f"{int(np.isfinite(t).sum())} of {t.size} casts hit")


if __name__ == "__main__":
    main()
