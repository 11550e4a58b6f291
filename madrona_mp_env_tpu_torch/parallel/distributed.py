"""Multi-process setup (the JAX package's parallel/distributed.py): one
process per rank, each owning one device.

    init_distributed("nccl", "tcp://host:29500", world_size=4, rank=r)
    mesh = global_mesh(num_worlds=4096)         # rank r: worlds r*1024...
    env = Env(cfg, scene, mesh.local_worlds, world_offset=mesh.world_lo,
              device=f"cuda:{r % torch.cuda.device_count()}")
    mgr = TrainingManager(cfg, tcfg, env, device=env.device, mesh=mesh)
    ts = global_init(mgr)

``launch`` starts N local ranks (the train CLI's ``--num-devices``). The
backend and the init method are always explicit: nothing here reads a
cluster's environment.
"""

from __future__ import annotations

import datetime
import multiprocessing
import socket
import time
from typing import Callable, Optional, Sequence

import torch

from . import collectives
from .sharding import DataMesh, make_data_mesh


def init_distributed(backend: str, init_method: str, world_size: int,
                     rank: int, timeout_s: float = 600.0) -> None:
    """torch.distributed.init_process_group with the backend ("nccl" or
    "gloo"), the init method ("tcp://host:port" or "file://path"), the
    world size and this process's rank given."""
    import torch.distributed as dist

    dist.init_process_group(backend=backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))


def global_mesh(num_worlds: int, num_devices: Optional[int] = None
                ) -> DataMesh:
    """The mesh over every rank of the default group (after
    init_distributed); ``num_devices`` must then equal its size."""
    import torch.distributed as dist

    size = dist.get_world_size()
    if num_devices and num_devices != size:
        raise ValueError(f"{num_devices} devices asked, the process group "
                         f"has {size} ranks")
    return make_data_mesh(num_worlds, dist.group.WORLD)


def global_init(mgr, seed: Optional[int] = None, params=None):
    """Each rank's share of ``mgr.init(seed, params)`` (its worlds, its
    members of the blocks, the replicated rest), with a check that every
    rank made the same replicated state (the same seed and weights)."""
    ts = mgr.init(seed, params)
    collectives.check_replicated(
        mgr.mesh, [ts.key, ts.elo, ts.hyper_params["lr"]]
        + [v for p in ts.params for v in p.values()], "initial state")
    return ts


def free_init_method() -> str:
    """A tcp:// init method on a free local port."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"tcp://127.0.0.1:{s.getsockname()[1]}"


def _rank_main(fn, rank, world_size, backend, init_method, threads, args):
    """A spawned rank: its process group around ``fn(*args)`` (an
    exception ends the process with exit code 1 and its traceback)."""
    import torch.distributed as dist

    if threads:
        torch.set_num_threads(threads)
    init_distributed(backend, init_method, world_size, rank)
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, nprocs: int, args: Sequence = (),
           backend: str = "gloo", init_method: Optional[str] = None,
           threads: Optional[int] = None,
           timeout_s: Optional[float] = None) -> None:
    """Run ``fn(*args)`` in ``nprocs`` new processes (spawned: ``fn`` and
    ``args`` must pickle), rank r of a process group of ``backend`` in
    each; ``threads``: ATen's intra-op threads per rank. Raises
    RuntimeError when a rank fails or the group outlives ``timeout_s``
    (None: no limit); every rank is stopped either way."""
    init_method = init_method or free_init_method()
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(
        fn, r, nprocs, backend, init_method, threads, tuple(args)))
        for r in range(nprocs)]
    for p in procs:
        p.start()
    try:
        deadline = time.monotonic() + (timeout_s or float("inf"))
        pending = list(procs)
        while pending:
            left = deadline - time.monotonic()
            if left <= 0:
                raise RuntimeError(f"ranks still running after {timeout_s} s")
            pending[0].join(min(left, 1.0))
            for p in list(pending):
                if p.exitcode is None:
                    continue
                pending.remove(p)
                if p.exitcode != 0:
                    raise RuntimeError(
                        f"rank {procs.index(p)} exited with {p.exitcode}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
