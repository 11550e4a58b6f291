"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared library
with a plain C interface (``build/torch_kernels/lib<name>.so`` under the
checkout) and loaded with ``ctypes``. Nothing is built when a module is
imported: ``launcher`` builds on first use, and ``build_all`` starts one
``nvcc`` per source at once so that a first run pays for the slowest file
only.

Flags: ``-gencode arch=compute_90a,code=sm_90a -O3``, never
``--use_fast_math`` (padding triangles carry all-zero constants and rely
on NaN compares being false), and ``--fmad=false``: every kernel repeats
its plain PyTorch version operation for operation, and without fused
multiply-adds it rounds each step as the plain version does, so the two
agree bit for bit on the same inputs.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from typing import Callable, Dict, Iterable

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# argument types of each source's ``<name>_launch`` (pointers and the
# stream as c_void_p); every launch function returns a cudaError_t
LAUNCH_ARGTYPES = {
    "ray_tris": [_P] * 3 + [_I] * 2 + [_P] * 2,
    "fan_tris": [_P] * 7 + [_I] * 4 + [_P] * 2,
    "fan_culled": [_P] * 9 + [_I] * 4 + [_P] * 2,
    "fan_v9": [_P] * 8 + [_I] * 3 + [_P] * 2,
    "fan_capsules": [_P] * 6 + [_I] * 3 + [_F] * 2 + [_P] * 3,
    "sphere_cast": [_P] * 3 + [_F, _I, _I] + [_P] * 2 + [_I] * 2 + [_P] * 3,
    # a pointer to the argument struct (ops/tail_fused.py _TailArgs)
    "tail_fused": [_P, _P],
}
KERNEL_SOURCES = tuple(LAUNCH_ARGTYPES)

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
]

_LAUNCHERS: Dict[str, Callable[..., int]] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _paths(name: str):
    return os.path.join(CSRC, f"{name}.cu"), os.path.join(
        BUILD_DIR, f"lib{name}.so"
    )


def _stale(name: str) -> bool:
    src, lib = _paths(name)
    if not os.path.exists(lib):
        return True
    deps = [src] + [
        os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith(".cuh")
    ]
    return max(os.path.getmtime(p) for p in deps) > os.path.getmtime(lib)


def build_all(names: Iterable[str] = KERNEL_SOURCES) -> None:
    """Compile every stale source, one nvcc process per source, all started
    together. Raises with the compiler's output if any build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in names:
        if not _stale(name):
            continue
        src, lib = _paths(name)
        tmp = f"{lib}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC, "-o", tmp, src]
        procs.append((name, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    failed = []
    for name, lib, tmp, p in procs:
        out, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"--- {name} ---\n{out}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


def launcher(name: str):
    """``<name>_launch`` of ``csrc/<name>.cu`` with its signature declared,
    the library built and loaded on first use."""
    fn = _LAUNCHERS.get(name)
    if fn is None:
        if _stale(name):
            build_all([name])
        fn = getattr(ctypes.CDLL(_paths(name)[1]), f"{name}_launch")
        fn.argtypes = LAUNCH_ARGTYPES[name]
        fn.restype = ctypes.c_int
        _LAUNCHERS[name] = fn
    return fn


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch function."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
