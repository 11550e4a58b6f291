"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared library
with a plain C interface (``build/torch_kernels/lib<name>.so`` under the
checkout, the compiler's output beside it in ``lib<name>.log``), one
``<entry>_launch`` function per kernel entry, and loaded with
``ctypes``. Nothing is built when a module is
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
import re
import shutil
import subprocess
from typing import Callable, Dict, Iterable

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# each launch function ``<entry>_launch``: the source that defines it and
# its argument types (pointers and the stream as c_void_p); every launch
# function returns a cudaError_t
LAUNCHES = {
    "ray_tris": ("ray_tris", [_P] * 3 + [_I] * 4 + [_P] * 2),
    "ray_tris_v1": ("ray_tris", [_P] * 3 + [_I] * 2 + [_P] * 2),
    "fan_tris": ("fan_tris", [_P] * 7 + [_I] * 4 + [_P] * 2),
    "fan_culled": ("fan_culled", [_P] * 11 + [_I] * 4 + [_P] * 2),
    "fan_culled_v1": ("fan_culled", [_P] * 9 + [_I] * 4 + [_P] * 2),
    "fan_cell_order": ("fan_culled", [_P, _P, _I, _I, _P, _P]),
    "fan_v9": ("fan_v9", [_P] * 8 + [_I] * 3 + [_P] * 2),
    "fan_flat": ("fan_flat", [_P] * 4 + [_I] * 6 + [_P] * 2),
    "fan_flat_v1": ("fan_flat", [_P] * 4 + [_I] * 3 + [_P] * 2),
    "fan_capsules": ("fan_capsules",
                     [_P] * 7 + [_I] * 4 + [_F] * 2 + [_P] * 3),
    "fan_capsules_v1": ("fan_capsules",
                        [_P] * 6 + [_I] * 3 + [_F] * 2 + [_P] * 3),
    "fan_capsules_explicit": ("fan_capsules",
                              [_P] * 5 + [_I] * 3 + [_F] * 2 + [_P] * 3),
    "sphere_cast": ("sphere_cast", [_P] * 3 + [_F] + [_I] * 3 + [_P] * 3),
    "sphere_cast_dense_v1": ("sphere_cast", [_P] * 3 + [_F, _I, _I]
                             + [_P] * 3),
    "sphere_cast_culled": ("sphere_cast", [_P] * 3 + [_F, _I, _I]
                           + [_P] * 3 + [_I] + [_P] * 3),
    "sphere_cast_culled_v1": ("sphere_cast", [_P] * 3 + [_F, _I] + [_P] * 2
                              + [_I] * 2 + [_P] * 3),
    "sphere_cast_normal": ("sphere_cast", [_P] * 3 + [_F] + [_I] * 3
                           + [_F, _I] + [_P] * 3),
    "sphere_cast_normal_v1": ("sphere_cast", [_P] * 3 + [_F, _I, _I, _F, _I]
                              + [_P] * 3),
    # a pointer to the argument struct (ops/tail_fused.py _TailArgs)
    "tail_fused": ("tail_fused", [_P, _P]),
    "tail_fused_v1": ("tail_fused", [_P, _P]),
    # a pointer to the argument struct (tools/probes/movement_fused_probe.py
    # _MoveArgs)
    "move_fused": ("move_fused", [_P, _P]),
    "fan_v9_chunked": ("fan_v9", [_P] * 8 + [_I] * 3 + [_P] * 2),
    "fan_v9_gathered": ("fan_v9", [_P] * 7 + [_I] * 3 + [_P] * 2),
    "fan_probe": ("fan_probe", [_I] + [_P] * 8 + [_I] * 4 + [_P] * 2),
    "sc_mxu": ("sc_mxu", [_P] * 4 + [_F, _I, _I] + [_P] * 2),
    "vpu_chain": ("vpu_probe", [_I] + [_P] * 3 + [_I] * 3 + [_P]),
    "vpu_mma": ("vpu_probe", [_P] * 3 + [_I] * 4 + [_P]),
}
KERNEL_SOURCES = tuple(dict.fromkeys(src for src, _ in LAUNCHES.values()))

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, spills and stack per kernel -> build_log
]

_LAUNCHERS: Dict[str, Callable[..., int]] = {}
# the compiler's output of each source built or read by this process
BUILD_LOG: Dict[str, str] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _paths(name: str):
    return os.path.join(CSRC, f"{name}.cu"), os.path.join(
        BUILD_DIR, f"lib{name}.so"
    )


def _log_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.log")


def lib_path(name: str) -> str:
    """The shared library built from ``csrc/<name>.cu``."""
    return _paths(name)[1]


def _stale(name: str) -> bool:
    src, lib = _paths(name)
    if not (os.path.exists(lib) and os.path.exists(_log_path(name))):
        return True
    deps = [src] + [
        os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith(".cuh")
    ]
    return max(os.path.getmtime(p) for p in deps) > os.path.getmtime(lib)


def build_all(names: Iterable[str] = KERNEL_SOURCES) -> None:
    """Compile every stale source, one nvcc process per source, all started
    together. Raises with the compiler's output if any build fails."""
    stale = [name for name in names if _stale(name)]
    if not stale:
        return
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in stale:
        src, lib = _paths(name)
        tmp = f"{lib}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC, "-o", tmp, src]
        procs.append((name, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    failed = []
    for name, lib, tmp, p in procs:
        out, _ = p.communicate()
        BUILD_LOG[name] = out
        if p.returncode != 0:
            failed.append(f"--- {name} ---\n{out}")
        else:
            with open(f"{tmp}.log", "w") as f:
                f.write(out)
            os.replace(f"{tmp}.log", _log_path(name))
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


def build_log(name: str) -> str:
    """The compiler's output for ``csrc/<name>.cu``: this process's build,
    else the log saved beside the library ("" if neither exists)."""
    if name not in BUILD_LOG:
        try:
            with open(_log_path(name)) as f:
                BUILD_LOG[name] = f.read()
        except FileNotFoundError:
            return ""
    return BUILD_LOG[name]


def ptxas_usage(name: str, kernel: str):
    """(registers, spill store + spill load bytes) of the kernel whose
    mangled name holds ``kernel``, from ptxas -v's output for
    ``csrc/<name>.cu`` (build_log)."""
    regs = spill = None
    mine = False
    for line in build_log(name).splitlines():
        if "Compiling entry function" in line or "Function properties" in line:
            mine = kernel in line
        elif mine and "spill stores" in line:
            st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
            spill = int(st) + int(ld)
        elif mine and "registers" in line:
            regs = int(re.search(r"Used (\d+) registers", line).group(1))
    if regs is None or spill is None:
        raise ValueError(f"no ptxas -v lines for {kernel} in {name}")
    return regs, spill


def launcher(entry: str):
    """``<entry>_launch`` of the source that defines it, with its
    signature declared, the library built and loaded on first use."""
    fn = _LAUNCHERS.get(entry)
    if fn is None:
        src, argtypes = LAUNCHES[entry]
        if _stale(src):
            build_all([src])
        fn = getattr(ctypes.CDLL(_paths(src)[1]), f"{entry}_launch")
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _LAUNCHERS[entry] = fn
    return fn


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch function."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
