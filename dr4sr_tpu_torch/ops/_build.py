"""Build the port's CUDA kernels with ``nvcc`` at first use; load with ctypes.

Each ``csrc/<name>.cu`` has a plain C entry point and compiles on its own
into ``dr4sr_tpu_torch/_build/<name>-<hash>.so`` (the directory is listed in
``.gitignore``). The hash covers the source, every header in ``csrc/``
(``*.cuh``, ``*.h``) and the flags, so an edited kernel or header rebuilds
and an unchanged one loads at once. ``nvcc``'s output
(``-Xptxas -v``: registers, shared memory, spills) is kept beside the
library as ``<name>-<hash>.log``.

Nothing here runs at import: the CPU tests import every module on a machine
without ``nvcc``.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
from typing import Dict

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# every kernel source of the package, by name (csrc/<name>.cu)
KERNELS = ("flash_attention_fwd", "flash_attention_bwd", "moe_permute")


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
        path = cand if os.path.exists(cand) else None
    if path is None:
        raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): cannot build the CUDA kernels")
    return path


def source_path(name: str) -> str:
    return os.path.join(CSRC_DIR, name + ".cu")


def _headers():
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")) +
                  glob.glob(os.path.join(CSRC_DIR, "*.h")))


def library_path(name: str) -> str:
    """``BUILD_DIR/<name>-<hash>.so``; the hash covers the source, every
    header of ``csrc/`` (any kernel may include any of them) and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in (source_path(name), *_headers()):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its hashed library exists; return the path."""
    out = library_path(name)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, source_path(name)],
        capture_output=True, text=True,
    )
    with open(out[: -len(".so")] + ".log", "w") as f:
        f.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source_path(name)}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all of it or nothing
    return out


def build_all() -> Dict[str, str]:
    """Build every kernel, one ``nvcc`` per source, all started together."""
    with concurrent.futures.ThreadPoolExecutor(max_workers=len(KERNELS)) as pool:
        paths = list(pool.map(build, KERNELS))
    return dict(zip(KERNELS, paths))


def build_log(name: str) -> str:
    with open(library_path(name)[: -len(".so")] + ".log") as f:
        return f.read()


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built first if needed (once per process)."""
    return ctypes.CDLL(build(name))
