"""Build the port's CUDA sources with plain ``nvcc`` and load them with ctypes.

Each ``ops/csrc/<name>.cu`` exposes an ``extern "C"`` interface and includes
no PyTorch header, so it compiles in seconds. The shared library is built at
first use into ``jpdvt_mt_ntnu_tpu_torch/_build/`` (listed in
``.gitignore``), named by a hash of the sources and flags, so an edited
source is rebuilt and an unchanged one is loaded as it is.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
NVCC_TIMEOUT_S = 600


def nvcc_path() -> str:
    """``nvcc`` from PATH, else from $CUDA_HOME (default /usr/local/cuda)."""
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin; the "
                       "CUDA kernels need the CUDA toolkit to build")


def library_path(name: str) -> Path:
    """Where the library for ``csrc/<name>.cu`` lives once built."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built.

    The compiler's output (including ``-Xptxas -v``'s registers and shared
    memory per kernel) goes to ``<library>.log`` beside the library."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    log = out.with_suffix(".log")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    with open(log, "w") as lf:
        proc = subprocess.run(cmd, stdout=lf, stderr=subprocess.STDOUT,
                              stdin=subprocess.DEVNULL, timeout=NVCC_TIMEOUT_S)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc exited {proc.returncode} building {name}:\n"
                           f"{' '.join(cmd)}\n{log.read_text()}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


def build_all(*names: str) -> list[Path]:
    """:func:`build` each source, one ``nvcc`` per source, all started together."""
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        return list(pool.map(build, names))


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build if needed and load ``csrc/<name>.cu``'s library (once per process)."""
    return ctypes.CDLL(str(build(name)))
