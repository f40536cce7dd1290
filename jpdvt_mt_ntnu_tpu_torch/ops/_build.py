"""Build the port's native sources and load them with ctypes.

Each ``ops/csrc/<name>.cu`` (built with plain ``nvcc``) or
``ops/csrc/<name>.cpp`` (host code, built with ``g++``) exposes an
``extern "C"`` interface and includes no PyTorch header, so it compiles in
seconds. The shared library is built at first use into
``jpdvt_mt_ntnu_tpu_torch/_build/`` (listed in ``.gitignore``), named by a
hash of the source and flags, so an edited source is rebuilt and an
unchanged one is loaded as it is. A failed build raises.

A kernel source built for more than one attention head dim is compiled
once per head dim, each into a library of its own: the unit
``<name>_d<Dh>`` (:func:`unit`) is ``csrc/<name>.cu`` with
``-DHEAD_DIM=<Dh>``, and ``<name>`` alone is the source at its default,
Dh 64.

``transforms.cpp`` is built with ``-ffp-contract=off``: its float
arithmetic is Pillow's, rounding for rounding, and a fused multiply-add
would round once less. ``decode.cpp`` links no image library: the port
decodes JPEG with its own code on every machine.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")
NVCC_TIMEOUT_S = 600
BUILD_SECONDS: dict[str, float] = {}  # name -> seconds of its compile in this process


def nvcc_path() -> str:
    """``nvcc`` from PATH, else from $CUDA_HOME (default /usr/local/cuda)."""
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin; the "
                       "CUDA kernels need the CUDA toolkit to build")


_HEAD_DIM_UNIT = re.compile(r"(.+)_d(\d+)")
DEFAULT_HEAD_DIM = 64


def unit(name: str, head_dim: int) -> str:
    """The build unit of source ``name`` at ``head_dim``: ``name`` at the
    default (64), else ``<name>_d<head_dim>``."""
    return name if head_dim == DEFAULT_HEAD_DIM else f"{name}_d{head_dim}"


def _split(name: str) -> tuple[str, int | None]:
    """``<source>_d<Dh>`` -> (source, Dh); any other name -> (name, None)."""
    m = _HEAD_DIM_UNIT.fullmatch(name)
    return (m[1], int(m[2])) if m else (name, None)


def _source(name: str) -> Path:
    base = _split(name)[0]
    cu = CSRC / f"{base}.cu"
    return cu if cu.exists() else CSRC / f"{base}.cpp"


def _compiler(src: Path) -> list[str]:
    if src.suffix == ".cu":
        return [nvcc_path(), *NVCC_FLAGS]
    return ["g++", *CXX_FLAGS]


def extra_flags(name: str) -> tuple[str, ...]:
    """Flags of one unit beyond its compiler's, placed after the source
    so that they can name libraries to link."""
    if name == "transforms":
        return ("-ffp-contract=off",)
    head_dim = _split(name)[1]
    return () if head_dim is None else (f"-DHEAD_DIM={head_dim}",)


def library_path(name: str) -> Path:
    """Where the library of unit ``name`` (``csrc/<name>.cu`` or ``.cpp``,
    or a head-dim unit of a ``.cu``) lives once built."""
    src = _source(name)
    flags = (*(NVCC_FLAGS if src.suffix == ".cu" else CXX_FLAGS), *extra_flags(name))
    h = hashlib.sha256(" ".join(flags).encode())
    h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` (or ``.cpp``) unless its library is
    already built.

    The compiler's output (including ``-Xptxas -v``'s registers and shared
    memory per kernel) goes to ``<library>.log`` beside the library."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    log = out.with_suffix(".log")
    src = _source(name)
    cmd = [*_compiler(src), "-o", str(tmp), str(src), *extra_flags(name)]
    t0 = time.perf_counter()
    with open(log, "w") as lf:
        proc = subprocess.run(cmd, stdout=lf, stderr=subprocess.STDOUT,
                              stdin=subprocess.DEVNULL, timeout=NVCC_TIMEOUT_S)
    BUILD_SECONDS[name] = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"{cmd[0]} exited {proc.returncode} building {name}:\n"
                           f"{' '.join(cmd)}\n{log.read_text()}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


def build_all(*names: str) -> list[Path]:
    """:func:`build` each unit, one compiler per unit, all started together."""
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        return list(pool.map(build, names))


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build if needed and load ``csrc/<name>``'s library (once per process)."""
    return ctypes.CDLL(str(build(name)))
