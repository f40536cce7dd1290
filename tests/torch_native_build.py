"""The JAX package's native library, built once across test processes.

``jpdvt_mt_ntnu_tpu/ops/native.py`` builds ``native/build/libjpdvt_native.so``
with ``make -C native`` at its first load and remembers a load that failed.
On a tree without ``native/build/`` (it is git-ignored), pytest-xdist
workers that reach it at once run one build each into the same files; a
worker whose ``make`` or load fails meanwhile keeps ``available()`` False
for the rest of its tests. :func:`jax_native` builds the library under an
``fcntl`` lock and loads it again where a load failed before; where the
library is missing or does not load (another worker's ``make`` may still
be writing it), it builds a copy in a directory of its own, loads that,
and moves one into place whole for the processes after it. The port's
test modules that use it call it at import with ``required=False``:
every xdist worker imports every test module before it runs a test, so
each worker holds the loaded library before any test of either package
reaches ``make``.
"""

import fcntl
import os
import shutil
import subprocess


def jax_native(required: bool = True):
    """``jpdvt_mt_ntnu_tpu.ops.native`` with its library loaded; if it
    cannot be built or loaded, raises, or with ``required`` False returns
    the module as it stands."""
    from jpdvt_mt_ntnu_tpu.ops import native

    if native._lib is not None:
        return native
    shared = native._SO_PATH
    os.makedirs(os.path.dirname(shared), exist_ok=True)
    with open(os.path.join(os.path.dirname(shared), ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            native._tried = False  # a load that failed while another process built
            if os.path.exists(shared) and native._load() is not None:
                return native
            # Missing, or not loadable: another worker's unlocked make may be
            # writing it. Build a copy of this process's own and load that.
            own = os.path.join(os.path.dirname(shared), f"tmp-{os.getpid()}")
            try:
                subprocess.run(["make", "-C", native._NATIVE_DIR, f"BUILD={own}"],
                               check=True, capture_output=True, timeout=300)
                mine = os.path.join(own, os.path.basename(shared))
                native._SO_PATH, native._tried = mine, False
                try:
                    loaded = native._load()
                finally:
                    native._SO_PATH = shared
                if not os.path.exists(shared):  # for the processes after this one
                    shutil.copy2(mine, f"{mine}.copy")
                    os.replace(f"{mine}.copy", shared)
            finally:
                shutil.rmtree(own, ignore_errors=True)
            if loaded is None:
                raise RuntimeError(f"the JAX package's native library, built at {own}, "
                                   "does not load")
        except (OSError, RuntimeError, subprocess.SubprocessError):
            if required:
                raise
    return native
