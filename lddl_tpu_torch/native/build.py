"""Build the native engine's shared library with g++ at first use.

Counterpart of ``lddl_tpu/native/build.py``, without its sanitizer modes
and its table regeneration: ``unicode_tables.h`` is committed and only
regenerated by hand (see ``gen_tables``). The library goes to the
git-ignored ``_build/`` directory under a name keyed by a digest of the
sources, the compiler flags and the host's CPU flags (``-march=native``
bakes the build host's ISA in), so a changed source or another host
builds its own library and a stale one is never loaded. A failed build
raises with the compiler's output: the port has no fallback engine.
"""

import contextlib
import hashlib
import os
import platform
import subprocess
import tempfile

from ..utils.io import atomic_publish

_DIR = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_DIR, "lddl_native.cpp")
TABLES = os.path.join(_DIR, "unicode_tables.h")
BUILD_DIR = os.path.join(_DIR, "_build")

# -march=native: the engine builds on the machine that runs it (2x on the
# WordPiece/UTF-8 hot loops against plain -O3). -pthread: the engine runs
# an in-kernel thread pool.
FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
         "-pthread")


def _cpu_flags():
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    return line
    # /proc/cpuinfo probe is a cache-tag refinement; absent (non-Linux)
    # just means a coarser tag.
    except OSError:  # lddl: disable=swallowed-error
        pass
    return ""


def lib_path():
    """Where the library for these sources, flags and host lives."""
    h = hashlib.sha256()
    for path in (SRC, TABLES):
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(FLAGS).encode())
    h.update(platform.machine().encode())
    h.update(_cpu_flags().encode())
    return os.path.join(BUILD_DIR,
                        "lddl_native-{}.so".format(h.hexdigest()[:16]))


@contextlib.contextmanager
def _build_lock():
    """Cross-process exclusive lock, so the workers of a pool that start
    together build once, not once each."""
    import fcntl
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def ensure_built():
    """Build the library if it is not there yet and return its path;
    raises ``RuntimeError`` with the compiler's output when g++ fails."""
    path = lib_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    with _build_lock():
        if os.path.exists(path):  # another process built it meanwhile
            return path
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
        os.close(fd)
        try:
            proc = subprocess.run(["g++", *FLAGS, SRC, "-o", tmp],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError("building the native engine failed "
                                   "(g++ exit {}):\n{}".format(
                                       proc.returncode, proc.stderr))
            atomic_publish(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return path


if __name__ == "__main__":
    print(ensure_built())
