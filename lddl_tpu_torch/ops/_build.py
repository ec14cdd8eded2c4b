"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``ops/csrc/<name>.cu`` has a plain C interface and compiles on its
own into ``ops/_build/<name>-<hash>.so`` for ``sm_90a`` (the build
directory is git-ignored; the hash of the source, the shared headers
``csrc/*.cuh`` and the flags names the library, so an edited source or
header rebuilds). ptxas's report is kept beside each library as
``<name>-<hash>.log``, so a cached build still has it. Nothing is built
when a module is imported: the first kernel call builds, or ``build()``
does it up front, starting one ``nvcc`` per source at once.
"""

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

from ..resilience.io import atomic_publish

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded = {}
# ptxas's report (registers, shared memory, spills) of each library
# ``build`` returned, built now or before.
build_logs = {}


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.isfile(candidate):
        return candidate
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin); the CUDA "
                       "kernels build on a machine with the CUDA toolkit")


def _target(name):
    """(source path, library path). The library's name hashes the source,
    every shared header of ``csrc/`` and the flags, so an edit to any of
    them builds a new library."""
    src = os.path.join(_CSRC, name + ".cu")
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(glob.glob(os.path.join(_CSRC, "*.cuh")))
    for path in [src] + headers:
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + b"\0"
                          + f.read())
    return src, os.path.join(BUILD_DIR, "{}-{}.so".format(
        name, digest.hexdigest()[:16]))


def build(names):
    """Compile every named source not yet built, all ``nvcc`` processes
    started together; returns {name: path of the shared library} and
    fills ``build_logs``. Raises with the compiler's output when a build
    fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs, paths = {}, {}
    for name in names:
        src, out = _target(name)
        paths[name] = out
        log = out[:-len(".so")] + ".log"
        if os.path.isfile(out) and os.path.isfile(log):
            continue
        tmp = "{}.{}.tmp".format(out, os.getpid())
        log_tmp = "{}.{}.tmp".format(log, os.getpid())
        with open(log_tmp, "w") as f:
            procs[name] = (subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", tmp, src], stdout=f,
                stderr=subprocess.STDOUT), tmp, out, log_tmp, log)
    failed = []
    for name, (proc, tmp, out, log_tmp, log) in procs.items():
        proc.wait()
        if proc.returncode != 0:
            with open(log_tmp) as f:
                failed.append("{}:\n{}".format(name, f.read()))
            os.remove(log_tmp)
            continue
        atomic_publish(log_tmp, log)    # the log first: a library has one
        atomic_publish(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    for name, out in paths.items():
        with open(out[:-len(".so")] + ".log") as f:
            build_logs[name] = f.read()
    return paths


def load(name):
    """The ctypes library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(build([name])[name])
            _loaded[name] = lib
        return lib
