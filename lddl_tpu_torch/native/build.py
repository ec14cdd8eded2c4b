"""Build the native engine's shared library with g++ at first use.

Counterpart of ``lddl_tpu/native/build.py``, without its table
regeneration: ``unicode_tables.h`` is committed and only regenerated by
hand (see ``gen_tables``). The library goes to the git-ignored
``_build/`` directory under a name keyed by a digest of the sources, the
compiler flags (``-march`` among them: ``LDDL_TPU_NATIVE_MARCH``,
default ``native``), the sanitizer modes and the host's CPU flags
(``-march=native`` bakes the build host's ISA in), so a changed source,
another host, another ``-march`` or another mode builds its own library
beside the others and a stale one is never loaded. A failed build raises
with the compiler's output: the port has no fallback engine.

Sanitizer modes, as the reference's: ``LDDL_TPU_NATIVE_SANITIZE`` is a
comma-separated subset of ``tsan``, ``asan`` and ``ubsan``
(``sanitize_modes``). A sanitized build trades ``-O3`` for ``-O1 -g
-fno-omit-frame-pointer`` plus each ``-fsanitize=`` flag
(``compile_flags``) and lives under a name that shows its modes
(``lddl_native.san-tsan-ubsan-<hash>.so``), so a sanitized and a normal
library never stand in for each other. Loading a tsan or asan library
into Python needs the sanitizer's runtime in ``LD_PRELOAD``
(``tools/sanitize_smoke.py`` sets it up).
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

# -pthread: the engine runs an in-kernel thread pool.
_BASE_FLAGS = ("-std=c++17", "-shared", "-fPIC", "-pthread")

_SANITIZE_FLAGS = {
    "tsan": ("-fsanitize=thread",),
    "asan": ("-fsanitize=address",),
    "ubsan": ("-fsanitize=undefined",),
}


def sanitize_modes():
    """The sanitizer modes ``LDDL_TPU_NATIVE_SANITIZE`` asks for (a
    comma-separated subset of tsan/asan/ubsan), as a sorted tuple; ()
    means a normal build. An unknown mode raises, as does tsan with asan
    (gcc cannot combine their runtimes): a typo must not build an
    uninstrumented engine that a sanitizer check then passes."""
    raw = os.environ.get("LDDL_TPU_NATIVE_SANITIZE", "").strip()
    if not raw:
        return ()
    modes = sorted({m.strip() for m in raw.split(",") if m.strip()})
    bad = [m for m in modes if m not in _SANITIZE_FLAGS]
    if bad:
        raise ValueError(
            "LDDL_TPU_NATIVE_SANITIZE={!r}: unknown mode(s) {}; expected "
            "a comma-separated subset of {}".format(
                raw, bad, "/".join(sorted(_SANITIZE_FLAGS))))
    if "tsan" in modes and "asan" in modes:
        raise ValueError(
            "LDDL_TPU_NATIVE_SANITIZE: tsan and asan are mutually "
            "exclusive (gcc cannot combine their runtimes)")
    return tuple(modes)


def march():
    """The build's ``-march``: ``LDDL_TPU_NATIVE_MARCH``, default
    ``native`` (the engine builds on the machine that runs it, 2x on the
    WordPiece/UTF-8 hot loops against plain -O3). A fleet of mixed hosts
    that shares one prebuilt tree pins it, e.g. ``x86-64-v3``."""
    return os.environ.get("LDDL_TPU_NATIVE_MARCH", "native")


def compile_flags(modes=None):
    """The g++ flags of a build for ``modes`` (default: the
    environment's) at ``march()``. A sanitized build takes ``-O1 -g
    -fno-omit-frame-pointer`` in place of ``-O3``, so reports carry
    usable stacks and races are not optimized away."""
    modes = sanitize_modes() if modes is None else tuple(modes)
    base = ["-march=" + march(), *_BASE_FLAGS]
    if not modes:
        return ["-O3", *base]
    flags = ["-O1", "-g", "-fno-omit-frame-pointer", *base]
    for m in modes:
        flags.extend(_SANITIZE_FLAGS[m])
    return flags


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


def lib_path(modes=None):
    """Where the library for these sources, sanitizer modes (default:
    the environment's), flags and host lives."""
    modes = sanitize_modes() if modes is None else tuple(modes)
    h = hashlib.sha256()
    for path in (SRC, TABLES):
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(compile_flags(modes)).encode())
    h.update(("sanitize=" + ",".join(modes)).encode())
    h.update(platform.machine().encode())
    h.update(_cpu_flags().encode())
    stem = ("lddl_native.san-" + "-".join(modes)) if modes else "lddl_native"
    return os.path.join(BUILD_DIR,
                        "{}-{}.so".format(stem, h.hexdigest()[:16]))


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
    """Build the library for ``LDDL_TPU_NATIVE_SANITIZE``'s modes if it
    is not there yet and return its path; raises ``RuntimeError`` with
    the compiler's output when g++ fails."""
    modes = sanitize_modes()
    path = lib_path(modes)
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    with _build_lock():
        if os.path.exists(path):  # another process built it meanwhile
            return path
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
        os.close(fd)
        try:
            proc = subprocess.run(["g++", *compile_flags(modes), SRC,
                                   "-o", tmp],
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
