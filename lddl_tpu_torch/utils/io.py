"""Atomic publish on the local filesystem.

The port's own copy of ``atomic_publish`` and ``_fsync_dir`` from
``lddl_tpu/resilience/io.py`` (local files only: no storage backend, no
fault injection, no retries), extended to directories: a fully written
temporary file or directory is fsynced, renamed into place with
``os.replace`` and the rename made durable by an fsync of the parent
directory. A crash before the rename leaves the target as it was.
"""

import os


def _fsync_path(path):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path):
    """Flush the directory entry of ``path`` (the rename) to stable
    storage. Best effort: some filesystems refuse a directory fsync, and
    a refusal must not undo a completed replace."""
    try:
        _fsync_path(os.path.dirname(os.path.abspath(path)) or ".")
    except OSError:
        pass


def atomic_publish(tmp_path, path):
    """Move a fully written ``tmp_path`` (a file, or a directory of
    files) into place at ``path``: fsync its bytes, ``os.replace``, fsync
    the parent directory. A directory replaces only a missing or empty
    target."""
    if os.path.isdir(tmp_path):
        for dirpath, _, names in os.walk(tmp_path):
            for name in sorted(names):
                _fsync_path(os.path.join(dirpath, name))
            _fsync_path(dirpath)
    else:
        _fsync_path(tmp_path)
    os.replace(tmp_path, path)
    _fsync_dir(path)
