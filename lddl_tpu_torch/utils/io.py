"""Atomic publish on the local filesystem.

The port's own copy of ``atomic_publish``, ``_fsync_dir``,
``atomic_write``, ``read_table`` and ``write_table_atomic`` from
``lddl_tpu/resilience/io.py`` (local files only: no storage backend, no
fault injection, no retries), with ``atomic_publish`` extended to
directories: a fully written temporary file or directory is fsynced,
renamed into place with ``os.replace`` and the rename made durable by an
fsync of the parent directory. A crash before the rename leaves the
target as it was.
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


def _unlink_quietly(path):
    if os.path.exists(path):
        try:
            os.unlink(path)
        except OSError:
            pass


def atomic_write(path, data):
    """Durably and atomically write ``data`` (bytes or str) to ``path``:
    a crash leaves either the complete old file or the complete new one
    (tmp + fsync + ``os.replace`` + fsync of the directory)."""
    if isinstance(data, str):
        data = data.encode("utf-8")
    tmp = "{}.tmp.{}".format(path, os.getpid())
    try:
        with open(tmp, "wb") as f:
            f.write(data)
        atomic_publish(tmp, path)
    finally:
        _unlink_quietly(tmp)


def read_table(path):
    """One parquet shard as a pyarrow table."""
    import pyarrow.parquet as pq
    return pq.read_table(path)


def write_table_atomic(table, path, compression=None, **write_options):
    """Write a pyarrow table via tmp + fsync + replace, so a killed
    writer never leaves a torn shard under its final name;
    ``write_options`` pass through to ``pq.write_table``."""
    import pyarrow.parquet as pq
    tmp = "{}.tmp.{}".format(path, os.getpid())
    try:
        pq.write_table(table, tmp, compression=compression,
                       **write_options)
        atomic_publish(tmp, path)
    finally:
        _unlink_quietly(tmp)
