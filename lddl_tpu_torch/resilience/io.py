"""Resilient I/O primitives: transient-error retries and durable atomic
writes, over the storage backend.

Counterpart of ``lddl_tpu/resilience/io.py``, and the one home of the
port's atomic writers (``utils/io.py`` re-exports them).

- Retrying: ``with_retries`` runs an operation with exponential backoff,
  jitter and a total deadline, retrying only transient OSErrors (EIO,
  ESTALE, ...); a missing file or a permission error fails at once.
- Publishing: ``atomic_write``/``atomic_publish``/``write_table_atomic``/
  ``atomic_copy`` place a file (or, for ``atomic_publish``, a directory)
  in a shard directory through a temporary in the same directory, fsync,
  then ``os.replace`` and an fsync of the directory: a crash leaves the
  old target or the new one, never a torn one. ``put_exclusive`` is the
  create-only publish of a commit record, ``remove`` the backend-routed
  delete, ``open_append`` a retried open of a local append file.
- Reading: ``read_bytes``, ``read_table``, ``read_shard_bytes`` (with a
  version for the loader's shard cache), ``object_head``, ``read_range``,
  ``read_json``, ``list_dir``.

Every primitive calls ``faults.fault_point`` at its guarded operations.
Under the default LocalBackend every branch is plain POSIX code (the
dispatch check is one env-dict lookup); under
``LDDL_TPU_STORAGE_BACKEND=mock`` publishes become
multipart-upload-then-commit and reads resolve the newest commit.

Env knobs::

    LDDL_TPU_RETRY_ATTEMPTS      max attempts per operation (default 5)
    LDDL_TPU_RETRY_DEADLINE_S    total time budget per operation (60)
    LDDL_TPU_RETRY_BASE_DELAY_S  first backoff delay (0.05)
    LDDL_TPU_RETRY_MAX_DELAY_S   backoff cap (2.0)
"""

import errno
import json
import os
import random
import time

from . import backend as _backend
from . import faults
from ..observability import enabled as obs_enabled
from ..observability import event as obs_event
from ..observability import fleet
from ..observability import inc as obs_inc

# OSError errnos that plausibly heal on retry on shared storage.
TRANSIENT_ERRNOS = frozenset(
    getattr(errno, name) for name in (
        "EIO", "ESTALE", "EAGAIN", "EINTR", "EBUSY", "ETIMEDOUT",
        "ECONNRESET", "ECONNABORTED", "ENETRESET", "EHOSTUNREACH",
        "ENOBUFS", "EREMOTEIO",
    ) if hasattr(errno, name))


def is_transient(exc):
    """True for OSErrors worth retrying (flaky NFS/object-store mounts)."""
    return isinstance(exc, OSError) and exc.errno in TRANSIENT_ERRNOS


def _env_float(name, default):
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def retry_policy():
    """The active retry knobs."""
    return {
        "attempts": int(_env_float("LDDL_TPU_RETRY_ATTEMPTS", 5)),
        "deadline_s": _env_float("LDDL_TPU_RETRY_DEADLINE_S", 60.0),
        "base_delay_s": _env_float("LDDL_TPU_RETRY_BASE_DELAY_S", 0.05),
        "max_delay_s": _env_float("LDDL_TPU_RETRY_MAX_DELAY_S", 2.0),
    }


def _mock_backend():
    """The active non-POSIX backend, or None under LocalBackend."""
    if _backend.active_name() == "local":
        return None
    return _backend.get_backend()


def backend_if_nonlocal():
    """The active non-POSIX backend instance, or None under the default
    LocalBackend."""
    return _mock_backend()


def _lat_start():
    return time.perf_counter() if obs_enabled() else None


def _lat_end(t0, op):
    if t0 is not None:
        _backend.observe_latency(_backend.active_name(), op,
                                 time.perf_counter() - t0)


_jitter_rng = random.Random()


def with_retries(fn, desc="operation", attempts=None, deadline_s=None,
                 base_delay_s=None, max_delay_s=None, retryable=is_transient):
    """``fn()`` with exponential backoff, jitter and a total deadline,
    retrying only exceptions ``retryable`` accepts. The final failure
    raises an OSError naming the attempts, chained to the last error.
    Retries count in ``resilience_retry_attempts_total{op}``."""
    policy = retry_policy()
    attempts = attempts if attempts is not None else policy["attempts"]
    deadline_s = (deadline_s if deadline_s is not None
                  else policy["deadline_s"])
    base = (base_delay_s if base_delay_s is not None
            else policy["base_delay_s"])
    cap = max_delay_s if max_delay_s is not None else policy["max_delay_s"]
    t0 = time.monotonic()
    attempt = 0
    while True:
        attempt += 1
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 - filtered by retryable()
            if not retryable(e):
                raise
            elapsed = time.monotonic() - t0
            op = desc.split(" ", 1)[0]
            if attempt >= attempts or elapsed >= deadline_s:
                obs_inc("resilience_retry_exhausted_total", op=op)
                fleet.record("io.retry_exhausted", op=op,
                             error="{}: {}".format(type(e).__name__,
                                                   e)[:200])
                raise OSError(
                    getattr(e, "errno", None) or errno.EIO,
                    "{} failed after {} attempt(s) over {:.1f}s: {}".format(
                        desc, attempt, elapsed, e),
                    getattr(e, "filename", None)) from e
            # Jitter shapes only WHEN a retry runs, never what is read or
            # written; an unkeyed stream keeps ranks from retrying in step.
            delay = min(cap, base * (2 ** (attempt - 1)))
            delay *= _jitter_rng.uniform(0.5, 1.5)
            delay = min(delay, max(0.0, deadline_s - elapsed))
            obs_inc("resilience_retry_attempts_total", op=op)
            obs_event("resilience.retry", op=op, attempt=attempt,
                      error="{}: {}".format(type(e).__name__, e)[:200])
            time.sleep(delay)


def _fsync_path(path):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path):
    """Flush the directory entry of ``path`` (the rename) to stable
    storage, retrying transient errors. Best effort past that: some
    filesystems refuse a directory fsync, and a refusal must not undo a
    completed replace."""
    dirname = os.path.dirname(os.path.abspath(path)) or "."
    try:
        with_retries(lambda: _fsync_path(dirname),
                     desc="fsync dir {}".format(dirname))
    except OSError:
        pass


def atomic_publish(tmp_path, path, fsync_file=True):
    """Move a fully written ``tmp_path`` (a file, or a directory of
    files) into place at ``path``: fsync its bytes, ``os.replace``, fsync
    the parent directory. A directory replaces only a missing or empty
    target. On the mock object store a file is published by
    multipart-upload-then-commit and the temporary is removed."""
    bk = _mock_backend()
    t0 = _lat_start()
    if bk is not None and not os.path.isdir(tmp_path):
        bk.put_file(tmp_path, path)
        try:
            os.unlink(tmp_path)
        except OSError:
            pass
        _lat_end(t0, "put")
        return
    if os.path.isdir(tmp_path):
        for dirpath, _, names in os.walk(tmp_path):
            for name in sorted(names):
                _fsync_path(os.path.join(dirpath, name))
            _fsync_path(dirpath)
    elif fsync_file:
        _fsync_path(tmp_path)
    faults.fault_point("replace", path)
    os.replace(tmp_path, path)
    _fsync_dir(path)
    _backend.count("local", "put", "ok")
    _lat_end(t0, "put")


def _unlink_quietly(path):
    if os.path.exists(path):
        try:
            os.unlink(path)
        except OSError:
            pass


def atomic_write(path, data, retries=True):
    """Durably and atomically write ``data`` (bytes or str) to ``path``
    (tmp + fsync + ``os.replace`` + fsync of the directory), retrying
    transient errors; the temporary is always removed on failure."""
    if isinstance(data, str):
        data = data.encode("utf-8")
    tmp = "{}.tmp.{}".format(path, os.getpid())

    def _write():
        faults.fault_point("open", path)
        try:
            with open(tmp, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            atomic_publish(tmp, path, fsync_file=False)
        finally:
            _unlink_quietly(tmp)

    if retries:
        return with_retries(_write, desc="atomic_write {}".format(path))
    return _write()


def atomic_copy(src, path, retries=True):
    """Atomically publish the durable file ``src`` at ``path`` without
    loading it: hard-link it to a temporary and replace (a chunked copy
    + fsync where hard links fail). ``src`` stays in place, so a crashed
    publish re-runs idempotently; the target is never torn. On the mock
    store ``src``'s bytes are multipart-uploaded."""
    tmp = "{}.tmp.{}".format(path, os.getpid())

    def _copy():
        bk = _mock_backend()
        if bk is not None:
            bk.put_file(src, path)
            return
        faults.fault_point("open", path)
        try:
            try:
                os.link(src, tmp)
                atomic_publish(tmp, path, fsync_file=False)
            except OSError:
                # No hard links here (or a stale temporary): copy.
                _unlink_quietly(tmp)
                with open(src, "rb") as fin, open(tmp, "wb") as fout:
                    while True:
                        chunk = fin.read(1 << 20)
                        if not chunk:
                            break
                        fout.write(chunk)
                    fout.flush()
                    os.fsync(fout.fileno())
                atomic_publish(tmp, path, fsync_file=False)
        finally:
            _unlink_quietly(tmp)

    if retries:
        return with_retries(_copy, desc="atomic_copy {}".format(path))
    return _copy()


def read_bytes(path, retries=True):
    """A whole file, with transient-error retries and fault injection (a
    ``truncate`` fault chops the payload, like a torn read)."""

    def _read():
        bk = _mock_backend()
        t0 = _lat_start()
        if bk is not None:
            data = bk.get(path)
            _lat_end(t0, "get")
            return data
        faults.fault_point("open", path)
        with open(path, "rb") as f:
            data = f.read()
        if faults.fault_point("read", path) == "truncate":
            data = data[:max(0, len(data) // 2 - 1)]
        _backend.count("local", "get", "ok")
        _lat_end(t0, "get")
        return data

    if retries:
        return with_retries(_read, desc="read {}".format(path))
    return _read()


def object_head(path):
    """(size_bytes, version) of ``path`` without reading data: the mock
    store's commit generation, or the (size, mtime_ns) stat pair on
    POSIX. (None, None) when absent."""
    bk = _mock_backend()
    if bk is not None:
        return bk.head(path)
    try:
        st = os.stat(path)
    except FileNotFoundError:
        return None, None
    return st.st_size, (st.st_size, st.st_mtime_ns)


def read_range(path, start, length, retries=True):
    """``[start, start + length)`` of ``path`` through the active backend
    (the ``range-read`` fault site)."""

    def _read():
        bk = _mock_backend() or _backend.get_backend()
        t0 = _lat_start()
        data = bk.get(path, start=start, length=length)
        _lat_end(t0, "range-read")
        return data

    if retries:
        return with_retries(_read, desc="range read {}".format(path))
    return _read()


def read_shard_bytes(path, retries=True):
    """(bytes, version) of a whole parquet shard, the version matching
    :func:`object_head`'s, so the shard cache never serves a stale
    generation. Torn bytes (an injected ``truncate``, or a chopped object:
    the parquet magic is checked at both ends) raise a ValueError naming
    the shard; they are never decoded or cached."""

    def _read():
        bk = _mock_backend()
        t0 = _lat_start()
        if bk is not None:
            data, version = bk.get_versioned(path)
            if data is None:
                # A never-committed plain file: the stat version head()
                # reports for it.
                st = os.stat(path)
                data = bk.get(path)
                version = ("stat", st.st_size, st.st_mtime_ns)
        else:
            faults.fault_point("open", path)
            st = os.stat(path)
            with open(path, "rb") as f:
                data = f.read()
            version = (st.st_size, st.st_mtime_ns)
            if faults.fault_point("read", path) == "truncate":
                data = data[:max(0, len(data) // 2 - 1)]
            _backend.count("local", "get", "ok")
        _lat_end(t0, "get")
        if len(data) < 12 or data[:4] != b"PAR1" or data[-4:] != b"PAR1":
            raise ValueError(
                "injected truncated parquet read: {}".format(path)
                if faults.armed() else
                "torn parquet shard read ({} byte(s)): {}".format(
                    len(data), path))
        return data, version

    if retries:
        return with_retries(_read, desc="read shard {}".format(path))
    return _read()


def read_json(path, retries=True):
    """``(value, "ok")``, ``(None, "missing")`` on ENOENT, or
    ``(raw_bytes, "torn")`` when the bytes do not parse."""
    try:
        data = read_bytes(path, retries=retries)
    except FileNotFoundError:
        return None, "missing"
    try:
        return json.loads(data), "ok"
    except ValueError:
        return data, "torn"


def open_append(path, retries=True):
    """Open a local file for append, retrying transient open errors. Only
    the open retries: a retried append could duplicate bytes. Appends stay
    POSIX on every backend (an object store has no append)."""

    def _open():
        faults.fault_point("open", path)
        return open(path, "ab")

    if retries:
        return with_retries(_open, desc="open append {}".format(path))
    return _open()


def read_table(path, retries=True):
    """One parquet shard as a pyarrow table, with transient-error
    retries and fault injection (a ``truncate`` fault raises the parse
    error a torn read gives)."""
    import pyarrow.parquet as pq

    def _read():
        faults.fault_point("open", path)
        if faults.fault_point("read", path) == "truncate":
            raise ValueError(
                "injected truncated parquet read: {}".format(path))
        return pq.read_table(path)

    if retries:
        return with_retries(_read, desc="read parquet {}".format(path))
    return _read()


def write_table_atomic(table, path, compression=None, retries=True,
                       **write_options):
    """Write a pyarrow table via tmp + fsync + replace, so a killed
    writer never leaves a torn shard under its final name;
    ``write_options`` pass through to ``pq.write_table``."""
    import pyarrow.parquet as pq
    tmp = "{}.tmp.{}".format(path, os.getpid())

    def _write():
        faults.fault_point("open", path)
        try:
            pq.write_table(table, tmp, compression=compression,
                           **write_options)
            atomic_publish(tmp, path)
        finally:
            _unlink_quietly(tmp)

    if retries:
        return with_retries(_write, desc="write parquet {}".format(path))
    return _write()


def list_dir(path):
    """Sorted listing through the active backend (publish scratch
    excluded), or None when the directory is absent."""
    bk = _mock_backend()
    t0 = _lat_start()
    if bk is not None:
        names = bk.list(path)
        _lat_end(t0, "list")
        return names
    try:
        names = sorted(os.listdir(path))
    except (FileNotFoundError, NotADirectoryError):
        return None
    _backend.count("local", "list", "ok")
    _lat_end(t0, "list")
    return [n for n in names if ".tmp." not in n]


def remove(path):
    """Delete one published file through the active backend (a missing
    one is fine). On the mock store the commit records go too: a raw
    ``os.remove`` would leave the object readable through the backend."""
    bk = _mock_backend()
    t0 = _lat_start()
    if bk is not None:
        bk.delete(path)
        _lat_end(t0, "delete")
        return
    try:
        os.remove(path)
    except FileNotFoundError:
        pass
    _backend.count("local", "delete", "ok")
    _lat_end(t0, "delete")


def put_exclusive(path, data):
    """Create-only publish: ``"ok"`` when this caller's bytes committed,
    ``"conflict"`` when the object already exists (the mock store's
    conditional create). On the local backend this is ``atomic_write``:
    a single in-sequence writer commits there by contract."""
    bk = _mock_backend()
    if bk is not None:
        if isinstance(data, str):
            data = data.encode("utf-8")
        t0 = _lat_start()
        try:
            with_retries(lambda: bk.put_if_match(path, data, None),
                         desc="put_exclusive {}".format(path))
        except _backend.CASConflict:
            _lat_end(t0, "cas-put")
            return "conflict"
        _lat_end(t0, "cas-put")
        return "ok"
    atomic_write(path, data)
    return "ok"
