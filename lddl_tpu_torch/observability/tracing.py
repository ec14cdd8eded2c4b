"""Span tracing: Chrome-trace-format JSONL per process.

Counterpart of ``lddl_tpu/observability/tracing.py``. ``span(name, **args)``
records one complete ("ph": "X") event with microsecond start and
duration; ``event(name, **args)`` an instant ("ph": "i") one (a worker
restart, an injected fault). Events buffer in memory and append to
``<metrics_dir>/trace-rank<r>-pid<p>.jsonl`` on ``flush()`` and at
interpreter exit; Perfetto opens the file. Disabled spans are one shared
no-op context manager; enabled ones never raise into the caller.
"""

import json
import os
import threading
import time

from .registry import metrics_dir, rank

_lock = threading.RLock()
_buffer = []
_emitted_meta = set()
_MAX_BUFFER = 50000    # a runaway loop must not eat the heap
_atexit_registered = []


def _now_us():
    # Wall clock, so events of several processes share one timeline;
    # durations use the monotonic perf counter.
    return time.time() * 1e6


class Span:
    """One timed section (use through ``span``)."""

    __slots__ = ("name", "args", "_t0", "_p0")

    def __init__(self, name, args):
        self.name = name
        self.args = args
        self._t0 = 0.0
        self._p0 = 0.0

    def __enter__(self):
        self._t0 = _now_us()
        self._p0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        record = {"name": self.name, "ph": "X", "ts": self._t0,
                  "dur": (time.perf_counter() - self._p0) * 1e6,
                  "pid": os.getpid(),
                  "tid": threading.get_ident() & 0x7FFFFFFF}
        if self.args:
            record["args"] = self.args
        if exc_type is not None:
            record.setdefault("args", {})["error"] = exc_type.__name__
        _push(record)
        return False


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NULL_SPAN = _NullSpan()


def span(name, **args):
    """Context manager timing one section; a shared no-op when disabled."""
    if metrics_dir() is None:
        return _NULL_SPAN
    return Span(name, args)


def event(name, **args):
    """Record an instant event."""
    if metrics_dir() is None:
        return
    record = {"name": name, "ph": "i", "ts": _now_us(), "pid": os.getpid(),
              "tid": threading.get_ident() & 0x7FFFFFFF, "s": "t"}
    if args:
        record["args"] = args
    _push(record)


def _push(record):
    with _lock:
        if len(_buffer) >= _MAX_BUFFER:
            return
        pid = record["pid"]
        if pid not in _emitted_meta:
            _emitted_meta.add(pid)
            _buffer.append({"name": "process_name", "ph": "M", "pid": pid,
                            "args": {"name": "rank{} pid{}".format(
                                rank(), pid)}})
        _buffer.append(record)
        if not _atexit_registered:
            _atexit_registered.append(True)
            import atexit
            atexit.register(flush)


def trace_path():
    """This process's trace file, or None when disabled."""
    d = metrics_dir()
    if d is None:
        return None
    return os.path.join(d, "trace-rank{}-pid{}.jsonl".format(
        rank(), os.getpid()))


def flush():
    """Append buffered events to the per-process trace file; a failed
    write drops the batch rather than disturb the pipeline."""
    path = trace_path()
    with _lock:
        if not _buffer:
            return path
        batch, _buffer[:] = list(_buffer), []
    if path is None:
        return None
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "a", encoding="utf-8") as f:
            for record in batch:
                f.write(json.dumps(record) + "\n")
    except Exception:  # noqa: BLE001 - telemetry must stay inert
        pass
    return path


def pending_events():
    """Number of buffered (unflushed) events, for tests and debugging."""
    with _lock:
        return len(_buffer)


def _reset_for_tests():
    with _lock:
        _buffer[:] = []
        _emitted_meta.clear()
