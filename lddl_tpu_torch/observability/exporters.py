"""Metric exporters: JSONL snapshots, Prometheus textfile, end-of-run
summary, the SIGTERM flush and the periodic exporter.

Counterpart of ``lddl_tpu/observability/exporters.py``. Every export
lands in the metrics directory (``LDDL_TPU_METRICS_DIR``), one file per
(rank, pid), so concurrent worker processes never contend:

    metrics-rank<r>-pid<p>.jsonl   one registry snapshot per line
    metrics-rank<r>-pid<p>.prom    Prometheus textfile-collector format,
                                   rewritten in place on every export
    summary-rank<r>-pid<p>.json    final snapshot + headline numbers
                                   (padding efficiency, resilience
                                   activity, loader attribution)

Export writes are plain file I/O on purpose: riding ``resilience.io``
would let its fault sites raise inside telemetry, and a torn metrics
file is an acceptable loss where a torn shard is not. Every write is
wrapped so a failure drops the export, never the run.
"""

import json
import os
import threading
import time

from . import tracing
from .registry import ENV_DIR, ENV_RANK, metrics_dir, rank, registry

_EXPORT_INTERVAL_ENV = "LDDL_TPU_METRICS_INTERVAL_S"
# How long stopping the exporter waits for an export in progress (file
# writes: milliseconds; the bound keeps a hung filesystem from hanging it).
_STOP_JOIN_S = 30.0

_thread_lock = threading.Lock()
_exporter = {"thread": None, "stop": None}


def _file_tag():
    return "rank{}-pid{}".format(rank(), os.getpid())


def configure(dir=None, rank=None, periodic=False):  # noqa: A002
    """Arm telemetry in this process AND future child processes (the env
    var is the source of truth, like resilience.faults). ``periodic=True``
    also starts the background snapshot thread (interval from
    ``LDDL_TPU_METRICS_INTERVAL_S``, default 30s)."""
    if dir is not None:
        os.makedirs(dir, exist_ok=True)
        os.environ[ENV_DIR] = dir
    if rank is not None:
        os.environ[ENV_RANK] = str(int(rank))
    if periodic:
        start_periodic_export()
    return metrics_dir()


def disable():
    """Disarm telemetry (this process and future children). Recorded
    metrics stay in the registry; call ``registry().reset()`` to drop."""
    stop_periodic_export()
    os.environ.pop(ENV_DIR, None)
    os.environ.pop(ENV_RANK, None)


def snapshot_line():
    """One JSON-serializable snapshot object with a wall-clock stamp."""
    return {"time": time.time(), "rank": rank(), "pid": os.getpid(),
            "metrics": registry().snapshot()}


def export_jsonl():
    """Append one registry snapshot line to the per-process JSONL file."""
    d = metrics_dir()
    if d is None:
        return None
    path = os.path.join(d, "metrics-{}.jsonl".format(_file_tag()))
    try:
        os.makedirs(d, exist_ok=True)
        with open(path, "a", encoding="utf-8") as f:
            f.write(json.dumps(snapshot_line()) + "\n")
    except Exception:  # noqa: BLE001 - telemetry must stay inert
        return None
    return path


def _prom_name(name):
    return "".join(c if c.isalnum() or c == "_" else "_" for c in name)


def _prom_labels(label_str, extra=None):
    pairs = []
    if label_str:
        for part in label_str.split(","):
            k, _, v = part.partition("=")
            pairs.append((k, v))
    if extra:
        pairs.extend(extra)
    if not pairs:
        return ""
    return "{" + ",".join(
        '{}="{}"'.format(k, str(v).replace('"', r'\"')) for k, v in pairs
    ) + "}"


def export_prom():
    """Rewrite the Prometheus textfile for this process (node-exporter
    textfile-collector format). Histograms export ``_count``/``_sum`` plus
    cumulative ``_bucket{le=...}`` series from the log buckets."""
    d = metrics_dir()
    if d is None:
        return None
    path = os.path.join(d, "metrics-{}.prom".format(_file_tag()))
    lines = []
    snap = registry().snapshot()
    for name, data in snap.items():
        pname = _prom_name(name)
        kind = data["type"]
        lines.append("# TYPE {} {}".format(
            pname, "histogram" if kind == "histogram" else kind))
        if kind in ("counter", "gauge"):
            for label_str, v in sorted(data["values"].items()):
                lines.append("{}{} {}".format(
                    pname, _prom_labels(label_str), _num(v)))
        else:
            for label_str, st in sorted(data["values"].items()):
                cum = 0

                def le_of(bucket):
                    le = bucket[3:] if bucket.startswith("le_") else bucket
                    try:
                        return float(le), le
                    except ValueError:
                        return float("inf"), le

                for _, le, n in sorted(
                        (le_of(b) + (n,)) for b, n in st["buckets"].items()):
                    cum += n
                    lines.append("{}_bucket{} {}".format(
                        pname, _prom_labels(label_str, [("le", le)]), cum))
                lines.append("{}_bucket{} {}".format(
                    pname, _prom_labels(label_str, [("le", "+Inf")]), cum))
                lines.append("{}_sum{} {}".format(
                    pname, _prom_labels(label_str), _num(st["sum"])))
                lines.append("{}_count{} {}".format(
                    pname, _prom_labels(label_str), st["count"]))
    try:
        os.makedirs(d, exist_ok=True)
        # Plain truncate-write: a torn .prom file is re-written next tick
        # (and os.replace is reserved for resilience.io by lint).
        with open(path, "w", encoding="utf-8") as f:
            f.write("\n".join(lines) + "\n")
    except Exception:  # noqa: BLE001 - telemetry must stay inert
        return None
    return path


def _num(v):
    if isinstance(v, float) and v.is_integer():
        return int(v)
    return v


def summary():
    """End-of-run summary dict: the full snapshot plus derived headline
    numbers every stage report cares about."""
    snap = registry().snapshot()

    def counter_total(name):
        data = snap.get(name)
        if not data or data["type"] != "counter":
            return 0
        return sum(data["values"].values())

    real = counter_total("loader_real_tokens_total")
    padded = counter_total("loader_padded_slots_total")
    out = {
        "padding_efficiency": (real / padded) if padded else None,
        "real_tokens": real,
        "padded_slots": padded,
        "retries": counter_total("resilience_retry_attempts_total"),
        "faults_injected": counter_total("resilience_faults_injected_total"),
        "worker_restarts": counter_total("loader_worker_restarts_total"),
        "quarantined_shards": counter_total(
            "resilience_quarantined_shards_total"),
        "metrics": snap,
    }
    # Critical-path attribution rides the summary so downstream readers
    # (step_profile --attribution, the fleet rollup) never re-derive it.
    try:
        from . import attribution
        out["loader_attribution"] = attribution.from_stage_seconds(
            attribution.stage_seconds())
    except Exception:  # noqa: BLE001 - telemetry must stay inert
        out["loader_attribution"] = None
    return out


def write_summary():
    """Write ``summary()`` (plus flush traces) to the metrics dir."""
    d = metrics_dir()
    if d is None:
        return None
    tracing.flush()
    path = os.path.join(d, "summary-{}.json".format(_file_tag()))
    try:
        os.makedirs(d, exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            json.dump(summary(), f, indent=2, sort_keys=True, default=str)
    except Exception:  # noqa: BLE001 - telemetry must stay inert
        return None
    return path


def _export_once():
    export_jsonl()
    export_prom()
    tracing.flush()


_signal_installed = []


def install_signal_flush():
    """Flush telemetry from a SIGTERM handler (idempotent; main thread
    only — installing elsewhere raises ValueError and is skipped).

    atexit covers normal interpreter exit, but a polite kill (k8s pod
    eviction, timeout(1), a supervisor's TERM before KILL) used to drop
    every buffered trace event, unexported counter, and fleet lifecycle
    event recorded since the last flush — precisely the telemetry an
    operator needs to diagnose WHY the process was killed. The handler
    chains any previously-installed Python handler; when the prior
    disposition was the default (terminate), it re-raises SIGTERM after
    flushing so the process still dies with the conventional -TERM
    status; a prior SIG_IGN (or an unknown C-level handler, getsignal()
    -> None) is preserved — flush only, never turn an ignored signal
    into a death. The telemetry locks on the flush path are reentrant
    (see tracing._lock), so a TERM landing while the interrupted frame
    holds one cannot deadlock the dying process."""
    if _signal_installed:
        return
    import signal

    try:
        prev = signal.getsignal(signal.SIGTERM)

        def _handler(signum, frame):
            try:
                final_flush(reason="sigterm")
            except Exception:  # noqa: BLE001 - dying anyway
                pass
            if callable(prev):
                prev(signum, frame)
            elif prev == signal.SIG_DFL:
                signal.signal(signal.SIGTERM, signal.SIG_DFL)
                os.kill(os.getpid(), signal.SIGTERM)
            # SIG_IGN / None (C-level handler we cannot re-invoke):
            # keep the process alive, exactly as before installation.

        signal.signal(signal.SIGTERM, _handler)
        _signal_installed.append(True)
    except ValueError:
        # Not the main thread: the atexit path still covers clean exits.
        return


def final_flush(reason=None):
    """One last telemetry publish: registry snapshot exports, trace
    buffer flush, and the fleet spool (snapshot marked closed). Shared by
    the atexit and SIGTERM paths; safe to call repeatedly."""
    if metrics_dir() is not None:
        export_jsonl()
        export_prom()
        tracing.flush()
    from . import fleet
    if fleet.enabled():
        fleet.heartbeat(closed=True, reason=reason or "atexit")


def start_periodic_export(interval_s=None):
    """Start the daemon exporter thread (idempotent). Interval defaults to
    ``LDDL_TPU_METRICS_INTERVAL_S`` (30s)."""
    if metrics_dir() is None:
        return None
    if interval_s is None:
        try:
            interval_s = float(os.environ.get(_EXPORT_INTERVAL_ENV, "30"))
        except ValueError:
            interval_s = 30.0
    with _thread_lock:
        if _exporter["thread"] is not None and _exporter["thread"].is_alive():
            return _exporter["thread"]
        stop = threading.Event()

        def loop():
            while not stop.wait(interval_s):
                if metrics_dir() is None:
                    return
                try:
                    _export_once()
                except Exception:  # noqa: BLE001 - keep exporting
                    pass

        t = threading.Thread(target=loop, name="lddl-metrics-exporter",
                             daemon=True)
        t.start()
        _exporter["thread"] = t
        _exporter["stop"] = stop
        return t


def stop_periodic_export():
    """Stop the exporter thread and wait out an export it has begun, so
    that the files of that export are whole when this returns: ``disable``
    disarms the directory next, and an export still running would then
    drop its remaining writes (the .prom file, the trace flush)."""
    with _thread_lock:
        thread, stop = _exporter["thread"], _exporter["stop"]
        if stop is not None:
            stop.set()
        _exporter["thread"] = None
        _exporter["stop"] = None
    if thread is not None and thread is not threading.current_thread():
        thread.join(timeout=_STOP_JOIN_S)
