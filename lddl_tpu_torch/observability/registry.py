"""Process-wide metrics registry: labelled counters, gauges, histograms.

Counterpart of ``lddl_tpu/observability/registry.py``. Constraints, in
order:

1. Inert: instrumentation never changes pipeline behaviour. No metric op
   raises into the caller, nothing here touches an RNG stream, and
   exports go to the metrics directory, never into a shard directory.
2. Near-zero when disabled: each module-level helper is one env-dict
   lookup and an early return; ``enabled()`` lets per-sample loops hoist
   even that.
3. Thread-safe: loader worker threads update metrics concurrently; every
   mutation holds the registry lock.

Enablement is the ``LDDL_TPU_METRICS_DIR`` environment variable, so
spawned pool and loader workers inherit it. Each process exports its
registry there when it exits or is terminated (``exporters``), which is
how a spawned worker's counters become visible. Metric names are
``<stage>_<what>_<unit>``, as the reference's.
"""

import math
import os
import threading

ENV_DIR = "LDDL_TPU_METRICS_DIR"
ENV_RANK = "LDDL_TPU_METRICS_RANK"

_lock = threading.RLock()
# Cached enablement: (raw env value, metrics_dir or None), re-checked on
# every call so an env flip takes effect at once.
_cached = {"raw": object(), "dir": None}


def metrics_dir():
    """The active metrics directory, or None when telemetry is off."""
    raw = os.environ.get(ENV_DIR)
    if raw != _cached["raw"]:
        with _lock:
            _cached["raw"] = raw
            _cached["dir"] = raw or None
    return _cached["dir"]


def enabled():
    """True when telemetry is armed (``LDDL_TPU_METRICS_DIR`` set)."""
    return metrics_dir() is not None


def rank():
    """The rank tag of export file names (0 unless configured)."""
    try:
        return int(os.environ.get(ENV_RANK, "0"))
    except ValueError:
        return 0


def _labels_key(labels):
    if not labels:
        return ()
    return tuple(sorted(labels.items()))


def _fmt_labels(key):
    return ",".join("{}={}".format(k, v) for k, v in key)


class _Metric:
    """Shared storage: {labels_key: value} under the registry lock."""

    kind = "untyped"

    def __init__(self, name, help=""):
        self.name = name
        self.help = help
        self._values = {}

    def _items(self):
        with _lock:
            return list(self._values.items())


class Counter(_Metric):
    """Monotonic counter; negative deltas clamp to zero."""

    kind = "counter"

    def inc(self, value=1, **labels):
        if value < 0:
            value = 0
        key = _labels_key(labels)
        with _lock:
            self._values[key] = self._values.get(key, 0) + value

    def value(self, **labels):
        with _lock:
            return self._values.get(_labels_key(labels), 0)

    def total(self):
        with _lock:
            return sum(self._values.values())

    def snapshot(self):
        return {"type": "counter",
                "values": {_fmt_labels(k): v for k, v in self._items()}}


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value, **labels):
        with _lock:
            self._values[_labels_key(labels)] = value

    def value(self, **labels):
        with _lock:
            return self._values.get(_labels_key(labels))

    def snapshot(self):
        return {"type": "gauge",
                "values": {_fmt_labels(k): v for k, v in self._items()}}


class Histogram(_Metric):
    """Log-bucketed histogram: observations land in power-of-two buckets
    keyed by their binary exponent, with sum/count/min/max per label
    set."""

    kind = "histogram"

    def observe(self, value, **labels):
        key = _labels_key(labels)
        v = float(value)
        b = math.frexp(v)[1] if v > 0 and not math.isinf(v) else None
        with _lock:
            st = self._values.get(key)
            if st is None:
                st = {"count": 0, "sum": 0.0, "min": v, "max": v,
                      "buckets": {}}
                self._values[key] = st
            st["count"] += 1
            st["sum"] += v
            st["min"] = min(st["min"], v)
            st["max"] = max(st["max"], v)
            st["buckets"][b] = st["buckets"].get(b, 0) + 1

    def stats(self, **labels):
        with _lock:
            st = self._values.get(_labels_key(labels))
            if st is None:
                return None
            out = dict(st)
            out["buckets"] = dict(st["buckets"])
            return out

    def snapshot(self):
        out = {}
        with _lock:
            for key, st in self._values.items():
                out[_fmt_labels(key)] = {
                    "count": st["count"], "sum": st["sum"],
                    "min": st["min"], "max": st["max"],
                    "mean": st["sum"] / st["count"] if st["count"] else 0.0,
                    "buckets": {("le_" + repr(2.0 ** b) if b is not None
                                 else "le_0"): n
                                for b, n in st["buckets"].items()},
                }
        return {"type": "histogram", "values": out}


class Registry:
    """Name -> metric. ``counter``/``gauge``/``histogram`` create on first
    use; asking for an existing name with another type raises (a bug at
    the instrumentation site, the one failure this layer must not
    swallow)."""

    def __init__(self):
        self._metrics = {}

    def _get(self, cls, name, help):
        with _lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help=help)
                self._metrics[name] = m
                if metrics_dir() is not None:
                    _ensure_final_export()
            elif not isinstance(m, cls):
                raise TypeError(
                    "metric {!r} already registered as {} (wanted {})"
                    .format(name, type(m).__name__, cls.__name__))
            return m

    def counter(self, name, help=""):
        return self._get(Counter, name, help)

    def gauge(self, name, help=""):
        return self._get(Gauge, name, help)

    def histogram(self, name, help=""):
        return self._get(Histogram, name, help)

    def names(self):
        with _lock:
            return sorted(self._metrics)

    def get(self, name):
        with _lock:
            return self._metrics.get(name)

    def snapshot(self):
        with _lock:
            items = list(self._metrics.items())
        return {name: m.snapshot() for name, m in sorted(items)}

    def reset(self):
        """Drop every metric (tests and fresh runs)."""
        with _lock:
            self._metrics.clear()


_REGISTRY = Registry()


def registry():
    return _REGISTRY


_final_export_registered = []


def _ensure_final_export():
    """Register the end-of-process export once: metrics of short-lived
    processes (spawned preprocess pool and loader workers, an env-armed
    CLI run) would otherwise die with them. The atexit hook and the
    SIGTERM handler (``exporters.install_signal_flush``, the process's
    one handler chain) both run ``exporters.final_flush``."""
    if _final_export_registered:
        return
    _final_export_registered.append(True)
    import atexit

    def _final_export():
        try:
            if metrics_dir() is None:
                return
            from . import exporters
            exporters.final_flush()
        except Exception:  # noqa: BLE001 - telemetry must stay inert
            pass

    atexit.register(_final_export)
    try:
        from . import exporters
        exporters.install_signal_flush()
    except Exception:  # noqa: BLE001 - telemetry must stay inert
        pass


# Module-level instrumentation points: a no-op after one cheap check when
# telemetry is off.

def inc(name, value=1, **labels):
    if metrics_dir() is None:
        return
    _REGISTRY.counter(name).inc(value, **labels)


def set_gauge(name, value, **labels):
    if metrics_dir() is None:
        return
    _REGISTRY.gauge(name).set(value, **labels)


def observe(name, value, **labels):
    if metrics_dir() is None:
        return
    _REGISTRY.histogram(name).observe(value, **labels)
