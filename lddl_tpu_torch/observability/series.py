"""Time-series telemetry: bounded history over the metrics registry.

Counterpart of ``lddl_tpu/observability/series.py``. The registry and
the fleet spools hold lifetime counters and last-snapshot gauges; this
module adds the time axis: a bounded ring of points sampled off the
registry and persisted into the per-host spool, from which the
aggregator computes windowed rates, gauge trends and histogram
percentiles.

Each ``sample()`` diffs the current registry snapshot against the
previous one and emits one compact point::

    {"wall": w, "mono": m, "pid": p,
     "d": {"name" or "name{k=v,...}": counter_delta, ...},
     "g": {"key": gauge_value, ...},
     "h": {"key": {"n": dcount, "s": dsum, "b": {"le_x": dn}}, ...}}

Only nonzero counter and histogram deltas are written; gauges are
sampled absolutely. Points are appended to ``series-pid<p>*.jsonl``
segments in the spool on every fleet heartbeat and on the atexit,
SIGTERM and kill-fault flush paths; a SIGKILLed host leaves at most one
torn trailing line, which readers treat as the end of the stream.
Segments rotate at ``LDDL_TPU_FLEET_ROTATE_BYTES`` into
``series-pid<p>.seg<k>.jsonl``; readers glob the shared prefix.

Inert like the rest of the layer: disabled, every hook is one env
lookup; enabled, nothing here raises into the pipeline, touches an RNG
stream or writes outside the spool.
"""

import collections
import json
import logging
import os
import threading
import time

from .registry import registry

ENV_RING = "LDDL_TPU_SERIES_RING"

SEGMENT_PREFIX = "series-pid"

DEFAULT_RING = 720  # at the 10s heartbeat default: two hours of history

_log = logging.getLogger("lddl_tpu_torch.observability.series")

# RLock like tracing/fleet: the SIGTERM flush may interrupt a frame that
# holds it on the main thread and must re-enter, not deadlock.
_lock = threading.RLock()
_last_snapshot = [None]      # previous registry snapshot, for deltas
_ring = [None]               # deque of recent points (bounded)
_unflushed = []              # points not yet appended to the segment
_segment = {"path": None}    # current on-disk segment for this pid


def _ring_size():
    try:
        return max(int(os.environ.get(ENV_RING, DEFAULT_RING)), 16)
    except ValueError:
        return DEFAULT_RING


def _flat(name, label_str):
    """One series key per (metric, label set): ``name`` for the unlabelled
    series, ``name{k=v,...}`` otherwise (the Prometheus spelling, so the
    README's stable metric names read verbatim off a segment)."""
    if not label_str:
        return name
    return "{}{{{}}}".format(name, label_str)


def split_key(key):
    """Inverse of ``_flat``: ``(metric_name, label_str)``."""
    if key.endswith("}") and "{" in key:
        name, _, rest = key.partition("{")
        return name, rest[:-1]
    return key, ""


def _diff_point(prev, snap, wall, mono):
    """The compact delta point between two registry snapshots. Counter
    and histogram deltas clamp negative (a registry reset mid-run reads
    as a fresh start, not a negative rate)."""
    point = {"wall": wall, "mono": mono, "pid": os.getpid()}
    d, g, h = {}, {}, {}
    prev = prev or {}
    for name, data in snap.items():
        kind = data.get("type")
        pvals = (prev.get(name) or {}).get("values", {})
        if kind == "counter":
            for label_str, v in data.get("values", {}).items():
                delta = v - pvals.get(label_str, 0)
                if delta > 0:
                    d[_flat(name, label_str)] = delta
        elif kind == "gauge":
            for label_str, v in data.get("values", {}).items():
                if isinstance(v, (int, float)) and v == v:  # drop NaN
                    g[_flat(name, label_str)] = v
        elif kind == "histogram":
            for label_str, st in data.get("values", {}).items():
                pst = pvals.get(label_str) or {}
                dn = st.get("count", 0) - pst.get("count", 0)
                if dn <= 0:
                    continue
                db = {}
                pbuckets = pst.get("buckets", {})
                for b, n in st.get("buckets", {}).items():
                    bn = n - pbuckets.get(b, 0)
                    if bn > 0:
                        db[b] = bn
                h[_flat(name, label_str)] = {
                    "n": dn, "s": st.get("sum", 0.0) - pst.get("sum", 0.0),
                    "b": db,
                }
    if d:
        point["d"] = d
    if g:
        point["g"] = g
    if h:
        point["h"] = h
    return point


def sample():
    """Take one point: diff the registry against the previous sample and
    push the delta onto the ring + flush queue. Returns the point, or
    None when it could not be taken. Never raises."""
    try:
        snap = registry().snapshot()
        wall, mono = time.time(), time.monotonic()
        with _lock:
            point = _diff_point(_last_snapshot[0], snap, wall, mono)
            _last_snapshot[0] = snap
            if _ring[0] is None or _ring[0].maxlen != _ring_size():
                _ring[0] = collections.deque(_ring[0] or (),
                                             maxlen=_ring_size())
            _ring[0].append(point)
            if len(_unflushed) < _ring_size():
                _unflushed.append(point)
        return point
    except Exception:  # noqa: BLE001 - telemetry must stay inert
        return None


def recent(window_s=None):
    """Points currently in the in-memory ring, oldest first; with
    ``window_s``, only those inside the trailing window."""
    with _lock:
        points = list(_ring[0] or ())
    if window_s is None or not points:
        return points
    cutoff = points[-1].get("wall", 0.0) - float(window_s)
    return [p for p in points if p.get("wall", 0.0) >= cutoff]


def _segment_paths(d, pid=None):
    """All series segments in one spool dir (rotated + live), sorted so
    rotation order is read order."""
    try:
        names = sorted(os.listdir(d))
    except OSError:
        return []
    tag = SEGMENT_PREFIX if pid is None \
        else "{}{}".format(SEGMENT_PREFIX, pid)
    out = []
    for name in names:
        if not (name.startswith(SEGMENT_PREFIX) and
                name.endswith(".jsonl")):
            continue
        if pid is not None and not (
                name == tag + ".jsonl" or name.startswith(tag + ".seg")):
            continue
        out.append(os.path.join(d, name))
    return out


def flush():
    """Append unflushed points to this pid's current segment (rotating at
    the size bound). Called from ``fleet.heartbeat`` — i.e. the periodic
    beat, atexit, SIGTERM, and the injector's pre-kill flush. A no-op
    when fleet telemetry is off."""
    from . import fleet
    d = fleet.spool_dir()
    if d is None:
        return None
    with _lock:
        if not _unflushed:
            return _segment["path"]
        batch, _unflushed[:] = list(_unflushed), []
    try:
        from ..resilience import io as rio
        os.makedirs(d, exist_ok=True)
        # rotating_path mutates the shared segment dict, and both the
        # heartbeat sampler and the SIGTERM/atexit flush reach here.
        with _lock:
            path = fleet.rotating_path(d, SEGMENT_PREFIX, _segment)
        payload = "".join(json.dumps(p, sort_keys=True) + "\n"
                          for p in batch)
        with rio.open_append(path) as f:
            f.write(payload.encode("utf-8"))
        return path
    except Exception:  # noqa: BLE001 - drop the batch, never the pipeline
        return None


def sample_and_flush():
    """One heartbeat's worth of history: sample, then persist."""
    sample()
    return flush()


def read_series(root, holder_name, warn=None):
    """Every point one holder's spool recorded, wall-ordered, merged
    across pids and rotated segments. Torn-tolerant via
    ``fleet.read_jsonl``. Returns ``(points, torn_line_count)``."""
    from . import fleet
    d = fleet.spool_dir(root, holder_name)
    points, torn = [], 0
    for path in _segment_paths(d) if d else []:
        recs, t = fleet.read_jsonl(path, warn)
        points.extend(recs)
        torn += t
    points.sort(key=lambda p: p.get("wall", 0.0))
    return points, torn


def percentile_from_buckets(buckets, q):
    """Percentile estimate off log-bucket counts ({"le_2.0": n, ...}):
    the upper bound of the bucket where the cumulative count crosses
    ``q``. Within a factor of 2 of the true value — the resolution the
    frexp buckets buy, plenty for trend/alerting use."""
    def le_of(bucket):
        raw = bucket[3:] if bucket.startswith("le_") else bucket
        try:
            return float(raw)
        except ValueError:
            return float("inf")
    total = sum(buckets.values())
    if total <= 0:
        return None
    target = q * total
    cum = 0
    for le, n in sorted((le_of(b), n) for b, n in buckets.items()):
        cum += n
        if cum >= target:
            return le
    return None


def window_rollup(points, window_s, now=None):
    """Windowed statistics over a point stream: per-key counter rates
    (and the per-point delta series, for sparklines), gauge trends
    (first/last/min/max inside the window), and histogram percentiles
    from the summed bucket deltas. Pure function of the points."""
    if now is None:
        now = max((p.get("wall", 0.0) for p in points), default=0.0)
    window_s = float(window_s)
    cutoff = now - window_s
    inside = [p for p in points if p.get("wall", 0.0) >= cutoff]
    if not inside:
        return {"window_s": window_s, "points": 0, "span_s": 0.0,
                "rates": {}, "deltas": {}, "gauges": {}, "histograms": {}}
    walls = [p.get("wall", 0.0) for p in inside]
    # Rate denominator: the observed span, floored at one heartbeat-ish
    # second so a single point doesn't divide by ~zero; capped at the
    # requested window so long-idle spools don't dilute.
    span = min(max(max(walls) - min(walls), 1.0), window_s)
    rates, deltas = {}, {}
    for p in inside:
        for key, dv in (p.get("d") or {}).items():
            deltas.setdefault(key, []).append((p.get("wall", 0.0), dv))
    for key, seq in deltas.items():
        rates[key] = sum(dv for _, dv in seq) / span
    gauges = {}
    for p in inside:
        for key, v in (p.get("g") or {}).items():
            st = gauges.get(key)
            if st is None:
                gauges[key] = {"first": v, "last": v, "min": v, "max": v}
            else:
                st["last"] = v
                st["min"] = min(st["min"], v)
                st["max"] = max(st["max"], v)
    for st in gauges.values():
        st["trend"] = st["last"] - st["first"]
    hists = {}
    for p in inside:
        for key, hd in (p.get("h") or {}).items():
            st = hists.setdefault(key, {"n": 0, "s": 0.0, "b": {}})
            st["n"] += hd.get("n", 0)
            st["s"] += hd.get("s", 0.0)
            for b, n in (hd.get("b") or {}).items():
                st["b"][b] = st["b"].get(b, 0) + n
    histograms = {}
    for key, st in hists.items():
        histograms[key] = {
            "count": st["n"],
            "mean": (st["s"] / st["n"]) if st["n"] else None,
            "p50": percentile_from_buckets(st["b"], 0.50),
            "p90": percentile_from_buckets(st["b"], 0.90),
            "p99": percentile_from_buckets(st["b"], 0.99),
        }
    return {"window_s": window_s, "points": len(inside), "span_s": span,
            "rates": rates, "deltas": deltas, "gauges": gauges,
            "histograms": histograms}


def _reset_for_tests():
    with _lock:
        _last_snapshot[0] = None
        _ring[0] = None
        _unflushed[:] = []
        _segment["path"] = None
