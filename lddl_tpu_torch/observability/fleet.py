"""Fleet telemetry: cross-host spools and their aggregation over the
shared filesystem.

Counterpart of ``lddl_tpu/observability/fleet.py``. The elastic
work-stealing preprocess and the streaming-ingest service run as
independent host processes that share nothing but the output directory,
so fleet telemetry makes the same assumption the lease protocol does:
no RPC, no daemons, just files.

Publisher side (each host, armed through ``LDDL_TPU_FLEET_DIR``):

    <fleet_dir>/.telemetry/<holder>/
        snapshot-pid<p>.json    latest registry snapshot + clock pair +
                                liveness flag, republished atomically
                                every heartbeat (resilience.io path)
        events-pid<p>.jsonl     append-only lifecycle event log: units
                                (claimed -> renewed -> stolen/fenced ->
                                journaled) and generations (intake ->
                                preprocess -> delta-balance ->
                                gate-advance -> committed); every record
                                carries a (wall, mono) clock pair
        series-pid<p>.jsonl     the time series of ``series.py``
        metrics-*.jsonl / trace-*.jsonl / ...
                                the per-process exports, colocated when
                                ``configure()`` points the metrics dir
                                at the spool

Events buffer in memory and flush on the heartbeat and from the atexit
and SIGTERM handlers (``exporters.install_signal_flush``), so a dying
host leaves a parseable tail; a SIGKILLed host may leave one torn final
line, which every reader here treats as the end of the stream. The
injector's ``kill`` fault flushes the spool before the kill.

Aggregator side (``aggregate()`` and ``merge_traces()``, read by
``lddl_tpu_torch.tools.pipeline_status`` and ``trace_summary --merge``):
merges every host spool into cluster rollups (units/s and MB/s per host
and in total, steal/fence/retry/quarantine counts, heartbeat ages,
ingest backlog and generation lag, padding efficiency) with health
verdicts. A host is **stalled** when its heartbeat age exceeds the stall
TTL without a clean-shutdown marker; the service is **wedged** when
live hosts exist but the journal and ledger show no progress inside the
wedge window. ``merge_traces`` re-bases every host's Chrome-trace events
through its published (wall, mono) samples, correcting a wall-clock step
back onto the host's monotonic timeline, and gives each (host, pid) a
Perfetto lane.

Inert like the rest of the layer: disabled, every hook is one env-dict
lookup; enabled, nothing here raises into the pipeline, touches an RNG
stream or writes outside ``.telemetry/``. Wall-clock reads stay inside
``observability/``, so the status tools stay clock-free.
"""

import json
import logging
import os
import re
import socket
import threading
import time

from . import tracing
from .registry import ENV_DIR as ENV_METRICS_DIR
from .registry import metrics_dir, rank, registry

ENV_FLEET_DIR = "LDDL_TPU_FLEET_DIR"
ENV_HOLDER = "LDDL_TPU_FLEET_HOLDER"
ENV_INTERVAL = "LDDL_TPU_FLEET_INTERVAL_S"
ENV_TTL = "LDDL_TPU_FLEET_TTL_S"
ENV_ROTATE_BYTES = "LDDL_TPU_FLEET_ROTATE_BYTES"
ENV_RETAIN_BYTES = "LDDL_TPU_FLEET_RETAIN_BYTES"
ENV_RETAIN_AGE_S = "LDDL_TPU_FLEET_RETAIN_AGE_S"

TELEMETRY_DIR = ".telemetry"
DEFAULT_INTERVAL_S = 10.0
DEFAULT_TTL_S = 30.0
# Spool retention: append segments (events/series) freeze at the rotate
# bound and start a .segNNNN successor; gc_spool drops frozen segments
# and closed foreign snapshots past the total-size/age budget — the same
# bounded-accumulation discipline the mock store's generation GC has.
DEFAULT_ROTATE_BYTES = 4 << 20
DEFAULT_RETAIN_BYTES = 64 << 20
DEFAULT_RETAIN_AGE_S = 7 * 24 * 3600.0

# A (wall - mono) offset drifting more than this from its first sample is
# a wall-clock STEP (NTP slew stays far under it); merge_traces re-anchors
# later events onto the host's monotonic timeline.
CLOCK_STEP_S = 0.5

# Event kinds that constitute pipeline PROGRESS for the wedge verdict
# (scheduling chatter like renewals deliberately does not count).
PROGRESS_EVENTS = frozenset({
    "unit.journaled", "generation.committed", "generation.gate_advance",
    "generation.pickup",
})

_MAX_BUFFER = 50000  # hard cap, like tracing: runaway loops must not OOM

_log = logging.getLogger("lddl_tpu_torch.observability.fleet")

_SAFE_RE = re.compile(r"[^A-Za-z0-9_.-]+")

# RLock for the same reason as tracing._lock: the SIGTERM flush handler
# may interrupt a frame holding this lock on the main thread, and must
# re-enter rather than deadlock the dying process.
_lock = threading.RLock()
_events = []
_started = []          # [True] once the heartbeat/exit hooks are live
_hb = {"thread": None, "stop": None, "beats": 0}
_cached = {"raw": object(), "dir": None}
_ev_segment = {"path": None}   # this pid's current events append segment
_started_wall = time.time()
_env_set = set()   # variables configure()/adopt_holder() set, for resets


def _set_env(name, value):
    with _lock:
        os.environ[name] = value
        _env_set.add(name)


# ------------------------------------------------------------- enablement


def fleet_dir():
    """The fleet root (spools live under ``<dir>/.telemetry/``), or None
    when fleet telemetry is disabled. One env lookup on the cached path."""
    raw = os.environ.get(ENV_FLEET_DIR)
    if raw != _cached["raw"]:
        with _lock:
            _cached["raw"] = raw
            _cached["dir"] = raw or None
    return _cached["dir"]


def enabled():
    return fleet_dir() is not None


def sanitize_holder(holder):
    safe = _SAFE_RE.sub("-", str(holder)).strip("-")
    return safe or "host"


def holder():
    """This process's spool name: the env-pinned holder (inherited by
    worker processes) or a per-process hostname-pid default."""
    h = os.environ.get(ENV_HOLDER)
    if h:
        return sanitize_holder(h)
    return sanitize_holder("{}-pid{}".format(socket.gethostname(),
                                             os.getpid()))


def spool_dir(root=None, for_holder=None):
    root = root if root is not None else fleet_dir()
    if root is None:
        return None
    return os.path.join(root, TELEMETRY_DIR, for_holder or holder())


def _env_float(name, default):
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def configure(dir, holder_id=None, ttl=None, interval=None,  # noqa: A002
              arm_metrics=True):
    """Arm fleet telemetry in this process AND future children (env vars
    are the source of truth, like registry.configure). Pins the holder
    into the env so spawned pool/loader workers publish into the SAME
    spool (per-pid files never contend). ``arm_metrics=True`` (default)
    also points ``LDDL_TPU_METRICS_DIR`` at the spool when metrics are
    not armed elsewhere, colocating the per-process exports with the
    fleet spool — which is what lets the aggregator compute counter
    rollups and merge traces for hosts that died mid-run."""
    _set_env(ENV_FLEET_DIR, dir)
    _set_env(ENV_HOLDER, sanitize_holder(holder_id) if holder_id
             else holder())
    if ttl is not None:
        _set_env(ENV_TTL, str(float(ttl)))
    if interval is not None:
        _set_env(ENV_INTERVAL, str(float(interval)))
    spool = spool_dir()
    if arm_metrics and metrics_dir() is None:
        _set_env(ENV_METRICS_DIR, spool)
    ensure_started()
    return spool


def adopt_holder(holder_id, ttl=None):
    """Pin ``holder_id`` as this process tree's spool name if the env has
    not already chosen one (the elastic runner calls this so spool names
    match lease-file holder ids — 'which host is stalled' and 'who stole
    unit 7' then name the same thing), and advertise ``ttl`` as the stall
    threshold hint when none was configured (a heartbeat older than the
    lease TTL is exactly when survivors may steal the host's units). A
    no-op when fleet is disabled."""
    if not enabled():
        return
    if not os.environ.get(ENV_HOLDER):
        _set_env(ENV_HOLDER, sanitize_holder(holder_id))
    if ttl is not None and not os.environ.get(ENV_TTL):
        _set_env(ENV_TTL, str(float(ttl)))
    ensure_started()


# ------------------------------------------------------------- publishing


def record(kind, **fields):
    """Append one lifecycle event to the in-memory buffer (flushed on the
    heartbeat and at exit). A no-op costing one env lookup when disabled;
    enabled, it never raises into the caller."""
    if fleet_dir() is None:
        return
    try:
        ev = {"kind": str(kind), "wall": time.time(),
              "mono": time.monotonic(), "pid": os.getpid()}
        if fields:
            ev["args"] = {k: _jsonable(v) for k, v in fields.items()}
        with _lock:
            if len(_events) >= _MAX_BUFFER:
                return
            _events.append(ev)
        ensure_started()
    except Exception:  # noqa: BLE001 - telemetry must stay inert
        pass


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


def rotating_path(d, prefix, state):
    """The current append segment for this pid under ``d``: the base
    ``<prefix><pid>.jsonl`` until it reaches the rotation bound, then
    ``<prefix><pid>.segNNNN.jsonl`` successors. Rotation never renames
    (os.replace is reserved for the resilience.io publish path) — a full
    segment simply freezes and appends move to the next name, which the
    readers' shared-prefix glob merges seamlessly. ``state`` is a
    per-writer dict carrying the cached current path."""
    base = os.path.join(d, "{}{}".format(prefix, os.getpid()))
    path = state.get("path") or base + ".jsonl"
    cap = _env_float(ENV_ROTATE_BYTES, DEFAULT_ROTATE_BYTES)
    try:
        size = os.path.getsize(path)
    except OSError:
        size = 0
    if size >= cap:
        seq = state.get("seq", 0) + 1
        # A restart that reuses the pid must not append to a frozen
        # segment from the previous life: skip to the first free name.
        while os.path.exists("{}.seg{:04d}.jsonl".format(base, seq)):
            seq += 1
        state["seq"] = seq
        path = "{}.seg{:04d}.jsonl".format(base, seq)
    state["path"] = path
    return path


def gc_spool(d=None, now=None):
    """Size/age-bounded retention for one spool dir. Candidates are
    frozen (rotated) event/series segments that are not this process's
    current append target, and closed snapshots left by OTHER pids
    (generations and restarts otherwise accumulate them forever). A
    candidate is dropped when it is older than the retention age, or
    oldest-first while the spool exceeds the byte budget. Live segments
    and open snapshots are never touched, so a host's current telemetry
    survives any GC pass. Returns the number of files removed."""
    d = d if d is not None else spool_dir()
    if d is None or not os.path.isdir(d):
        return 0
    now = time.time() if now is None else float(now)
    retain_bytes = _env_float(ENV_RETAIN_BYTES, DEFAULT_RETAIN_BYTES)
    retain_age = _env_float(ENV_RETAIN_AGE_S, DEFAULT_RETAIN_AGE_S)
    with _lock:
        keep = {_ev_segment.get("path")}
    try:
        from . import series
        with series._lock:
            keep.add(series._segment.get("path"))
    except Exception:  # noqa: BLE001 - best-effort; GC still runs
        pass
    total, candidates = 0, []
    try:
        names = sorted(os.listdir(d))
    except OSError:
        return 0
    for name in names:
        path = os.path.join(d, name)
        try:
            st = os.stat(path)
        except OSError:
            continue
        total += st.st_size
        if path in keep:
            continue
        frozen = (".seg" in name and name.endswith(".jsonl") and
                  (name.startswith("events-pid") or
                   name.startswith("series-pid")))
        stale_snap = False
        if name.startswith("snapshot-pid") and name.endswith(".json"):
            snap = _read_json(path, warn=lambda *a: None)
            stale_snap = bool(snap) and bool(snap.get("closed")) \
                and int(snap.get("pid", -1)) != os.getpid()
        if frozen or stale_snap:
            candidates.append((st.st_mtime, st.st_size, path))
    candidates.sort()  # oldest first
    removed = 0
    for mtime, size, path in candidates:
        if (now - mtime) <= retain_age and total <= retain_bytes:
            continue
        try:
            os.remove(path)
        except OSError:
            continue
        total -= size
        removed += 1
    return removed


def _maybe_gc(every=6):
    """Run retention every Nth heartbeat (the spool is small between
    passes; a listdir per beat would be pure overhead)."""
    try:
        with _lock:
            _hb["beats"] = _hb.get("beats", 0) + 1
            if _hb["beats"] % every != 1:
                return
        gc_spool()
    except Exception:  # noqa: BLE001 - telemetry must stay inert
        pass


def _snapshot_path():
    d = spool_dir()
    if d is None:
        return None
    return os.path.join(d, "snapshot-pid{}.json".format(os.getpid()))


def flush_events():
    """Append buffered events to this process's spool event log (current
    rotation segment). Each line is written complete; only a mid-write
    crash can tear the final line, which readers degrade to
    end-of-stream."""
    d = spool_dir()
    with _lock:
        path = _ev_segment.get("path")
        if not _events:
            if path is None and d is not None:
                path = os.path.join(
                    d, "events-pid{}.jsonl".format(os.getpid()))
            return path
        batch, _events[:] = list(_events), []
    if d is None:
        return None
    try:
        from ..resilience import io as rio
        os.makedirs(d, exist_ok=True)
        # rotating_path mutates the shared segment dict, and both the
        # heartbeat thread and the SIGTERM/atexit flush reach here.
        with _lock:
            path = rotating_path(d, "events-pid", _ev_segment)
        payload = "".join(json.dumps(ev, sort_keys=True) + "\n"
                          for ev in batch)
        with rio.open_append(path) as f:
            f.write(payload.encode("utf-8"))
    except Exception:  # noqa: BLE001 - drop the batch, never the pipeline
        pass
    return path


def publish_snapshot(closed=False, reason=None):
    """Atomically (re)publish this process's registry snapshot + clock
    pair + liveness flag, via the resilience.io publish path — the same
    tmp+fsync+replace dance shards ride, so a reader never sees a torn
    snapshot. ``closed=True`` marks a clean shutdown: the aggregator only
    stall-flags hosts that went silent WITHOUT it."""
    path = _snapshot_path()
    if path is None:
        return None
    try:
        from ..resilience import io as rio
        snap = {
            "holder": holder(),
            "pid": os.getpid(),
            "rank": rank(),
            "hostname": socket.gethostname(),
            "wall": time.time(),
            "mono": time.monotonic(),
            "started_wall": _started_wall,
            "interval_s": _env_float(ENV_INTERVAL, DEFAULT_INTERVAL_S),
            "ttl_s": _env_float(ENV_TTL, DEFAULT_TTL_S),
            "closed": bool(closed),
            "metrics": registry().snapshot(),
        }
        if reason:
            snap["closed_reason"] = str(reason)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        rio.atomic_write(path, json.dumps(snap, sort_keys=True, default=str))
    except Exception:  # noqa: BLE001 - drop the export, never the pipeline
        return None
    return path


def heartbeat(closed=False, reason=None):
    """One publish cycle: event-log flush + snapshot republish (+ the
    colocated exports when the metrics dir lives in the spool).
    Called by the heartbeat thread, the exit hooks, and the fault
    injector's pre-kill flush."""
    if not enabled():
        return None
    flush_events()
    path = publish_snapshot(closed=closed, reason=reason)
    try:
        # Series history rides the same beat (and therefore the same
        # atexit/SIGTERM/pre-kill flush paths) as the snapshot: a crash
        # loses at most one interval of points plus maybe a torn line.
        from . import series
        series.sample_and_flush()
    except Exception:  # noqa: BLE001 - best-effort history
        pass
    try:
        tracing.flush()
        d = metrics_dir()
        if d is not None and os.path.abspath(d) == os.path.abspath(
                spool_dir() or d):
            from . import exporters
            exporters.export_jsonl()
    except Exception:  # noqa: BLE001 - best-effort colocated exports
        pass
    _maybe_gc()
    return path


def ensure_started(interval=None):
    """Start the heartbeat thread + exit hooks once (idempotent, no-op
    when disabled). Every ``record()`` calls this, so arming the env var
    is the only configuration a host needs — including the metrics side:
    if no metrics dir is armed, one is pointed at the spool here, so an
    env-only arming (documented as equivalent to ``--fleet-telemetry``)
    still publishes non-empty registry snapshots instead of silently
    reporting every counter as zero."""
    if not enabled() or _started:
        return
    with _lock:
        if _started:
            return
        _started.append(True)
    if metrics_dir() is None:
        spool = spool_dir()
        if spool is not None:
            _set_env(ENV_METRICS_DIR, spool)
    import atexit
    atexit.register(_final_flush)
    from . import exporters
    exporters.install_signal_flush()
    # Arm-time stamp: a host that dies between configure() and the first
    # heartbeat used to leave an EMPTY spool dir, indistinguishable from
    # one that never started — and with no started_wall, the aggregator
    # could not even age it into a STALLED verdict. Publish immediately
    # so every armed process leaves at least a start stamp.
    try:
        publish_snapshot()
    except Exception:  # noqa: BLE001 - telemetry must stay inert
        pass
    if interval is None:
        interval = _env_float(ENV_INTERVAL, DEFAULT_INTERVAL_S)
    stop = threading.Event()

    def loop():
        while not stop.wait(interval):
            if not enabled():
                return
            try:
                heartbeat()
            except Exception:  # noqa: BLE001 - keep beating
                pass

    t = threading.Thread(target=loop, name="lddl-fleet-heartbeat",
                         daemon=True)
    t.start()
    # The heartbeat thread writes _hb["beats"] under _lock; publish the
    # thread/stop handles under the same lock.
    with _lock:
        _hb["thread"] = t
        _hb["stop"] = stop


def _final_flush():
    try:
        heartbeat(closed=True, reason="atexit")
    except Exception:  # noqa: BLE001 - exiting anyway
        pass


def _reset_for_tests():
    """Stop the heartbeat, drop buffered state, and pop every environment
    variable this module set (a test that armed the fleet must not leave
    it armed for the next one on the same worker)."""
    with _lock:
        for name in sorted(_env_set):
            os.environ.pop(name, None)
        _env_set.clear()
        _events[:] = []
        _started[:] = []
        _ev_segment.clear()
        _ev_segment["path"] = None
        _hb["beats"] = 0
        stop = _hb["stop"]
        _hb["thread"] = None
        _hb["stop"] = None
    if stop is not None:
        stop.set()
    from . import series
    series._reset_for_tests()


# ------------------------------------------------------------ spool reads


def read_jsonl(path, warn=None):
    """All parseable records of one spool JSONL file, torn-tolerant:
    a torn TRAILING line (a writer died mid-append) reads as end-of-
    stream with a warning; a torn interior line (storage misbehaviour)
    is skipped with a warning. Never raises on content. Streams line by
    line (long-running hosts grow spools without bound — never hold the
    whole file), with one unparsed line of lookahead to tell trailing
    from interior. Returns ``(records, torn_line_count)``."""
    warn = warn or _log.warning
    records, torn = [], 0
    pending = None  # line number of the last unparsed line, pending EOF
    try:
        with open(path, "rb") as f:
            for i, line in enumerate(f):
                line = line.strip()
                if not line:
                    continue
                if pending is not None:
                    warn("torn interior line %d in %s; skipping",
                         pending + 1, path)
                    pending = None
                try:
                    rec = json.loads(line)
                except ValueError:
                    torn += 1
                    pending = i
                    continue
                if isinstance(rec, dict):
                    records.append(rec)
    except OSError as e:
        warn("unreadable telemetry file %s (%s); skipping", path, e)
        return [], 0
    if pending is not None:
        warn("torn trailing line in %s (writer died mid-append?); "
             "treating as end-of-stream", path)
    return records, torn


def _read_json(path, warn=None):
    warn = warn or _log.warning
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except OSError as e:
        warn("unreadable telemetry file %s (%s); skipping", path, e)
        return None
    try:
        rec = json.loads(raw)
    except ValueError:
        warn("torn telemetry snapshot %s; skipping", path)
        return None
    return rec if isinstance(rec, dict) else None


def telemetry_root(root):
    return os.path.join(root, TELEMETRY_DIR)


def list_holders(root):
    d = telemetry_root(root)
    if not os.path.isdir(d):
        return []
    return [n for n in sorted(os.listdir(d))
            if os.path.isdir(os.path.join(d, n))]


def load_spool(root, holder_name, warn=None):
    """One holder's spool, parsed: latest snapshot per pid, the full
    event stream (wall-ordered), and torn-line accounting."""
    d = spool_dir(root, holder_name)
    snapshots, events, torn = {}, [], 0
    for name in sorted(os.listdir(d)) if os.path.isdir(d) else []:
        path = os.path.join(d, name)
        if name.startswith("snapshot-pid") and name.endswith(".json"):
            snap = _read_json(path, warn)
            if snap is not None:
                snapshots[int(snap.get("pid", 0))] = snap
        elif name.startswith("events-pid") and name.endswith(".jsonl"):
            recs, t = read_jsonl(path, warn)
            events.extend(recs)
            torn += t
    events.sort(key=lambda ev: ev.get("wall", 0.0))
    return {"holder": holder_name, "dir": d, "snapshots": snapshots,
            "events": events, "torn_lines": torn}


# ------------------------------------------------------------- aggregator

# Registry counters the rollup surfaces per host and in the totals row
# (report key -> metric name; counts are summed over the holder's pids).
ROLLUP_COUNTERS = (
    ("units_completed", "elastic_units_completed_total"),
    ("steals", "lease_steals_total"),
    ("fence_rejects", "lease_fence_rejects_total"),
    ("renews", "lease_renews_total"),
    ("retries", "resilience_retry_attempts_total"),
    ("retry_exhausted", "resilience_retry_exhausted_total"),
    ("faults_injected", "resilience_faults_injected_total"),
    ("quarantined_shards", "resilience_quarantined_shards_total"),
    ("docs", "preprocess_docs_total"),
    ("doc_bytes", "preprocess_doc_bytes_total"),
    ("samples", "preprocess_samples_total"),
    ("pack_tokens_placed", "preprocess_pack_tokens_total"),
    ("pack_slot_tokens", "preprocess_pack_slot_tokens_total"),
    ("ingest_docs", "ingest_docs_total"),
    ("generations_published", "ingest_generations_published_total"),
    ("loader_batches", "loader_batches_total"),
    ("backend_ops", "backend_ops_total"),
    ("backend_cas_conflicts", "backend_cas_conflicts_total"),
    ("alerts_fired", "alerts_fired_total"),
)

# Labelled counters surfaced per host WITH their label breakdown (the
# flat ROLLUP_COUNTERS sum above collapses labels; these keep them).
ROLLUP_LABELLED = (
    ("backend_ops", "backend_ops_total"),
    ("loader_stage_seconds", "loader_stage_seconds_total"),
    ("alerts_fired", "alerts_fired_total"),
)

# Histograms surfaced per host as merged count/sum/mean/max per label set
# (per-{backend,op} storage op latency is the headline consumer).
ROLLUP_HISTOGRAMS = (
    ("backend_op_latency", "backend_op_latency_seconds"),
)

# Gauges reported at host level when present (latest snapshot wins).
ROLLUP_GAUGES = (
    ("padding_efficiency", "loader_padding_efficiency"),
    ("generation_lag", "loader_generation_lag"),
    ("generations_loaded", "loader_generations_loaded"),
    ("ingest_generation", "ingest_generation"),
    ("ingest_backlog_docs", "ingest_backlog_docs"),
    ("ingest_carry_rows", "ingest_carry_rows"),
    ("samples_per_second", "preprocess_samples_per_second"),
    ("pack_fill_ratio", "preprocess_pack_fill_ratio"),
)


def _counter_total(snap_metrics, name):
    data = (snap_metrics or {}).get(name)
    if not data or data.get("type") != "counter":
        return 0
    return sum(data.get("values", {}).values())


def _gauge_value(snap_metrics, name):
    data = (snap_metrics or {}).get(name)
    if not data or data.get("type") != "gauge":
        return None
    values = data.get("values", {})
    if not values:
        return None
    # Unlabelled gauge is the common case; otherwise take the max label.
    return values.get("", max(values.values()))


def _labelled_totals(snaps, metric):
    """{label_str: value} for one counter, summed over a holder's pids."""
    agg = {}
    for s in snaps:
        data = (s.get("metrics") or {}).get(metric)
        if not data or data.get("type") != "counter":
            continue
        for label_str, v in data.get("values", {}).items():
            agg[label_str] = agg.get(label_str, 0) + v
    return agg


def _histogram_stats(snaps, metric):
    """{label_str: {count, sum, mean, max}} for one histogram, merged
    over a holder's pids (log buckets are dropped here — the windowed
    series path carries percentiles; the rollup carries the moments)."""
    agg = {}
    for s in snaps:
        data = (s.get("metrics") or {}).get(metric)
        if not data or data.get("type") != "histogram":
            continue
        for label_str, st in data.get("values", {}).items():
            cur = agg.setdefault(label_str,
                                 {"count": 0, "sum": 0.0, "max": 0.0})
            cur["count"] += st.get("count", 0)
            cur["sum"] += st.get("sum", 0.0)
            cur["max"] = max(cur["max"], st.get("max", 0.0) or 0.0)
    for cur in agg.values():
        cur["mean"] = (cur["sum"] / cur["count"]) if cur["count"] else None
    return agg


def _stage_seconds_of(labelled):
    """{stage: seconds} off a ``loader_stage_seconds`` label breakdown."""
    out = {}
    for label_str, v in (labelled or {}).items():
        for part in label_str.split(","):
            k, _, stage = part.partition("=")
            if k == "stage" and stage:
                out[stage] = out.get(stage, 0.0) + v
    return out


def _host_rollup(spool, now, stall_ttl):
    snaps = list(spool["snapshots"].values())
    counters = {key: sum(_counter_total(s.get("metrics"), metric)
                         for s in snaps)
                for key, metric in ROLLUP_COUNTERS}
    gauges = {}
    for key, metric in ROLLUP_GAUGES:
        vals = [v for v in (_gauge_value(s.get("metrics"), metric)
                            for s in snaps) if v is not None]
        if vals:
            gauges[key] = max(vals)
    if counters["pack_slot_tokens"]:
        # Recompute the host's pack fill from its counter totals (summed
        # over pids) so the host row and the per-pid gauge agree even
        # when several worker processes each packed a slice.
        gauges["pack_fill_ratio"] = (counters["pack_tokens_placed"]
                                     / counters["pack_slot_tokens"])
    stamps = [s.get("wall", 0.0) for s in snaps]
    stamps.extend(ev.get("wall", 0.0) for ev in spool["events"][-1:])
    last_wall = max(stamps) if stamps else None
    started = min((s.get("started_wall", s.get("wall", now))
                   for s in snaps), default=None)
    ttl = max((s.get("ttl_s", DEFAULT_TTL_S) for s in snaps),
              default=DEFAULT_TTL_S)
    if stall_ttl is not None:
        ttl = stall_ttl
    closed = bool(snaps) and all(s.get("closed") for s in snaps)
    age = (now - last_wall) if last_wall is not None else None
    elapsed = None
    if last_wall is not None and started is not None \
            and last_wall > started:
        elapsed = last_wall - started
    rates = {}
    if elapsed:
        rates["units_per_s"] = counters["units_completed"] / elapsed
        rates["mb_per_s"] = counters["doc_bytes"] / 1e6 / elapsed
        rates["samples_per_s"] = counters["samples"] / elapsed
    event_counts = {}
    for ev in spool["events"]:
        k = ev.get("kind", "?")
        event_counts[k] = event_counts.get(k, 0) + 1
    progress = [ev.get("wall", 0.0) for ev in spool["events"]
                if ev.get("kind") in PROGRESS_EVENTS]
    labelled = {}
    for key, metric in ROLLUP_LABELLED:
        vals = _labelled_totals(snaps, metric)
        if vals:
            labelled[key] = vals
    histograms = {}
    for key, metric in ROLLUP_HISTOGRAMS:
        vals = _histogram_stats(snaps, metric)
        if vals:
            histograms[key] = vals
    attribution_report = None
    stage_s = _stage_seconds_of(labelled.get("loader_stage_seconds"))
    if stage_s:
        try:
            from . import attribution
            attribution_report = attribution.from_stage_seconds(stage_s)
        except Exception:  # noqa: BLE001 - rollup survives a bad snapshot
            attribution_report = None
    return {
        "holder": spool["holder"],
        "pids": sorted(spool["snapshots"]),
        "started_wall": started,
        "last_heartbeat_wall": last_wall,
        "heartbeat_age_s": age,
        "closed": closed,
        "stall_ttl_s": ttl,
        "stalled": (not closed and age is not None and age > ttl),
        "counters": counters,
        "gauges": gauges,
        "rates": rates,
        "labelled": labelled,
        "histograms": histograms,
        "attribution": attribution_report,
        "events_total": len(spool["events"]),
        "event_counts": event_counts,
        "torn_lines": spool["torn_lines"],
        "last_progress_wall": max(progress) if progress else None,
    }


def _fs_progress_stamps(root):
    """Latest mtimes of the on-disk ground truth the wedge verdict also
    trusts: preprocess ledger records and ingest journal segments. File
    mtimes come from the shared FS's clock — same budget the lease
    deadlines already live on."""
    stamps = []
    for d in (os.path.join(root, "_done"),
              os.path.join(root, ".ingest", "journal")):
        if not os.path.isdir(d):
            continue
        for name in sorted(os.listdir(d)):
            try:
                stamps.append(os.stat(os.path.join(d, name)).st_mtime)
            except OSError:
                continue
    return stamps


def _pending_work(root, hosts):
    """Evidence that the pipeline has UNFINISHED work — the wedge verdict
    requires it (an idle-but-alive watch service with nothing to ingest
    is healthy, not wedged): a nonzero ingest backlog gauge on any host,
    an in-flight ingest generation (work dir present), or a preprocess
    run mid-flight (unretired unit ledger)."""
    for st in hosts.values():
        if st["gauges"].get("ingest_backlog_docs"):
            return "ingest backlog"
    wdir = os.path.join(root, ".ingest", "work")
    if os.path.isdir(wdir) and sorted(os.listdir(wdir)):
        return "in-flight ingest generation"
    if os.path.isdir(os.path.join(root, "_done")):
        return "unretired preprocess ledger"
    return None


def _journal_state(root):
    """The ingest journal's latest generation, read off the segment file
    names (cheap, no segment parse)."""
    d = os.path.join(root, ".ingest", "journal")
    if not os.path.isdir(d):
        return None
    gens = []
    for name in sorted(os.listdir(d)):
        m = re.match(r"gen-(\d+)\.json$", name)
        if m:
            gens.append(int(m.group(1)))
    return max(gens) if gens else None


def aggregate(root, now=None, stall_ttl=None, wedge_window=None, warn=None,
              window=None):
    """Merge every host spool under ``<root>/.telemetry/`` into one
    cluster report with health verdicts. Pure function of the spool
    bytes, ``now`` (defaults to this process's wall clock — the one
    clock read the status CLI delegates here) and the thresholds.
    ``window`` (seconds) additionally loads each holder's series
    segments and attaches windowed rates/trends/percentiles per host
    plus a cluster ``window`` block (rates summed across hosts)."""
    now = time.time() if now is None else float(now)
    from . import series as series_mod
    hosts = {}
    for h in list_holders(root):
        hosts[h] = _host_rollup(load_spool(root, h, warn), now, stall_ttl)
        if window:
            points, torn = series_mod.read_series(root, h, warn)
            hosts[h]["window"] = series_mod.window_rollup(
                points, window, now)
            hosts[h]["torn_lines"] += torn
    totals = {key: sum(h["counters"][key] for h in hosts.values())
              for key, _ in ROLLUP_COUNTERS}
    if totals.get("pack_slot_tokens"):
        # Cluster-wide offline-pack fill: recomputed from the summed
        # counters (a mean of per-host ratios would weight hosts, not
        # tokens).
        totals["pack_fill_ratio"] = (totals["pack_tokens_placed"]
                                     / totals["pack_slot_tokens"])
    total_rates = {}
    for key in ("units_per_s", "mb_per_s", "samples_per_s"):
        vals = [h["rates"].get(key) for h in hosts.values()
                if h["rates"].get(key) is not None]
        if vals:
            total_rates[key] = sum(vals)
    stalled = sorted(h for h, st in hosts.items() if st["stalled"])
    live = sorted(h for h, st in hosts.items()
                  if not st["closed"] and not st["stalled"])
    progress = [st["last_progress_wall"] for st in hosts.values()
                if st["last_progress_wall"] is not None]
    progress.extend(_fs_progress_stamps(root))
    last_progress = max(progress) if progress else None
    ttl = stall_ttl if stall_ttl is not None else max(
        (st["stall_ttl_s"] for st in hosts.values()), default=DEFAULT_TTL_S)
    wedge_win = wedge_window if wedge_window is not None \
        else max(4.0 * ttl, 120.0)
    pending = _pending_work(root, hosts)
    # "No progress EVER" must not instant-wedge a freshly started run
    # (the first generation/unit legitimately takes a while to land):
    # the baseline the window counts from is the last progress stamp, or
    # the earliest host start when none exists yet.
    started = [st["started_wall"] for st in hosts.values()
               if st["started_wall"] is not None]
    baseline = last_progress if last_progress is not None \
        else (min(started) if started else None)
    wedged = bool(live) and pending is not None and (
        baseline is not None and (now - baseline) > wedge_win)
    verdicts = []
    for h in stalled:
        verdicts.append(
            "host {} STALLED: last heartbeat {:.1f}s ago exceeds the "
            "{:.1f}s stall TTL with no clean-shutdown marker".format(
                h, hosts[h]["heartbeat_age_s"], hosts[h]["stall_ttl_s"]))
    if wedged:
        age = "never" if last_progress is None \
            else "{:.1f}s ago".format(now - last_progress)
        verdicts.append(
            "service WEDGED: {} live host(s) with {} but last "
            "journal/ledger progress was {} (window {:.1f}s)".format(
                len(live), pending, age, wedge_win))
    for h, st in sorted(hosts.items()):
        if st["torn_lines"]:
            verdicts.append(
                "host {}: {} torn spool line(s) tolerated (host died "
                "mid-append?)".format(h, st["torn_lines"]))
    # Cluster storage-backend view: op counts and merged latency moments
    # per {backend,op,outcome} (pipeline_status --json surfaces these so
    # mock-vs-local op cost is visible from telemetry alone).
    backend_ops, backend_latency = {}, {}
    for st in hosts.values():
        for label_str, v in st["labelled"].get("backend_ops", {}).items():
            backend_ops[label_str] = backend_ops.get(label_str, 0) + v
        for label_str, h_ in st["histograms"].get(
                "backend_op_latency", {}).items():
            cur = backend_latency.setdefault(
                label_str, {"count": 0, "sum": 0.0, "max": 0.0})
            cur["count"] += h_.get("count", 0)
            cur["sum"] += h_.get("sum", 0.0)
            cur["max"] = max(cur["max"], h_.get("max", 0.0) or 0.0)
    for cur in backend_latency.values():
        cur["mean"] = (cur["sum"] / cur["count"]) if cur["count"] else None
    # Cluster attribution: stage seconds summed across hosts, then one
    # fleet-wide bound verdict (a mean of verdicts would weight hosts,
    # not wall time — same reasoning as the pack-fill recompute above).
    cluster_stages = {}
    for st in hosts.values():
        for stage, v in _stage_seconds_of(
                st["labelled"].get("loader_stage_seconds")).items():
            cluster_stages[stage] = cluster_stages.get(stage, 0.0) + v
    cluster_attr = None
    if cluster_stages:
        try:
            from . import attribution
            cluster_attr = attribution.from_stage_seconds(cluster_stages)
        except Exception:  # noqa: BLE001 - report survives bad metrics
            cluster_attr = None
    report_window = None
    if window:
        wrates = {}
        for st in hosts.values():
            for key, r in st.get("window", {}).get("rates", {}).items():
                wrates[key] = wrates.get(key, 0.0) + r
        report_window = {"window_s": float(window), "rates": wrates}
    return {
        "root": os.path.abspath(root),
        "generated_wall": now,
        "hosts": hosts,
        "totals": {"counters": totals, "rates": total_rates},
        "backend": {"ops": backend_ops, "latency": backend_latency},
        "attribution": cluster_attr,
        "window": report_window,
        "journal_generation": _journal_state(root),
        "pending_work": pending,
        "last_progress_wall": last_progress,
        "health": {
            "ok": not stalled and not wedged,
            "stalled_hosts": stalled,
            "live_hosts": live,
            "closed_hosts": sorted(h for h, st in hosts.items()
                                   if st["closed"]),
            "wedged": wedged,
            "stall_ttl_s": ttl,
            "wedge_window_s": wedge_win,
            "verdicts": verdicts,
        },
    }


# ------------------------------------------------------------ trace merge


def _clock_samples(spool):
    """Per-pid (wall, wall-mono) samples from every spool record that
    carries the clock pair, mono-ordered."""
    by_pid = {}
    for ev in spool["events"]:
        if "wall" in ev and "mono" in ev:
            by_pid.setdefault(int(ev.get("pid", 0)), []).append(
                (float(ev["mono"]), float(ev["wall"])))
    for pid, snap in spool["snapshots"].items():
        if "wall" in snap and "mono" in snap:
            by_pid.setdefault(int(pid), []).append(
                (float(snap["mono"]), float(snap["wall"])))
    return {pid: sorted(samples) for pid, samples in by_pid.items()}


def _step_corrections(samples):
    """Wall-clock-step corrections for one pid: segments of
    ``(wall_from, delta_s)`` meaning events stamped at/after ``wall_from``
    were recorded ``delta_s`` off the process's original wall<->mono
    anchor and must be shifted back by ``delta_s``. Empty when the clock
    behaved (the overwhelmingly common case)."""
    if len(samples) < 2:
        return []
    base = samples[0][1] - samples[0][0]  # first wall - mono offset
    segments = []
    current = 0.0
    for mono, wall in samples[1:]:
        delta = (wall - mono) - base
        if abs(delta - current) > CLOCK_STEP_S:
            segments.append((wall, delta))
            current = delta
    return segments


def _corrected_ts(ts_us, segments):
    delta = 0.0
    for wall_from, d in segments:
        if ts_us >= wall_from * 1e6:
            delta = d
    return ts_us - delta * 1e6


def merge_traces(root, warn=None):
    """Merge every host spool's Chrome-trace files into ONE event list
    spanning the fleet: per-(holder, pid) Perfetto lanes (synthetic lane
    pids with ``process_name``/``process_sort_index`` metadata naming the
    real holder+pid), and per-pid wall-clock-step correction from the
    spool's clock samples so a stepped host still lines up. Returns
    ``(events, lanes)`` where lanes is ``[(lane_pid, holder, real_pid)]``;
    the caller writes the JSON (Perfetto accepts a plain JSON array)."""
    events, lanes = [], []
    lane_of = {}
    for h in list_holders(root):
        spool = load_spool(root, h, warn)
        corrections = {pid: _step_corrections(samples)
                       for pid, samples in _clock_samples(spool).items()}
        d = spool["dir"]
        names = [n for n in sorted(os.listdir(d))
                 if n.startswith("trace-") and n.endswith(".jsonl")] \
            if os.path.isdir(d) else []
        for name in names:
            recs, _ = read_jsonl(os.path.join(d, name), warn)
            for rec in recs:
                if rec.get("ph") == "M":
                    continue  # re-emitted per lane below
                real_pid = int(rec.get("pid", 0))
                key = (h, real_pid)
                if key not in lane_of:
                    lane_of[key] = len(lane_of) + 1
                    lanes.append((lane_of[key], h, real_pid))
                out = dict(rec)
                out["pid"] = lane_of[key]
                segs = corrections.get(real_pid)
                if segs and "ts" in out:
                    out["ts"] = _corrected_ts(float(out["ts"]), segs)
                events.append(out)
    meta = []
    for lane, h, real_pid in lanes:
        meta.append({"name": "process_name", "ph": "M", "pid": lane,
                     "args": {"name": "{} pid{}".format(h, real_pid)}})
        meta.append({"name": "process_sort_index", "ph": "M", "pid": lane,
                     "args": {"sort_index": lane}})
    events.sort(key=lambda ev: ev.get("ts", 0.0))
    return meta + events, lanes
