"""Declarative alert rules over telemetry: threshold / rate / absence.

Counterpart of ``lddl_tpu/observability/alerts.py``: a small rule
vocabulary evaluated against the fleet rollup and the registry metrics
in the spools, so operators declare SLOs ("backlog above 10k docs",
"CAS-conflict rate above 5/s over 60s", "no loader heartbeat at all")
in a JSON or TOML file instead of writing watchers.

Rules file (JSON shown; TOML with ``[[rules]]`` tables works when the
interpreter ships ``tomllib``)::

    {"rules": [
      {"name": "backlog-slo", "type": "threshold",
       "metric": "ingest_backlog_docs", "op": ">", "value": 10000},
      {"name": "cas-storm", "type": "rate",
       "metric": "backend_cas_conflicts_total", "window_s": 60,
       "op": ">", "value": 5},
      {"name": "no-loader", "type": "absence",
       "metric": "loader_batches_total", "window_s": 120}
    ]}

``metric`` resolves, in order:

1. a dotted **report path** into the ``fleet.aggregate`` rollup when it
   contains a dot (``totals.counters.fence_rejects``,
   ``health.wedged`` — booleans read as 0/1; a ``*`` segment fans out
   over dict values and takes the numeric max, so
   ``hosts.*.heartbeat_age_s`` is "the worst heartbeat age");
2. a **registry metric name** merged across every holder's latest
   snapshots — counters sum, gauges max, histograms read their mean; an
   optional ``{label=value,...}`` suffix selects one label set.

Rule semantics:

- ``threshold``: fire while ``value <op> threshold`` holds now.
- ``rate``: fire while the windowed per-second rate (computed from the
  series segments, summed across hosts) satisfies ``op``/``value``.
- ``absence``: fire while the metric resolves to nothing — no snapshot
  carries it, and (when ``window_s`` is set) no series point inside the
  window recorded it either. The "is anything alive at all" rule.

Firing/resolving transitions are journaled to
``<root>/.telemetry/alerts-events.jsonl`` in the fleet event-line format
(``alert.fired`` / ``alert.resolved``, torn-tail-tolerant on read), the
engine state persists in ``alerts-state.json`` next to it (so one-shot
``pipeline_status`` invocations detect transitions across runs), and
``alerts_fired_total{rule}`` counts fires when metrics are armed.
Evaluation never raises: a malformed rule reports as an ``error`` entry
and counts as not-firing. Wall-clock reads stay in this module; the
status tool delegates here.
"""

import json
import logging
import os
import time

from .registry import inc as obs_inc

STATE_FILE = "alerts-state.json"
EVENTS_FILE = "alerts-events.jsonl"

FIRED_COUNTER = "alerts_fired_total"

DEFAULT_WINDOW_S = 60.0

_OPS = {
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    "==": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
}

_log = logging.getLogger("lddl_tpu_torch.observability.alerts")


def load_rules(path):
    """Parse a rules file (JSON, or TOML when the stdlib has tomllib).
    Returns the normalized rule list; raises ValueError on a file that
    cannot express rules (bad syntax, duplicate names, unknown type) —
    a rules file the operator points at explicitly SHOULD fail loudly,
    unlike the inert telemetry hooks."""
    with open(path, "rb") as f:
        raw = f.read()
    if path.endswith(".toml"):
        try:
            import tomllib
        except ImportError as e:
            raise ValueError(
                "TOML rules need python>=3.11 (tomllib); use JSON") from e
        doc = tomllib.loads(raw.decode("utf-8"))
    else:
        doc = json.loads(raw.decode("utf-8"))
    rules = doc.get("rules", doc) if isinstance(doc, dict) else doc
    if not isinstance(rules, list):
        raise ValueError("rules file must hold a list under 'rules'")
    seen = set()
    out = []
    for i, rule in enumerate(rules):
        if not isinstance(rule, dict):
            raise ValueError("rule #{} is not a table/object".format(i))
        name = str(rule.get("name") or "").strip()
        if not name:
            raise ValueError("rule #{} has no name".format(i))
        if name in seen:
            raise ValueError("duplicate rule name {!r}".format(name))
        seen.add(name)
        rtype = rule.get("type", "threshold")
        if rtype not in ("threshold", "rate", "absence"):
            raise ValueError("rule {!r}: unknown type {!r}".format(
                name, rtype))
        if not rule.get("metric"):
            raise ValueError("rule {!r} has no metric".format(name))
        op = rule.get("op", ">")
        if op not in _OPS:
            raise ValueError("rule {!r}: unknown op {!r}".format(name, op))
        if rtype != "absence" and not isinstance(
                rule.get("value"), (int, float)):
            raise ValueError("rule {!r} needs a numeric value".format(name))
        out.append(dict(rule, name=name, type=rtype, op=op))
    return out


def _split_selector(metric):
    """``name{k=v,...}`` -> (name, {k: v}); plain names pass through."""
    if metric.endswith("}") and "{" in metric:
        name, _, rest = metric.partition("{")
        sel = {}
        for part in rest[:-1].split(","):
            k, _, v = part.partition("=")
            if k:
                sel[k.strip()] = v.strip()
        return name, sel
    return metric, None


def _label_match(label_str, sel):
    if sel is None:
        return True
    have = {}
    for part in label_str.split(","):
        k, _, v = part.partition("=")
        if k:
            have[k] = v
    return all(have.get(k) == v for k, v in sel.items())


def _as_number(v):
    if isinstance(v, bool):
        return 1.0 if v else 0.0
    if isinstance(v, (int, float)):
        return float(v)
    return None


def _report_path(report, path):
    """Resolve a dotted path into the rollup; a ``*`` segment fans out
    over dict values and the numeric max wins (absent -> None)."""
    nodes = [report]
    for seg in path.split("."):
        nxt = []
        for node in nodes:
            if not isinstance(node, dict):
                continue
            if seg == "*":
                nxt.extend(node.values())
            elif seg in node:
                nxt.append(node[seg])
        nodes = nxt
        if not nodes:
            return None
    vals = [n for n in (_as_number(v) for v in nodes) if n is not None]
    return max(vals) if vals else None


def _merged_snapshot_metrics(root, warn=None):
    """{metric_name: {"type", "values": {label_str: merged}}} across every
    holder's latest per-pid snapshots: counters sum, gauges max,
    histograms keep (count, sum, max) for mean-reads."""
    from . import fleet
    merged = {}
    for h in fleet.list_holders(root):
        spool = fleet.load_spool(root, h, warn)
        for snap in spool["snapshots"].values():
            for name, data in (snap.get("metrics") or {}).items():
                kind = data.get("type")
                slot = merged.setdefault(name, {"type": kind, "values": {}})
                if slot["type"] != kind:
                    continue
                for label_str, v in (data.get("values") or {}).items():
                    cur = slot["values"].get(label_str)
                    if kind == "counter":
                        slot["values"][label_str] = (cur or 0) + v
                    elif kind == "gauge":
                        num = _as_number(v)
                        if num is not None:
                            slot["values"][label_str] = num if cur is None \
                                else max(cur, num)
                    elif kind == "histogram" and isinstance(v, dict):
                        if cur is None:
                            cur = {"count": 0, "sum": 0.0}
                            slot["values"][label_str] = cur
                        cur["count"] += v.get("count", 0)
                        cur["sum"] += v.get("sum", 0.0)
    return merged


def _snapshot_value(metrics, metric):
    name, sel = _split_selector(metric)
    data = metrics.get(name)
    if not data:
        return None
    kind, values = data.get("type"), data.get("values", {})
    picked = [(ls, v) for ls, v in values.items() if _label_match(ls, sel)]
    if not picked:
        return None
    if kind == "counter":
        return float(sum(v for _, v in picked))
    if kind == "gauge":
        vals = [n for n in (_as_number(v) for _, v in picked)
                if n is not None]
        return max(vals) if vals else None
    if kind == "histogram":
        count = sum(v.get("count", 0) for _, v in picked)
        total = sum(v.get("sum", 0.0) for _, v in picked)
        return (total / count) if count else None
    return None


def _series_stats(root, metric, window_s, now, warn=None):
    """(windowed_rate_per_s, points_seen) for one metric across every
    holder's series segments; rate sums over hosts, labels merge unless
    a {label=...} selector narrows them."""
    from . import fleet, series
    name, sel = _split_selector(metric)
    rate, points = 0.0, 0
    for h in fleet.list_holders(root):
        pts, _ = series.read_series(root, h, warn)
        roll = series.window_rollup(pts, window_s, now)
        for key, r in roll["rates"].items():
            kname, klabels = series.split_key(key)
            if kname == name and _label_match(klabels, sel):
                rate += r
                points += len(roll["deltas"].get(key, ()))
    return rate, points


class AlertEngine:
    """Evaluates a rule list against one telemetry root, tracking
    firing state across evaluations (in memory, and persisted under
    ``.telemetry/`` so one-shot status runs see transitions too)."""

    def __init__(self, rules, root):
        self.rules = rules
        self.root = root
        self._tdir = os.path.join(root, ".telemetry")
        self._state_path = os.path.join(self._tdir, STATE_FILE)
        self._events_path = os.path.join(self._tdir, EVENTS_FILE)
        self._state = self._load_state()

    def _load_state(self):
        try:
            with open(self._state_path, "rb") as f:
                doc = json.loads(f.read())
            return doc if isinstance(doc, dict) else {}
        except (OSError, ValueError):
            return {}

    def _save_state(self):
        try:
            from ..resilience import io as rio
            os.makedirs(self._tdir, exist_ok=True)
            rio.atomic_write(self._state_path,
                             json.dumps(self._state, sort_keys=True))
        except Exception:  # noqa: BLE001 - state loss degrades to re-fire
            _log.warning("could not persist alert state to %s",
                         self._state_path)

    def _evaluate_rule(self, rule, report, now, warn):
        metric = str(rule["metric"])
        rtype = rule["type"]
        out = {"name": rule["name"], "type": rtype, "metric": metric,
               "firing": False, "value": None}
        try:
            if rtype == "rate":
                window = float(rule.get("window_s", DEFAULT_WINDOW_S))
                rate, _ = _series_stats(self.root, metric, window, now,
                                        warn)
                out["value"] = rate
                out["window_s"] = window
                out["firing"] = _OPS[rule["op"]](rate, rule["value"])
                out["threshold"] = rule["value"]
                return out
            value = None
            if "." in metric:
                value = _report_path(report, metric)
            if value is None:
                value = _snapshot_value(self._metrics_cache(warn), metric)
            if rtype == "absence":
                window = rule.get("window_s")
                if window is not None:
                    # Freshness flavor: the metric must have moved inside
                    # the window — a stale lifetime snapshot doesn't count.
                    _, pts = _series_stats(self.root, metric,
                                           float(window), now, warn)
                    absent = pts == 0
                else:
                    absent = value is None
                out["firing"] = absent
                out["value"] = value
                return out
            out["value"] = value
            out["threshold"] = rule["value"]
            out["firing"] = value is not None and _OPS[rule["op"]](
                value, rule["value"])
            return out
        except Exception as e:  # noqa: BLE001 - one bad rule != no alerts
            out["error"] = str(e)
            out["firing"] = False
            return out

    def _metrics_cache(self, warn):
        if not hasattr(self, "_metrics"):
            self._metrics = _merged_snapshot_metrics(self.root, warn)
        return self._metrics

    def evaluate(self, report=None, now=None, warn=None):
        """One evaluation pass. Returns ``{"alerts": [...], "firing":
        [names], "transitions": [...]}``; transitions (vs the persisted
        state) are appended to the alert event log and counted."""
        now = time.time() if now is None else float(now)
        if report is None:
            from . import fleet
            report = fleet.aggregate(self.root, now=now, warn=warn)
        if hasattr(self, "_metrics"):
            del self._metrics  # re-read snapshots every pass
        alerts, transitions = [], []
        for rule in self.rules:
            res = self._evaluate_rule(rule, report, now, warn)
            prev = self._state.get(res["name"], {})
            was_firing = bool(prev.get("firing"))
            if res["firing"] and not was_firing:
                transitions.append({"kind": "alert.fired",
                                    "rule": res["name"],
                                    "value": res["value"], "wall": now})
                self._state[res["name"]] = {"firing": True,
                                            "since_wall": now}
                obs_inc(FIRED_COUNTER, rule=res["name"])
            elif not res["firing"] and was_firing:
                transitions.append({"kind": "alert.resolved",
                                    "rule": res["name"],
                                    "value": res["value"], "wall": now})
                self._state[res["name"]] = {"firing": False,
                                            "resolved_wall": now}
            if res["firing"]:
                res["since_wall"] = self._state[res["name"]].get(
                    "since_wall", now)
            alerts.append(res)
        if transitions:
            self._append_transitions(transitions)
        self._save_state()
        return {"now": now, "alerts": alerts,
                "firing": [a["name"] for a in alerts if a["firing"]],
                "transitions": transitions}

    def _append_transitions(self, transitions):
        """Append fired/resolved records to the alert event log — fleet
        event-line format (kind + clock pair + args), same torn-tail
        discipline on read."""
        try:
            from ..resilience import io as rio
            os.makedirs(self._tdir, exist_ok=True)
            mono = time.monotonic()
            payload = "".join(
                json.dumps({"kind": t["kind"], "wall": t["wall"],
                            "mono": mono, "pid": os.getpid(),
                            "args": {"rule": t["rule"],
                                     "value": t["value"]}},
                           sort_keys=True) + "\n"
                for t in transitions)
            with rio.open_append(self._events_path) as f:
                f.write(payload.encode("utf-8"))
        except Exception:  # noqa: BLE001 - alerting must not crash status
            _log.warning("could not append alert transitions to %s",
                         self._events_path)


def read_alert_events(root, warn=None):
    """All alert.fired/alert.resolved records under one telemetry root
    (torn-tolerant). Returns ``(records, torn_count)``."""
    from . import fleet
    path = os.path.join(root, ".telemetry", EVENTS_FILE)
    if not os.path.exists(path):
        return [], 0
    return fleet.read_jsonl(path, warn)


def evaluate_file(root, rules_path, report=None, now=None, warn=None):
    """Convenience one-shot: load rules, evaluate, return the result
    (the pipeline_status integration point)."""
    engine = AlertEngine(load_rules(rules_path), root)
    return engine.evaluate(report=report, now=now, warn=warn)
