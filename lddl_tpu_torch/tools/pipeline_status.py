"""Fleet/pipeline health monitor: one-shot report, --watch, or --json.

Counterpart of ``tools/pipeline_status.py``. Usage::

    python -m lddl_tpu_torch.tools.pipeline_status <dataset_or_output_dir>
    python -m lddl_tpu_torch.tools.pipeline_status <dir> --watch [--interval 5]
    python -m lddl_tpu_torch.tools.pipeline_status <dir> --json   # CI

Reads the per-host telemetry spools under ``<dir>/.telemetry/`` (written
by hosts running with ``LDDL_TPU_FLEET_DIR=<dir>`` or
``--fleet-telemetry``; see lddl_tpu_torch/observability/fleet.py) and renders
cluster rollups with explicit health verdicts:

- a host is **STALLED** when its last heartbeat is older than the stall
  TTL (default: the lease TTL the host advertised) and it left no
  clean-shutdown marker — the same condition under which the elastic
  scheduler lets survivors steal the host's units;
- the service is **WEDGED** when live hosts and pending work exist but
  the journal/ledger has made no progress inside the wedge window.

``--window SECONDS`` additionally reads the time-series segments each
host's heartbeat spools (series-pid*.jsonl) and renders windowed rates
with sparklines and gauge trends — "what is happening NOW", not lifetime
averages. ``--alerts rules.json`` evaluates a declarative alert-rules
file (threshold / rate-over-window / absence; see
lddl_tpu_torch/observability/alerts.py for the schema) against the same
rollup; firing/resolving transitions are journaled under
``.telemetry/`` so one-shot invocations see them too.

Exit status: 0 when healthy, 2 when any verdict fired OR any alert rule
is firing (``--json`` too, so CI can gate on it). ``--merge-trace
out.json`` additionally writes one clock-aligned Chrome trace spanning
every host (open in Perfetto); ``lddl_tpu_torch.tools.trace_summary
--merge`` does the same plus summary tables.

The reference's "static analysis" line (the analyzer's SARIF verdict)
is left out: the port has no analyzer yet, so the report carries no
such section.

All wall-clock reads happen inside ``fleet.aggregate``; this tool only
formats the report.
"""

import argparse
import json
import sys
import time

from .trace_summary import _table


def _fmt_age(age):
    if age is None:
        return "-"
    if age < 120:
        return "{:.1f}s".format(age)
    if age < 7200:
        return "{:.1f}m".format(age / 60.0)
    return "{:.1f}h".format(age / 3600.0)


def _fmt_rate(v, unit):
    if v is None:
        return "-"
    return "{:.2f}{}".format(v, unit)


def _host_status(st):
    if st["stalled"]:
        return "STALLED"
    if st["closed"]:
        return "closed"
    return "live"


_SPARK_CHARS = "▁▂▃▄▅▆▇█"


def _spark(values, width=24):
    """A sparkline over a value sequence, resampled to ``width`` bins by
    summing (the inputs are deltas, so summing preserves totals)."""
    if not values:
        return ""
    if len(values) > width:
        bins = [0.0] * width
        for i, v in enumerate(values):
            bins[i * width // len(values)] += v
        values = bins
    hi = max(values)
    if hi <= 0:
        return _SPARK_CHARS[0] * len(values)
    return "".join(
        _SPARK_CHARS[min(len(_SPARK_CHARS) - 1,
                         int(v / hi * (len(_SPARK_CHARS) - 1) + 0.5))]
        for v in values)


def _trend_arrow(trend):
    if trend is None:
        return ""
    if trend > 0:
        return "↑"
    if trend < 0:
        return "↓"
    return "→"


def _window_sections(report):
    """(rate_rows, gauge_rows) for the --window tables, merged across
    hosts (each row keeps its host column so a skewed host stands out)."""
    rate_rows, gauge_rows = [], []
    for name in sorted(report["hosts"]):
        win = report["hosts"][name].get("window")
        if not win:
            continue
        for key in sorted(win["rates"]):
            deltas = [dv for _, dv in win["deltas"].get(key, ())]
            rate_rows.append([name, key,
                              "{:.3g}/s".format(win["rates"][key]),
                              _spark(deltas)])
        for key in sorted(win["gauges"]):
            g = win["gauges"][key]
            gauge_rows.append([name, key, "{:.4g}".format(g["last"]),
                               _trend_arrow(g.get("trend"))])
    return rate_rows, gauge_rows


def format_report(report):
    out = []
    health = report["health"]
    out.append("pipeline status: {}".format(report["root"]))
    out.append("overall: {}".format("OK" if health["ok"] else "UNHEALTHY"))
    gen = report.get("journal_generation")
    bits = []
    if gen is not None:
        bits.append("ingest journal at generation {}".format(gen))
    if report.get("pending_work"):
        bits.append("pending work: {}".format(report["pending_work"]))
    fill = report["totals"]["counters"].get("pack_fill_ratio")
    if fill is not None:
        bits.append("offline pack fill {:.4f} (tokens placed / budget "
                    "slots)".format(fill))
    if bits:
        out.append("; ".join(bits))
    hosts = report["hosts"]
    if not hosts:
        out.append("no telemetry spools found under {}/.telemetry/ — run "
                   "hosts with --fleet-telemetry or LDDL_TPU_FLEET_DIR"
                   .format(report["root"]))
    else:
        rows = []
        for name in sorted(hosts):
            st = hosts[name]
            c = st["counters"]
            rows.append([
                name,
                _host_status(st),
                _fmt_age(st["heartbeat_age_s"]),
                c["units_completed"],
                c["steals"],
                c["fence_rejects"],
                c["retries"],
                _fmt_rate(st["rates"].get("units_per_s"), "/s"),
                _fmt_rate(st["rates"].get("mb_per_s"), ""),
                st["torn_lines"] or "",
            ])
        totals = report["totals"]
        rows.append([
            "TOTAL", "", "",
            totals["counters"]["units_completed"],
            totals["counters"]["steals"],
            totals["counters"]["fence_rejects"],
            totals["counters"]["retries"],
            _fmt_rate(totals["rates"].get("units_per_s"), "/s"),
            _fmt_rate(totals["rates"].get("mb_per_s"), ""),
            "",
        ])
        out.append("")
        out.append(_table(rows, ["host", "state", "beat", "units",
                                 "steals", "fenced", "retries", "units/s",
                                 "MB/s", "torn"]))
        gauge_rows = []
        for name in sorted(hosts):
            for key, val in sorted(hosts[name]["gauges"].items()):
                gauge_rows.append([name, key,
                                   "{:.4g}".format(val)
                                   if isinstance(val, float) else val])
        if gauge_rows:
            out.append("")
            out.append(_table(gauge_rows, ["host", "gauge", "value"]))
        events = {}
        for st in hosts.values():
            for kind, n in st["event_counts"].items():
                events[kind] = events.get(kind, 0) + n
        if events:
            out.append("")
            out.append(_table(
                [[k, n] for k, n in sorted(events.items(),
                                           key=lambda kv: -kv[1])],
                ["lifecycle event", "count"]))
    attr = report.get("attribution")
    if attr:
        from ..observability import attribution as attr_mod
        out.append("")
        out.append(attr_mod.format_report(attr))
    backend = report.get("backend") or {}
    if backend.get("ops") or backend.get("latency"):
        lat = backend.get("latency") or {}
        rows = []
        for label, n in sorted(backend.get("ops", {}).items()):
            stats = lat.get(_strip_outcome(label), {})
            rows.append([label, n,
                         "{:.2f}ms".format(stats["mean"] * 1e3)
                         if stats.get("mean") is not None else "-",
                         "{:.2f}ms".format(stats["max"] * 1e3)
                         if stats.get("max") is not None else "-"])
        out.append("")
        out.append(_table(rows, ["backend op", "count", "mean", "max"]))
    rate_rows, gauge_rows = _window_sections(report)
    if rate_rows or gauge_rows:
        out.append("")
        out.append("window: last {:.0f}s".format(
            report.get("window", {}).get("window_s", 0.0)))
        if rate_rows:
            out.append(_table(rate_rows, ["host", "metric", "rate",
                                          "trend"]))
        if gauge_rows:
            out.append(_table(gauge_rows, ["host", "gauge", "last", ""]))
    alerts = report.get("alerts")
    if alerts:
        out.append("")
        for a in alerts["alerts"]:
            state = "FIRING" if a["firing"] else (
                "error" if a.get("error") else "ok")
            detail = a.get("error") or "value={}".format(
                "-" if a["value"] is None else "{:.4g}".format(a["value"])
                if isinstance(a["value"], float) else a["value"])
            out.append("alert {:<24s} [{}] {}".format(
                a["name"], state, detail))
    out.append("")
    if health["verdicts"]:
        for v in health["verdicts"]:
            out.append("!! {}".format(v))
    else:
        out.append("no health verdicts fired")
    if alerts and alerts["firing"]:
        out.append("!! alert(s) firing: {}".format(
            ", ".join(alerts["firing"])))
    return "\n".join(out)


def _strip_outcome(label):
    """backend_ops_total labels carry an outcome the latency histogram
    does not — drop it so the two join on {backend,op}."""
    return ",".join(part for part in label.split(",")
                    if not part.startswith("outcome="))


def run_once(args):
    from ..observability import fleet
    from ..resilience import backend as storage

    report = fleet.aggregate(args.dir, stall_ttl=args.stall_ttl,
                             wedge_window=args.wedge_window,
                             window=args.window)
    # The backend this process would coordinate through (env-selected;
    # chaos/CI runs export LDDL_TPU_STORAGE_BACKEND into the whole
    # fleet, so the operator's status probe names the same store).
    report["storage_backend"] = storage.active_name()
    if args.alerts:
        from ..observability import alerts as alerts_mod
        report["alerts"] = alerts_mod.evaluate_file(
            args.dir, args.alerts, report=report)
    if args.merge_trace:
        events, lanes = fleet.merge_traces(args.dir)
        with open(args.merge_trace, "w", encoding="utf-8") as f:
            json.dump(events, f)
        report["merged_trace"] = {"path": args.merge_trace,
                                  "events": len(events),
                                  "lanes": ["{} pid{}".format(h, p)
                                            for _, h, p in lanes]}
    if args.json:
        print(json.dumps(report, indent=2, sort_keys=True, default=str))
    else:
        print(format_report(report))
        if args.merge_trace:
            print("merged trace: {} ({} events, {} lane(s))".format(
                args.merge_trace, len(events), len(lanes)))
    firing = bool(report.get("alerts", {}).get("firing"))
    return 0 if report["health"]["ok"] and not firing else 2


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("dir", help="dataset/output dir containing .telemetry/")
    ap.add_argument("--json", action="store_true",
                    help="emit the machine-readable report (exit 2 when "
                         "unhealthy, same as the text mode)")
    ap.add_argument("--watch", action="store_true",
                    help="re-render the report every --interval seconds "
                         "until interrupted")
    ap.add_argument("--interval", type=float, default=5.0,
                    help="--watch refresh period")
    ap.add_argument("--stall-ttl", type=float, default=None,
                    help="heartbeat age (s) after which a non-closed host "
                         "is declared stalled (default: the max TTL the "
                         "hosts advertised, else 30)")
    ap.add_argument("--wedge-window", type=float, default=None,
                    help="no-progress window (s) after which live hosts "
                         "with pending work are declared wedged "
                         "(default: max(4*stall_ttl, 120))")
    ap.add_argument("--window", type=float, default=None, metavar="SECONDS",
                    help="also read the series segments and report "
                         "windowed rates, sparklines, and gauge trends "
                         "over the trailing SECONDS")
    ap.add_argument("--alerts", default=None, metavar="RULES_FILE",
                    help="evaluate a JSON/TOML alert-rules file against "
                         "the rollup; any firing rule forces exit 2 and "
                         "transitions are journaled under .telemetry/")
    ap.add_argument("--merge-trace", default=None, metavar="OUT.json",
                    help="also write one clock-aligned Chrome trace "
                         "merging every host spool (open in Perfetto)")
    args = ap.parse_args(argv)
    if not args.watch:
        return run_once(args)
    try:
        while True:
            sys.stdout.write("\x1b[2J\x1b[H")  # clear + home
            run_once(args)
            sys.stdout.flush()
            time.sleep(max(args.interval, 0.2))
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    sys.exit(main())
