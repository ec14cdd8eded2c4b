"""Turn trace JSONL files into a per-stage wall-time table, or merge a
whole fleet's traces into one aligned timeline.

Counterpart of ``tools/trace_summary.py``. Usage::

    python -m lddl_tpu_torch.tools.trace_summary <metrics_dir_or_trace.jsonl> [...]
    python -m lddl_tpu_torch.tools.trace_summary <dataset_dir> --merge merged.json

Summary mode reads every ``trace-*.jsonl`` under the given directories
(including per-host fleet spools under ``.telemetry/<holder>/``) or the
files given directly, groups complete ("ph": "X") events by span name,
and prints per-span and per-stage (name prefix before the first dot)
rollups: count, total wall time, mean and max. Instant events are
tallied by name. Multi-host/multi-pid inputs land on one table.

``--merge OUT.json`` additionally writes ONE Chrome trace spanning every
host spool under ``<dir>/.telemetry/``: per-(host, pid) Perfetto lanes
named after the holder, with each host's events re-anchored through its
published (wall, mono) clock samples so a wall-clock step on one host
cannot skew the merged timeline (see observability/fleet.merge_traces).

The input is the Chrome Trace Event format the observability layer emits
(one JSON object per line; a leading ``[`` / trailing ``]`` from a
hand-wrapped file is tolerated), so the same files open in Perfetto. A
torn trailing line — a host SIGKILLed mid-append — is reported as
end-of-stream with a warning, never an error.
"""

import argparse
import json
import os
import sys


def iter_events(path):
    """Stream events line-by-line (fleet trace files run to hundreds of
    MB — never slurp). One unparseable line of lookahead distinguishes a
    torn TRAILING line (a writer died mid-append: end-of-stream with a
    warning) from a torn interior one (skipped with a warning)."""
    torn_at = None  # line number of the last unparsed line, pending EOF
    with open(path, encoding="utf-8") as f:
        for i, line in enumerate(f):
            line = line.strip().rstrip(",")
            if not line or line in ("[", "]"):
                continue
            if torn_at is not None:
                print("warning: unparseable line {} in {}; skipped".format(
                    torn_at + 1, path), file=sys.stderr)
                torn_at = None
            if line.startswith("["):
                line = line[1:]
            if line.endswith("]"):
                line = line[:-1]
            if not line:
                continue
            try:
                ev = json.loads(line)
            except ValueError:
                torn_at = i
                continue
            if isinstance(ev, dict):
                yield ev
    if torn_at is not None:
        print("warning: torn trailing line in {} (writer died "
              "mid-append?); treating as end-of-stream".format(path),
              file=sys.stderr)


def collect(paths):
    """{span_name: {count, total_us, max_us}}, {instant_name: count}."""
    spans, instants = {}, {}
    for path in paths:
        for ev in iter_events(path):
            ph = ev.get("ph")
            name = ev.get("name")
            if not name:
                continue
            if ph == "X":
                st = spans.setdefault(name,
                                      {"count": 0, "total_us": 0.0,
                                       "max_us": 0.0})
                dur = float(ev.get("dur", 0.0))
                st["count"] += 1
                st["total_us"] += dur
                if dur > st["max_us"]:
                    st["max_us"] = dur
            elif ph == "i":
                instants[name] = instants.get(name, 0) + 1
    return spans, instants


def stage_of(name):
    return name.split(".", 1)[0]


def rollup_stages(spans):
    stages = {}
    for name, st in spans.items():
        agg = stages.setdefault(stage_of(name),
                                {"count": 0, "total_us": 0.0, "max_us": 0.0})
        agg["count"] += st["count"]
        agg["total_us"] += st["total_us"]
        if st["max_us"] > agg["max_us"]:
            agg["max_us"] = st["max_us"]
    return stages


def _table(rows, headers):
    widths = [max(len(str(r[i])) for r in rows + [headers])
              for i in range(len(headers))]
    lines = []
    for r in [headers, ["-" * w for w in widths]] + rows:
        lines.append("  ".join(
            str(c).ljust(w) if i == 0 else str(c).rjust(w)
            for i, (c, w) in enumerate(zip(r, widths))))
    return "\n".join(lines)


def format_summary(spans, instants):
    def fmt_rows(d):
        rows = []
        for name, st in sorted(d.items(), key=lambda kv: -kv[1]["total_us"]):
            mean_ms = st["total_us"] / st["count"] / 1e3 if st["count"] else 0
            rows.append([name, st["count"],
                         "{:.3f}".format(st["total_us"] / 1e6),
                         "{:.2f}".format(mean_ms),
                         "{:.2f}".format(st["max_us"] / 1e3)])
        return rows

    out = []
    if spans:
        out.append("per-stage wall time:")
        out.append(_table(fmt_rows(rollup_stages(spans)),
                          ["stage", "spans", "total_s", "mean_ms", "max_ms"]))
        out.append("")
        out.append("per-span wall time:")
        out.append(_table(fmt_rows(spans),
                          ["span", "count", "total_s", "mean_ms", "max_ms"]))
    else:
        out.append("no complete span events found")
    if instants:
        out.append("")
        out.append("instant events:")
        out.append(_table(
            [[n, c] for n, c in sorted(instants.items(),
                                       key=lambda kv: -kv[1])],
            ["event", "count"]))
    return "\n".join(out)


def _trace_files_in(d):
    return [os.path.join(d, n) for n in sorted(os.listdir(d))
            if n.startswith("trace-") and n.endswith(".jsonl")]


def resolve_paths(args_paths):
    """Trace files named directly, found in the given dirs, and found in
    any per-host fleet spool (``<dir>/.telemetry/<holder>/``) below
    them — so `trace_summary <dataset_dir>` covers the whole fleet."""
    paths = []
    for p in args_paths:
        if os.path.isdir(p):
            paths.extend(_trace_files_in(p))
            tele = os.path.join(p, ".telemetry")
            if os.path.isdir(tele):
                for holder in sorted(os.listdir(tele)):
                    spool = os.path.join(tele, holder)
                    if os.path.isdir(spool):
                        paths.extend(_trace_files_in(spool))
        else:
            paths.append(p)
    return paths


def write_merged(dirs, out_path):
    """Merge every fleet spool under the given dataset dirs into one
    clock-aligned Chrome trace at ``out_path``."""
    from ..observability import fleet

    events, lanes = [], []
    for d in dirs:
        ev, ln = fleet.merge_traces(d)
        base = len(lanes)
        for rec in ev:
            if "pid" in rec:
                rec = dict(rec, pid=rec["pid"] + base)
            events.append(rec)
        lanes.extend((lane + base, holder, pid) for lane, holder, pid in ln)
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump(events, f)
    return events, lanes


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("paths", nargs="+",
                    help="metrics/dataset dir(s) and/or trace-*.jsonl "
                         "file(s)")
    ap.add_argument("--merge", default=None, metavar="OUT.json",
                    help="write one clock-aligned Chrome trace merging "
                         "every host spool under the given dir(s) "
                         "(requires dir arguments with .telemetry/)")
    args = ap.parse_args(argv)
    if args.merge:
        dirs = [p for p in args.paths if os.path.isdir(p)]
        if not dirs:
            print("--merge needs dataset dir argument(s) containing "
                  ".telemetry/", file=sys.stderr)
            return 1
        events, lanes = write_merged(dirs, args.merge)
        print("merged trace: {} ({} event(s) across {} lane(s): {})".format(
            args.merge, len(events), len(lanes),
            ", ".join("{} pid{}".format(h, p) for _, h, p in lanes)))
    paths = resolve_paths(args.paths)
    if not paths:
        print("no trace files found under {}".format(args.paths),
              file=sys.stderr)
        return 1
    spans, instants = collect(paths)
    print("{} trace file(s), {} span(s), {} instant event(s)".format(
        len(paths), sum(s["count"] for s in spans.values()),
        sum(instants.values())))
    print(format_summary(spans, instants))
    return 0


if __name__ == "__main__":
    sys.exit(main())
