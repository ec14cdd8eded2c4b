"""The port's fleet telemetry (lddl_tpu_torch.observability.fleet and
lddl_tpu_torch.tools.pipeline_status / trace_summary) against
lddl_tpu's, one counterpart per test of ``tests/test_fleet.py``: spool
publishing, torn-tail tolerance, the cluster aggregate with its stall
and wedge verdicts, clock-aligned trace merging, the SIGTERM and SIGKILL
flush paths, and byte-inertness (a fleet-armed elastic run and a
fleet-armed ingest round are byte-equal to live ``lddl_tpu`` runs).

Every spool, whichever package wrote it, is aggregated by both packages
at a fixed ``now`` and the two reports are compared whole
(``_torch_fleet_common.aggregate_both``): a port-written spool is read
by the reference and a reference-written one by the port. Where a tool
reads the wall clock itself, ``time.time`` is pinned for the call, so
no field needs stripping; ``static_analysis`` is each package's own
analyzer verdict read from its own SARIF at the repo root, and it is
dropped by name before the comparison.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_fleet_common as fc  # noqa: E402
import golden_spool as gs  # noqa: E402

REF, PORT = fc.REF, fc.PORT
fleet = PORT.fleet
obs = PORT.obs


@pytest.fixture(autouse=True)
def clean_telemetry():
    fc.reset_both()
    yield
    fc.reset_both()


# ------------------------------------------------------------- publishing


def test_disabled_everything_is_noop(tmp_path):
    for pkg in (REF, PORT):
        f = pkg.fleet
        assert not f.enabled()
        f.record("unit.claimed", unit="u0", epoch=0)
        assert f.heartbeat() is None
        assert f.flush_events() is None
        f.ensure_started()
        assert f._hb["thread"] is None
    assert not os.path.isdir(str(tmp_path / ".telemetry"))


def test_spool_publish_and_roundtrip(tmp_path):
    root = str(tmp_path)
    spool = fleet.configure(root, holder_id="hostA", ttl=5, interval=60)
    assert spool == os.path.join(root, ".telemetry", "hostA")
    # configure() armed metrics into the spool (none were armed before).
    assert obs.metrics_dir() == spool
    fleet.record("unit.claimed", unit="group-1", epoch=0, holder="hostA")
    fleet.record("unit.journaled", unit="group-1", epoch=0, holder="hostA",
                 phase="gather")
    obs.inc("elastic_units_completed_total", 1, phase="gather")
    fleet.heartbeat()
    pid = os.getpid()
    path = os.path.join(spool, "events-pid{}.jsonl".format(pid))
    events, torn = fleet.read_jsonl(path)
    assert torn == 0
    assert [ev["kind"] for ev in events] == ["unit.claimed",
                                             "unit.journaled"]
    assert all("wall" in ev and "mono" in ev for ev in events)
    # The reference reads the port's spool files identically.
    assert REF.fleet.read_jsonl(path) == (events, torn)
    snap_path = os.path.join(spool, "snapshot-pid{}.json".format(pid))
    snap = fleet._read_json(snap_path)
    assert REF.fleet._read_json(snap_path) == snap
    assert snap["holder"] == "hostA" and snap["closed"] is False
    assert snap["ttl_s"] == 5.0
    assert "elastic_units_completed_total" in snap["metrics"]
    # Clean shutdown marks the snapshot closed.
    fleet.heartbeat(closed=True, reason="test")
    snap = fleet._read_json(snap_path)
    assert snap["closed"] is True and snap["closed_reason"] == "test"
    report = fc.aggregate_both(root, now=time.time())
    assert report["hosts"]["hostA"]["counters"]["units_completed"] == 1
    assert report["health"]["closed_hosts"] == ["hostA"]


def _publish(pkg, root, holder):
    """One package's publisher: configure, events, counters, a gauge, a
    histogram, a span, two heartbeats (the second closing the spool)."""
    spool = pkg.fleet.configure(root, holder_id=holder, ttl=5, interval=60)
    pkg.fleet.record("unit.claimed", unit="group-1", epoch=0, holder=holder)
    pkg.fleet.record("unit.stolen", unit="group-2", epoch=1, holder=holder,
                     prev_holder="other")
    pkg.obs.inc("elastic_units_completed_total", 3, phase="gather")
    pkg.obs.inc("lease_steals_total")
    pkg.obs.set_gauge("ingest_backlog_docs", 7)
    pkg.obs.observe("backend_op_latency_seconds", 0.004, backend="local",
                    op="put")
    with pkg.obs.span("preprocess.gather", holder=holder):
        pass
    pkg.fleet.heartbeat()
    pkg.fleet.record("unit.journaled", unit="group-1", epoch=0,
                     holder=holder, phase="gather")
    pkg.fleet.heartbeat(closed=True, reason="test")
    return spool


@pytest.mark.parametrize("writer", [REF, PORT], ids=["ref", "port"])
def test_spool_of_either_package_reads_equal_in_both(tmp_path, writer):
    """A spool the reference package published is aggregated, merged and
    read as series by the port exactly as by the reference, and a spool
    the port published by the reference: same files, same formats."""
    root = str(tmp_path)
    spool = _publish(writer, root, "writer")
    fc.reset_both()
    names = sorted(os.listdir(spool))
    for prefix in ("snapshot-pid", "events-pid", "series-pid", "metrics-",
                   "trace-"):
        assert any(n.startswith(prefix) for n in names), (prefix, names)
    report = fc.aggregate_both(root, now=time.time() + 1.0, window=600)
    host = report["hosts"]["writer"]
    assert host["closed"] and host["counters"]["units_completed"] == 3
    assert host["counters"]["steals"] == 1
    assert host["gauges"]["ingest_backlog_docs"] == 7
    assert host["event_counts"] == {"unit.claimed": 1, "unit.stolen": 1,
                                    "unit.journaled": 1}
    assert host["window"]["rates"]
    assert fleet.merge_traces(root) == REF.fleet.merge_traces(root)
    assert PORT.series.read_series(root, "writer") == \
        REF.series.read_series(root, "writer")


def test_env_only_arming_colocates_metrics(tmp_path):
    """Arming through ``LDDL_TPU_FLEET_DIR`` alone must still produce
    non-empty registry snapshots: the first record() points the metrics
    dir at the spool."""
    os.environ[fleet.ENV_FLEET_DIR] = str(tmp_path)
    os.environ[fleet.ENV_HOLDER] = "envhost"
    os.environ[fleet.ENV_INTERVAL] = "60"
    fleet.record("unit.claimed", unit="u0", epoch=0, holder="envhost")
    assert obs.metrics_dir() == fleet.spool_dir()
    obs.inc("elastic_units_completed_total", 1, phase="gather")
    fleet.heartbeat()
    report = fc.aggregate_both(str(tmp_path), now=time.time())
    assert report["hosts"]["envhost"]["counters"]["units_completed"] == 1


def test_read_jsonl_torn_tail_is_end_of_stream(tmp_path):
    p = str(tmp_path / "events.jsonl")
    with open(p, "w") as f:
        f.write(json.dumps({"kind": "a", "wall": 1.0}) + "\n")
        f.write(json.dumps({"kind": "b", "wall": 2.0}) + "\n")
        f.write('{"kind": "c", "wal')  # torn mid-append
    outs = []
    for pkg in (REF, PORT):
        warnings = []
        records, torn = pkg.fleet.read_jsonl(
            p, warn=lambda msg, *a: warnings.append(msg % a if a else msg))
        outs.append((records, torn, warnings))
    assert outs[0] == outs[1]
    records, torn, warnings = outs[1]
    assert [r["kind"] for r in records] == ["a", "b"]
    assert torn == 1
    assert any("end-of-stream" in w for w in warnings)
    # Torn INTERIOR line: skipped with a warning, the tail still parses.
    with open(p, "w") as f:
        f.write('{"kind": "a"\n')
        f.write(json.dumps({"kind": "b"}) + "\n")
        f.write(json.dumps({"kind": "c"}) + "\n")
    got = fleet.read_jsonl(p, warn=fc.quiet)
    assert got == REF.fleet.read_jsonl(p, warn=fc.quiet)
    assert [r["kind"] for r in got[0]] == ["b", "c"] and got[1] == 1


# ------------------------------------------------------------- aggregation


def test_aggregate_flags_dead_host_stalled(tmp_path):
    root = str(tmp_path)
    now = 10000.0
    fc.fake_spool(root, "h-live", 1, wall=now - 1.0, ttl=5.0,
                  counters={"elastic_units_completed_total": 10,
                            "lease_steals_total": 2},
                  events=[{"kind": "unit.journaled", "wall": now - 1.0,
                           "mono": 99.0, "pid": 1}])
    fc.fake_spool(root, "h-closed", 2, wall=now - 500.0, ttl=5.0,
                  closed=True, counters={"elastic_units_completed_total": 5})
    fc.fake_spool(root, "h-dead", 3, wall=now - 300.0, ttl=5.0,
                  counters={"elastic_units_completed_total": 9,
                            "lease_fence_rejects_total": 1},
                  events=[{"kind": "unit.claimed", "wall": now - 301.0,
                           "mono": 50.0, "pid": 3}],
                  torn_tail=True)
    report = fc.aggregate_both(root, now=now)
    health = report["health"]
    assert health["stalled_hosts"] == ["h-dead"]
    assert health["closed_hosts"] == ["h-closed"]
    assert health["live_hosts"] == ["h-live"]
    assert not health["ok"]
    assert any("h-dead" in v and "STALLED" in v for v in health["verdicts"])
    assert report["hosts"]["h-dead"]["counters"]["units_completed"] == 9
    assert report["hosts"]["h-dead"]["torn_lines"] == 1
    assert report["totals"]["counters"]["units_completed"] == 24
    assert report["totals"]["counters"]["steals"] == 2
    assert report["totals"]["counters"]["fence_rejects"] == 1


def test_wedge_requires_pending_work(tmp_path):
    root = str(tmp_path)
    now = 50000.0
    old_progress = [{"kind": "generation.committed", "wall": now - 10000.0,
                     "mono": 1.0, "pid": 7}]
    fc.fake_spool(root, "svc", 7, wall=now - 1.0, ttl=5.0,
                  events=old_progress)
    # No pending work: idle, not wedged.
    report = fc.aggregate_both(root, now=now, wedge_window=60.0)
    assert not report["health"]["wedged"] and report["health"]["ok"]
    # Pending work (a nonzero backlog gauge): wedged.
    fc.fake_spool(root, "svc", 7, wall=now - 1.0, ttl=5.0,
                  gauges={"ingest_backlog_docs": 12}, events=old_progress)
    report = fc.aggregate_both(root, now=now, wedge_window=60.0)
    assert report["health"]["wedged"] and not report["health"]["ok"]
    assert any("WEDGED" in v for v in report["health"]["verdicts"])
    # Fresh progress inside the window heals it.
    fc.fake_spool(root, "svc", 7, wall=now - 1.0, ttl=5.0,
                  gauges={"ingest_backlog_docs": 12},
                  events=[{"kind": "generation.committed",
                           "wall": now - 5.0, "mono": 2.0, "pid": 7}])
    report = fc.aggregate_both(root, now=now, wedge_window=60.0)
    assert not report["health"]["wedged"]


def test_wedge_no_progress_ever_counts_from_host_start(tmp_path):
    root = str(tmp_path)
    now = 90000.0
    fc.fake_spool(root, "svc", 7, wall=now - 1.0, ttl=5.0,
                  gauges={"ingest_backlog_docs": 3}, events=[],
                  started=now - 10.0)
    report = fc.aggregate_both(root, now=now, wedge_window=60.0)
    assert not report["health"]["wedged"], report["health"]["verdicts"]
    fc.fake_spool(root, "svc", 7, wall=now - 1.0, ttl=5.0,
                  gauges={"ingest_backlog_docs": 3}, events=[],
                  started=now - 500.0)
    report = fc.aggregate_both(root, now=now, wedge_window=60.0)
    assert report["health"]["wedged"]


@pytest.mark.parametrize("pkg", [REF, PORT], ids=["ref", "port"])
def test_cli_auto_holder_names_spool_and_leases_identically(tmp_path, pkg):
    """``--fleet-telemetry`` on an elastic run without
    ``--elastic-host-id`` pins ONE auto-generated lease holder into the
    args, so the spool and the lease files share a name, in both
    packages."""
    import importlib
    common = importlib.import_module(pkg.pkg + ".cli.common")
    cli = importlib.import_module(pkg.pkg + ".cli.preprocess_bert_pretrain")
    args = cli.attach_args().parse_args(
        ["--wikipedia", "c", "--sink", str(tmp_path / "sink"),
         "--vocab-file", "v", "--elastic", "--fleet-telemetry"])
    assert args.elastic_host_id is None
    common.arm_fleet_if_requested(args, args.sink)
    assert args.elastic_host_id is not None
    assert pkg.fleet.holder() == args.elastic_host_id
    assert common.elastic_kwargs_of(args)["holder_id"] \
        == args.elastic_host_id
    assert pkg.fleet.spool_dir() == os.path.join(
        str(tmp_path / "sink"), ".telemetry", args.elastic_host_id)


def _status_json(tool, argv, capsys, monkeypatch, now):
    """One ``--json`` run of a status tool with the wall clock pinned."""
    monkeypatch.setattr(time, "time", lambda: now)
    try:
        rc = tool.main(argv)
    finally:
        monkeypatch.undo()
    doc = json.loads(capsys.readouterr().out)
    doc.pop("static_analysis", None)  # each package's own SARIF
    return rc, doc


def test_pipeline_status_cli_exit_codes_and_json(tmp_path, capsys,
                                                 monkeypatch):
    ref_tool, port_tool = fc.ref_tool("pipeline_status"), fc.port_tool(
        "pipeline_status")
    root = str(tmp_path)
    now = time.time()
    fc.fake_spool(root, "h-ok", 1, wall=now, closed=True,
                  counters={"elastic_units_completed_total": 3})
    rc, report = _status_json(port_tool, [root, "--json"], capsys,
                              monkeypatch, now)
    assert (rc, report) == _status_json(ref_tool, [root, "--json"], capsys,
                                        monkeypatch, now)
    assert rc == 0 and report["health"]["ok"]
    assert report["hosts"]["h-ok"]["counters"]["units_completed"] == 3
    # A stalled host flips the exit code to 2 in text mode too.
    fc.fake_spool(root, "h-dead", 2, wall=now - 900.0, ttl=5.0,
                  counters={"elastic_units_completed_total": 1})
    texts = []
    for tool in (ref_tool, port_tool):
        monkeypatch.setattr(time, "time", lambda: now)
        # Each package's SARIF at the repo root comes and goes with other
        # tests' ci_check runs: the text compared here leaves it out.
        monkeypatch.setattr(tool, "load_static_analysis", lambda _r: None)
        try:
            assert tool.main([root]) == 2
        finally:
            monkeypatch.undo()
        texts.append(capsys.readouterr().out)
    assert texts[0] == texts[1]
    out = texts[1]
    assert "UNHEALTHY" in out and "STALLED" in out and "h-dead" in out


# ------------------------------------------------------------ trace merge


def test_clock_step_correction_unit():
    for f in (REF.fleet, PORT.fleet):
        assert f._step_corrections([(0.0, 2000.0), (10.0, 2010.0)]) == []
        segs = f._step_corrections([(0.0, 2000.0), (10.0, 2110.0)])
        assert segs == [(2110.0, pytest.approx(100.0))]
        assert f._corrected_ts(2115.0 * 1e6, segs) == \
            pytest.approx(2015.0 * 1e6)
        assert f._corrected_ts(2005.0 * 1e6, segs) == \
            pytest.approx(2005.0 * 1e6)
    samples = [(0.0, 2000.0), (3.0, 2003.2), (10.0, 2110.0), (11.0, 2105.0),
               (12.0, 2106.1)]
    segs = PORT.fleet._step_corrections(samples)
    assert segs == REF.fleet._step_corrections(samples)
    for ts in (2001.0, 2108.0, 2111.0):
        assert PORT.fleet._corrected_ts(ts * 1e6, segs) == \
            REF.fleet._corrected_ts(ts * 1e6, segs)


def test_merge_traces_spans_hosts_with_alignment(tmp_path):
    root = str(tmp_path)
    fc.fake_spool(root, "hostA", 1, wall=3000.0,
                  events=[{"kind": "clock", "wall": 1000.0, "mono": 0.0,
                           "pid": 1},
                          {"kind": "clock", "wall": 1010.0, "mono": 10.0,
                           "pid": 1}])
    fc.write_trace(root, "hostA", 1, [
        {"name": "process_name", "ph": "M", "pid": 1,
         "args": {"name": "rank0 pid1"}},
        {"name": "preprocess.gather", "ph": "X", "ts": 1005.0 * 1e6,
         "dur": 5e6, "pid": 1, "tid": 1},
    ])
    # hostB: wall clock stepped +100 s mid-run; pid collides with hostA's.
    fc.fake_spool(root, "hostB", 1, wall=4000.0,
                  events=[{"kind": "clock", "wall": 2000.0, "mono": 0.0,
                           "pid": 1},
                          {"kind": "clock", "wall": 2110.0, "mono": 10.0,
                           "pid": 1}])
    fc.write_trace(root, "hostB", 1, [
        {"name": "preprocess.gather", "ph": "X", "ts": 2115.0 * 1e6,
         "dur": 5e6, "pid": 1, "tid": 1},
    ])
    events, lanes = fleet.merge_traces(root, warn=fc.quiet)
    assert (events, lanes) == REF.fleet.merge_traces(root, warn=fc.quiet)
    assert [(h, p) for _, h, p in lanes] == [("hostA", 1), ("hostB", 1)]
    names, spans = {}, []
    for ev in events:
        if ev["ph"] == "M" and ev["name"] == "process_name":
            names[ev["pid"]] = ev["args"]["name"]
        elif ev["ph"] == "X":
            spans.append(ev)
    assert sorted(names.values()) == ["hostA pid1", "hostB pid1"]
    assert len({ev["pid"] for ev in spans}) == 2
    by_lane = {names[ev["pid"]]: ev for ev in spans}
    assert by_lane["hostB pid1"]["ts"] == pytest.approx(2015.0 * 1e6)
    assert by_lane["hostA pid1"]["ts"] == pytest.approx(1005.0 * 1e6)


def test_trace_summary_merge_cli(tmp_path, capsys):
    root = str(tmp_path / "data")
    fc.fake_spool(root, "hostA", 1, wall=3000.0)
    fc.write_trace(root, "hostA", 1, [
        {"name": "preprocess.gather", "ph": "X", "ts": 1e9, "dur": 1e6,
         "pid": 1, "tid": 1}])
    fc.fake_spool(root, "hostB", 2, wall=3000.0)
    fc.write_trace(root, "hostB", 2, [
        {"name": "balance.run", "ph": "X", "ts": 2e9, "dur": 1e6,
         "pid": 2, "tid": 1}])
    merged, texts = [], []
    for name, tool in (("ref", fc.ref_tool("trace_summary")),
                       ("port", fc.port_tool("trace_summary"))):
        out_path = str(tmp_path / "merged-{}.json".format(name))
        assert tool.main([root, "--merge", out_path]) == 0
        texts.append(capsys.readouterr().out.replace(out_path, "OUT"))
        with open(out_path) as f:
            merged.append(json.load(f))
    assert merged[0] == merged[1] and texts[0] == texts[1]
    assert "preprocess" in texts[1] and "balance" in texts[1]
    lanes = {ev["args"]["name"] for ev in merged[1]
             if ev.get("ph") == "M" and ev.get("name") == "process_name"}
    assert lanes == {"hostA pid1", "hostB pid2"}


# ------------------------------------------------- abnormal-exit flushing

_SIGTERM_PROBE = """
import os, sys, time
root = sys.argv[1]
os.environ["LDDL_TPU_FLEET_DIR"] = root
os.environ["LDDL_TPU_FLEET_HOLDER"] = "polite"
os.environ["LDDL_TPU_FLEET_INTERVAL_S"] = "3600"  # only exit paths flush
from lddl_tpu_torch.observability import fleet
fleet.ensure_started()
fleet.record("unit.claimed", unit="group-0", epoch=0, holder="polite")
print("READY", flush=True)
time.sleep(120)
"""

_SIGKILL_PROBE = """
import os, sys, time
root = sys.argv[1]
from lddl_tpu_torch.observability import fleet
import lddl_tpu_torch.observability as obs
fleet.configure(root, holder_id="victim", ttl=2, interval=0.05)
i = 0
while True:
    fleet.record("unit.claimed", unit="g%d" % i, epoch=0, holder="victim")
    obs.inc("elastic_units_completed_total", 1, phase="gather")
    fleet.record("unit.journaled", unit="g%d" % i, epoch=0,
                 holder="victim")
    i += 1
    time.sleep(0.01)
"""

_SIGIGN_PROBE = """
import os, signal, sys, time
signal.signal(signal.SIGTERM, signal.SIG_IGN)  # the app ignores TERM
root = sys.argv[1]
os.environ["LDDL_TPU_FLEET_DIR"] = root
os.environ["LDDL_TPU_FLEET_HOLDER"] = "ignorer"
os.environ["LDDL_TPU_FLEET_INTERVAL_S"] = "3600"
from lddl_tpu_torch.observability import fleet
fleet.ensure_started()
fleet.record("unit.claimed", unit="g0", epoch=0, holder="ignorer")
print("READY", flush=True)
time.sleep(2.0)
print("SURVIVED", flush=True)
"""


def _spawn(probe, root):
    return subprocess.Popen([sys.executable, "-c", probe, root],
                            env=fc.subprocess_env(), cwd=fc.REPO_ROOT,
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def test_sigterm_flushes_events_and_marks_closed(tmp_path):
    """A politely killed host (TERM) leaves a fully flushed spool with a
    clean-shutdown marker: the heartbeat interval is far past the test,
    so only the signal handler can have written these bytes."""
    root = str(tmp_path)
    proc = _spawn(_SIGTERM_PROBE, root)
    try:
        assert proc.stdout.readline().strip() == "READY"
        proc.send_signal(signal.SIGTERM)
        out = proc.communicate(timeout=60)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
    assert proc.returncode == -signal.SIGTERM, out
    spool = os.path.join(root, ".telemetry", "polite")
    events_files = [n for n in sorted(os.listdir(spool))
                    if n.startswith("events-pid")]
    assert events_files, sorted(os.listdir(spool))
    records, torn = fleet.read_jsonl(os.path.join(spool, events_files[0]))
    assert torn == 0
    assert [r["kind"] for r in records] == ["unit.claimed"]
    snaps = [n for n in sorted(os.listdir(spool))
             if n.startswith("snapshot-pid")]
    snap = fleet._read_json(os.path.join(spool, snaps[0]))
    assert snap["closed"] is True and snap["closed_reason"] == "sigterm"
    # Closed hosts are never stall-flagged, however old the beat.
    report = fc.aggregate_both(root, now=time.time() + 10000.0)
    assert report["health"]["stalled_hosts"] == []
    assert report["health"]["closed_hosts"] == ["polite"]


def test_sigterm_flush_preserves_sig_ign(tmp_path):
    root = str(tmp_path)
    proc = _spawn(_SIGIGN_PROBE, root)
    try:
        assert proc.stdout.readline().strip() == "READY"
        proc.send_signal(signal.SIGTERM)
        out = proc.communicate(timeout=60)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
    assert proc.returncode == 0, out
    assert "SURVIVED" in out
    spool = os.path.join(root, ".telemetry", "ignorer")
    events_files = [n for n in sorted(os.listdir(spool))
                    if n.startswith("events-pid")]
    records, _ = fleet.read_jsonl(os.path.join(spool, events_files[0]))
    assert any(r["kind"] == "unit.claimed" for r in records)
    fc.aggregate_both(root, now=time.time())


def test_sigkill_leaves_parseable_spool_and_stall_verdict(tmp_path):
    """A SIGKILLed host can flush nothing at death; the heartbeat trail it
    left must still aggregate (in both packages, to equal reports) into
    a report that flags it stalled and keeps its counters."""
    root = str(tmp_path)
    proc = _spawn(_SIGKILL_PROBE, root)
    spool = os.path.join(root, ".telemetry", "victim")
    target = os.path.join(spool, "snapshot-pid{}.json".format(proc.pid))
    try:
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline:
            snap = fleet._read_json(target, warn=fc.quiet) \
                if os.path.exists(target) else None
            if snap and fleet._counter_total(
                    snap.get("metrics"),
                    "elastic_units_completed_total") >= 5:
                break
            time.sleep(0.02)
    finally:
        proc.kill()
        proc.communicate(timeout=60)
    assert proc.returncode == -signal.SIGKILL
    report = fc.aggregate_both(root, now=time.time() + 60.0)
    host = report["hosts"]["victim"]
    assert not host["closed"]
    assert report["health"]["stalled_hosts"] == ["victim"]
    assert host["counters"]["units_completed"] >= 5
    assert host["event_counts"].get("unit.claimed", 0) >= 1


# ----------------------------------------------- byte-inertness (elastic)


@pytest.fixture(scope="module")
def fixture_dirs(tmp_path_factory):
    td = tmp_path_factory.mktemp("tfleet")
    corpus = gs.build_corpus(str(td / "corpus"))
    vocab = gs.build_vocab(str(td))
    return str(td), corpus, vocab


_RUN_KW = dict(num_blocks=12, sample_ratio=0.9, seed=4242,
               global_shuffle=True, progress_interval=0.0)


def _bert_processor(pkg, vocab, out_dir):
    import importlib
    pre = importlib.import_module(pkg + ".preprocess")
    runner = importlib.import_module(pkg + ".preprocess.runner")
    kw = dict(max_seq_length=32, masking=True, schema_version=1)
    return runner.BertBucketProcessor(
        pre.get_tokenizer(vocab_file=vocab), pre.BertPretrainConfig(**kw),
        4242, out_dir, 8, "parquet")


def _tree_bytes(root):
    out = {}
    for base, dirs, files in os.walk(root):
        dirs[:] = sorted(d for d in dirs if d != ".telemetry")
        for name in sorted(files):
            p = os.path.join(base, name)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def test_two_host_elastic_with_fleet_is_byte_inert_and_aggregates(
        fixture_dirs, tmp_path, capsys):
    """Two elastic thread-hosts with fleet telemetry armed write shards
    and a manifest byte-equal to a live static ``lddl_tpu`` run of the
    plan, while the spool aggregates (in both packages, to equal
    reports) to the run's journaled ground truth (24 units) and the
    merged trace carries the stage spans."""
    from lddl_tpu.preprocess.runner import \
        run_sharded_pipeline as ref_pipeline
    from lddl_tpu_torch.preprocess.runner import run_sharded_pipeline

    td, corpus, vocab = fixture_dirs
    ref = str(tmp_path / "ref")
    ref_pipeline({"wikipedia": corpus}, ref,
                 _bert_processor("lddl_tpu", vocab, ref), **_RUN_KW)

    out = str(tmp_path / "out")
    fleet.configure(out, holder_id="fleethost", ttl=5.0, interval=60)
    procs = {h: _bert_processor("lddl_tpu_torch", vocab, out)
             for h in ("hostA", "hostB")}
    results, errors = {}, {}

    def host(hid, delay):
        time.sleep(delay)
        try:
            results[hid] = run_sharded_pipeline(
                {"wikipedia": corpus}, out, procs[hid], elastic=True,
                lease_ttl=5.0, holder_id=hid, **_RUN_KW)
        except Exception as e:  # noqa: BLE001 - surfaced via assert
            errors[hid] = e

    threads = [threading.Thread(target=host, args=("hostA", 0.0)),
               threading.Thread(target=host, args=("hostB", 0.1))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    assert _tree_bytes(out) == _tree_bytes(ref)
    fleet.heartbeat(closed=True, reason="test")
    report = fc.aggregate_both(out, now=time.time())
    assert report["totals"]["counters"]["units_completed"] == 24
    counts = report["hosts"]["fleethost"]["event_counts"]
    assert counts.get("unit.journaled") == 24
    assert counts.get("unit.claimed", 0) >= 24
    assert report["health"]["ok"], report["health"]["verdicts"]

    tool = fc.port_tool("pipeline_status")
    assert tool.main([out, "--json"]) == 0
    cli_report = json.loads(capsys.readouterr().out)
    assert cli_report["totals"]["counters"]["units_completed"] == 24

    events, lanes = fleet.merge_traces(out)
    assert (events, lanes) == REF.fleet.merge_traces(out)
    span_names = {ev.get("name") for ev in events if ev.get("ph") == "X"}
    assert {"preprocess.run", "preprocess.gather",
            "preprocess.finalize"} <= span_names
    assert lanes and lanes[0][1] == "fleethost"


# --------------------------------------------- byte-inertness (ingest)


def test_ingest_with_fleet_is_byte_inert_and_logs_lifecycle(
        fixture_dirs, tmp_path):
    """A fleet-armed port ingest round leaves the generation tree (shards,
    manifests, journal) byte-equal to a live telemetry-off ``lddl_tpu``
    round, its loader serves the reference's batches, and the spool
    carries the generation lifecycle (intake -> preprocess ->
    delta-balance -> gate-advance -> committed)."""
    import shutil

    from lddl_tpu import ingest as ref_ingest
    from lddl_tpu import loader as ref_loader
    from lddl_tpu import preprocess as ref_pre
    from lddl_tpu_torch import ingest as port_ingest
    from lddl_tpu_torch import loader as port_loader
    from lddl_tpu_torch import preprocess as port_pre

    td, corpus, vocab = fixture_dirs
    landing = str(tmp_path / "landing")
    os.makedirs(os.path.join(landing, "source"))
    shutil.copy(os.path.join(corpus, "source", "0.txt"),
                os.path.join(landing, "source", "0.txt"))
    kw = dict(num_shards=4, seed=7, num_blocks=4)

    root_ref = str(tmp_path / "ref")
    ref_ingest.ingest_once(
        root_ref, ref_pre.get_tokenizer(vocab_file=vocab), landing=landing,
        config=ref_pre.BertPretrainConfig(max_seq_length=32, masking=False),
        **kw)

    # The reference's loader reads the same environment: it runs before
    # the port's fleet is armed.
    a = [{k: np.asarray(v) for k, v in b.items()}
         for b in ref_loader.get_bert_pretrain_data_loader(
             root_ref, vocab_file=vocab, batch_size=8, base_seed=5,
             log_level=50)]

    root_on = str(tmp_path / "on")
    fleet.configure(root_on, holder_id="svc", ttl=5.0, interval=60)
    port_ingest.ingest_once(
        root_on, port_pre.get_tokenizer(vocab_file=vocab), landing=landing,
        config=port_pre.BertPretrainConfig(max_seq_length=32,
                                           masking=False), **kw)
    fleet.heartbeat(closed=True)

    want, got = _tree_bytes(root_ref), _tree_bytes(root_on)
    assert sorted(got) == sorted(want)
    for rel in want:
        assert got[rel] == want[rel], rel

    b = [{k: np.asarray(v) for k, v in b.items()}
         for b in port_loader.get_bert_pretrain_data_loader(
             root_on, vocab_file=vocab, batch_size=8, base_seed=5,
             follow_generations=True)]
    assert len(a) == len(b) and len(a) > 0
    for x, y in zip(a, b):
        assert sorted(x) == sorted(y)
        for k in x:
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)

    report = fc.aggregate_both(root_on, now=time.time())
    counts = report["hosts"]["svc"]["event_counts"]
    for kind in ("generation.intake", "generation.preprocess",
                 "generation.delta_balance", "generation.gate_advance",
                 "generation.committed"):
        assert counts.get(kind, 0) >= 1, (kind, counts)
    assert report["health"]["ok"], report["health"]["verdicts"]
