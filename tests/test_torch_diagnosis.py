"""The port's diagnosis layer against lddl_tpu's, one counterpart per
series, alert-rule and status-tool test of ``tests/test_diagnosis.py``
(its attribution tests have their counterparts in
``tests/test_torch_attribution.py``): time-series sampling and windowed
rollups, torn-tail tolerance, series segments published by the
heartbeat and by SIGTERM, spool rotation and retention, the arm-time
snapshot stamp, the alert engine's threshold, rate and absence rules
with persisted state, the backend op-latency histogram, and
``pipeline_status --window --alerts``.

Pure functions (``window_rollup``, ``percentile_from_buckets``) run on
the same input in both packages. Stateful cases (the alert engine, the
status tool) run each package on its own copy of the same spool, since
each writes its alert state into the spool it reads; their results are
compared whole at a fixed ``now``, or, where a tool reads the wall
clock itself, with ``time.time`` pinned for the call.
"""

import json
import os
import shutil
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_fleet_common as fc  # noqa: E402
import golden_spool as gs  # noqa: E402

REF, PORT = fc.REF, fc.PORT
obs, fleet, series, alerts = PORT.obs, PORT.fleet, PORT.series, PORT.alerts
attribution = PORT.attribution


@pytest.fixture(autouse=True)
def clean_telemetry():
    fc.reset_both()
    yield
    fc.reset_both()


def _strip_clock(point):
    """A series point without its clock pair and pid (the fields two
    processes' samples of the same registry differ in)."""
    return {k: v for k, v in point.items()
            if k not in ("wall", "mono", "pid")}


# ------------------------------------------------------------ series core


def _sample_sequence(pkg):
    pkg.obs.inc("units_total", 3)
    pkg.obs.inc("stage_seconds_total", 0.5, stage="decode")
    pkg.obs.set_gauge("backlog_docs", 42.0)
    pkg.obs.observe("op_latency_seconds", 0.01)
    p1 = pkg.series.sample()
    pkg.obs.set_gauge("backlog_docs", 40.0)
    p2 = pkg.series.sample()
    pkg.obs.inc("units_total", 2)
    p3 = pkg.series.sample()
    return [p1, p2, p3]


def test_series_sample_diffs_and_key_roundtrip(tmp_path):
    os.environ["LDDL_TPU_METRICS_DIR"] = str(tmp_path)
    want = [_strip_clock(p) for p in _sample_sequence(REF)]
    p1, p2, p3 = _sample_sequence(PORT)
    assert [_strip_clock(p) for p in (p1, p2, p3)] == want
    assert p1["d"]["units_total"] == 3
    assert p1["d"]["stage_seconds_total{stage=decode}"] == 0.5
    assert p1["g"]["backlog_docs"] == 42.0
    assert p1["h"]["op_latency_seconds"]["n"] == 1
    # No movement: counters drop out of the next point entirely.
    assert "units_total" not in p2.get("d", {})
    assert p2["g"]["backlog_docs"] == 40.0
    assert p3["d"]["units_total"] == 2  # a delta, not cumulative
    for key in ("stage_seconds_total{stage=decode}", "plain"):
        assert series.split_key(key) == REF.series.split_key(key)
    assert series.split_key("stage_seconds_total{stage=decode}") == \
        ("stage_seconds_total", "stage=decode")
    assert series.split_key("plain") == ("plain", "")


def test_series_window_rollup_rates_gauges_histograms():
    now = 1000.0
    points = []
    for i in range(10):
        points.append({"wall": now - 90 + i * 10, "mono": i, "pid": 1,
                       "d": {"units_total": 5.0},
                       "g": {"backlog": 100.0 - i},
                       "h": {"lat": {"n": 2, "s": 0.2,
                                     "b": {"le_0.25": 2}}}})
    roll = series.window_rollup(points, 60.0, now=now)
    assert roll == REF.series.window_rollup(points, 60.0, now=now)
    assert roll["points"] == 7
    assert roll["rates"]["units_total"] == pytest.approx(35.0 / 60.0)
    g = roll["gauges"]["backlog"]
    assert g["last"] < g["first"] and g["trend"] < 0
    h = roll["histograms"]["lat"]
    assert h["count"] == 14 and h["mean"] == pytest.approx(0.1)
    assert h["p50"] == pytest.approx(0.25)
    empty = series.window_rollup(points, 60.0, now=now + 10_000)
    assert empty == REF.series.window_rollup(points, 60.0, now=now + 10_000)
    assert empty["points"] == 0 and empty["rates"] == {}
    # No ``now``: the window ends at the newest point, in both.
    assert series.window_rollup(points, 25.0) == \
        REF.series.window_rollup(points, 25.0)


def test_percentile_from_buckets():
    buckets = {"le_0.001": 10, "le_0.01": 80, "le_0.1": 10}
    for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
        assert series.percentile_from_buckets(buckets, q) == \
            REF.series.percentile_from_buckets(buckets, q)
    assert series.percentile_from_buckets(buckets, 0.5) == \
        pytest.approx(0.01)
    assert series.percentile_from_buckets(buckets, 0.99) == \
        pytest.approx(0.1)
    odd = {"le_0": 3, "le_2.0": 1, "weird": 2}
    assert series.percentile_from_buckets(odd, 0.9) == \
        REF.series.percentile_from_buckets(odd, 0.9)
    assert series.percentile_from_buckets({}, 0.5) is None


def test_series_torn_tail_is_end_of_stream(tmp_path):
    spool = tmp_path / ".telemetry" / "h1"
    spool.mkdir(parents=True)
    good = json.dumps({"wall": 1.0, "mono": 0.0, "pid": 7,
                       "d": {"units_total": 4.0}})
    (spool / "series-pid7.jsonl").write_text(good + "\n" + good[:11])
    got = series.read_series(str(tmp_path), "h1", warn=fc.quiet)
    assert got == REF.series.read_series(str(tmp_path), "h1", warn=fc.quiet)
    points, torn = got
    assert len(points) == 1 and torn == 1
    assert points[0]["d"]["units_total"] == 4.0


def test_series_flush_publishes_segments_via_heartbeat(tmp_path):
    root = str(tmp_path)
    spool = fleet.configure(root, holder_id="hostS", ttl=30, interval=3600)
    obs.inc("units_total", 9)
    fleet.heartbeat()
    files = [n for n in sorted(os.listdir(spool))
             if n.startswith(series.SEGMENT_PREFIX)]
    assert files, sorted(os.listdir(spool))
    points, torn = series.read_series(root, "hostS")
    assert (points, torn) == REF.series.read_series(root, "hostS")
    assert torn == 0
    assert sum(p.get("d", {}).get("units_total", 0) for p in points) == 9


# --------------------------------------------------- rotation + retention


def test_event_spool_rotation_reads_seamlessly(tmp_path):
    root = str(tmp_path)
    os.environ[fleet.ENV_ROTATE_BYTES] = "256"
    spool = fleet.configure(root, holder_id="rot", ttl=30, interval=3600)
    for i in range(40):
        fleet.record("unit.claimed", unit="g{}".format(i), epoch=0,
                     holder="rot")
        fleet.flush_events()
    names = sorted(os.listdir(spool))
    segs = [n for n in names if n.startswith("events-pid") and ".seg" in n]
    assert segs, names
    loaded = fleet.load_spool(root, "rot")
    assert loaded == REF.fleet.load_spool(root, "rot")
    kinds = [ev["kind"] for ev in loaded["events"]]
    assert kinds.count("unit.claimed") == 40
    units = [ev["args"]["unit"] for ev in loaded["events"]]
    assert units == ["g{}".format(i) for i in range(40)]


def test_gc_spool_bounds_size_and_age_keeps_live(tmp_path):
    root = str(tmp_path)
    os.environ[fleet.ENV_ROTATE_BYTES] = "256"
    spool = fleet.configure(root, holder_id="gc", ttl=30, interval=3600)
    for i in range(40):
        fleet.record("unit.claimed", unit="g{}".format(i), epoch=0,
                     holder="gc")
        fleet.flush_events()
    obs.inc("units_total", 1)
    fleet.heartbeat()
    segs = [n for n in sorted(os.listdir(spool)) if ".seg" in n]
    assert segs
    assert fleet.gc_spool(spool) == 0
    os.environ[fleet.ENV_RETAIN_BYTES] = "1"
    live = {os.path.basename(fleet._ev_segment["path"] or ""),
            os.path.basename(series._segment["path"] or "")}
    removed = fleet.gc_spool(spool)
    assert removed == len([n for n in segs if n not in live])
    left = sorted(os.listdir(spool))
    assert os.path.basename(fleet._ev_segment["path"]) in left
    assert any(n.startswith("snapshot-pid") for n in left)
    # A closed snapshot of ANOTHER pid ages out; our own never does.
    foreign = os.path.join(spool, "snapshot-pid99999.json")
    with open(foreign, "w") as f:
        json.dump({"holder": "gc", "pid": 99999, "closed": True}, f)
    os.environ[fleet.ENV_RETAIN_AGE_S] = "0"
    os.environ[fleet.ENV_RETAIN_BYTES] = str(1 << 30)
    assert fleet.gc_spool(spool, now=time.time() + 10.0) >= 1
    assert not os.path.exists(foreign)
    assert any(n.startswith("snapshot-pid{}".format(os.getpid()))
               for n in sorted(os.listdir(spool)))
    # What the port left, the reference's aggregate reads as the port's.
    fc.aggregate_both(root, now=time.time())


def test_arm_time_snapshot_stamps_before_first_heartbeat(tmp_path):
    root = str(tmp_path)
    spool = fleet.configure(root, holder_id="stamp", ttl=30, interval=3600)
    snaps = [n for n in sorted(os.listdir(spool))
             if n.startswith("snapshot-pid")]
    assert snaps, sorted(os.listdir(spool))
    snap = fleet._read_json(os.path.join(spool, snaps[0]))
    assert snap["closed"] is False and snap["started_wall"] is not None
    report = fc.aggregate_both(root, now=time.time() + 10_000.0)
    assert report["hosts"]["stamp"]["stalled"]


# ----------------------------------------------------------- inertness


@pytest.fixture(scope="module")
def ingested(tmp_path_factory):
    """One tiny dataset ingested by the port (byte-equal to the
    reference's, ``tests/test_torch_ingest.py``), shared by the loader
    case below."""
    from lddl_tpu_torch.ingest import ingest_once
    from lddl_tpu_torch.preprocess import BertPretrainConfig, get_tokenizer

    fc.scrub_env()
    td = tmp_path_factory.mktemp("tdiag")
    corpus = gs.build_corpus(str(td / "corpus"))
    vocab = gs.build_vocab(str(td))
    landing = str(td / "landing")
    os.makedirs(os.path.join(landing, "source"))
    shutil.copy(os.path.join(corpus, "source", "0.txt"),
                os.path.join(landing, "source", "0.txt"))
    root = str(td / "data")
    ingest_once(root, get_tokenizer(vocab_file=vocab), landing=landing,
                config=BertPretrainConfig(max_seq_length=32, masking=False),
                num_shards=4, seed=7, num_blocks=4)
    return root, vocab


def _batches(loader):
    return [{k: np.asarray(v) for k, v in b.items()} for b in loader]


def test_series_and_attribution_are_byte_inert(tmp_path, ingested):
    """Telemetry off vs armed (metrics + fleet + a tiny rotation bound,
    so series, attribution and spool rotation all run): the port's batch
    stream is identical, and equal to the reference loader's."""
    from lddl_tpu.loader import get_bert_pretrain_data_loader as ref_loader
    from lddl_tpu_torch.loader import get_bert_pretrain_data_loader

    root, vocab = ingested
    want = _batches(ref_loader(root, vocab_file=vocab, batch_size=8,
                               base_seed=5, log_level=50))
    off = _batches(get_bert_pretrain_data_loader(
        root, vocab_file=vocab, batch_size=8, base_seed=5))
    out = str(tmp_path / "armed")
    os.environ[fleet.ENV_ROTATE_BYTES] = "512"
    fleet.configure(out, holder_id="inert", ttl=30, interval=3600)
    on = _batches(get_bert_pretrain_data_loader(
        root, vocab_file=vocab, batch_size=8, base_seed=5))
    fleet.heartbeat(closed=True)
    assert len(off) == len(on) == len(want) and len(off) > 0
    for x, y, z in zip(off, on, want):
        assert sorted(x) == sorted(y) == sorted(z)
        for k in x:
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)
            np.testing.assert_array_equal(x[k], z[k], err_msg=k)
    points, _ = series.read_series(out, "inert")
    keys = {k for p in points for k in p.get("d", {})}
    assert any(k.startswith(attribution.STAGE_METRIC) for k in keys)
    fc.aggregate_both(out, now=time.time())


# ------------------------------------------------------------ alert rules


def _write_rules(path, rules):
    with open(path, "w") as f:
        json.dump({"rules": rules}, f)
    return path


def _mk_series(root, holder, points):
    d = os.path.join(root, ".telemetry", holder)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "series-pid1.jsonl"), "w") as f:
        for p in points:
            f.write(json.dumps(p) + "\n")


def _evaluate_both(base, rules, prepare=None, passes=((None, 0.0),),
                   warn=fc.quiet):
    """Run one engine per package, each on its own root under ``base``
    (``prepare(root)`` fills it), over the same sequence of
    ``(report, now)`` passes; the results must agree pass by pass.
    Returns the port's results and root."""
    results = {}
    for pkg in (REF, PORT):
        root = os.path.join(str(base), pkg.pkg)
        os.makedirs(root, exist_ok=True)
        if prepare is not None:
            prepare(root)
        eng = pkg.alerts.AlertEngine(rules, root)
        results[pkg.pkg] = (root, [eng.evaluate(report=r, now=now,
                                                warn=warn)
                                   for r, now in passes])
    assert results["lddl_tpu_torch"][1] == results["lddl_tpu"][1]
    root, res = results["lddl_tpu_torch"]
    return res, root


def test_alert_rules_validation(tmp_path):
    p = str(tmp_path / "r.json")
    for bad in (
            [{"type": "threshold", "metric": "m", "value": 1}],  # no name
            [{"name": "a", "type": "nope", "metric": "m", "value": 1}],
            [{"name": "a", "type": "threshold", "metric": "m", "op": "~",
              "value": 1}],
            [{"name": "a", "type": "threshold", "metric": "m"}],
            [{"name": "a", "type": "threshold", "metric": "m",
              "value": 1}] * 2,  # duplicate names
            [{"name": "a", "type": "threshold", "value": 1}],  # no metric
    ):
        _write_rules(p, bad)
        for pkg in (REF, PORT):
            with pytest.raises(ValueError):
                pkg.alerts.load_rules(p)
    _write_rules(p, [{"name": "ok", "metric": "m", "value": 5}])
    (rule,) = alerts.load_rules(p)
    assert [rule] == REF.alerts.load_rules(p)
    assert rule["type"] == "threshold" and rule["op"] == ">"
    toml = str(tmp_path / "r.toml")
    with open(toml, "w") as f:
        f.write('[[rules]]\nname = "t"\nmetric = "m"\nvalue = 2\n'
                'op = ">="\n')
    assert alerts.load_rules(toml) == REF.alerts.load_rules(toml)


def test_alert_threshold_fire_resolve_persists_state(tmp_path):
    rules = [{"name": "backlog", "type": "threshold",
              "metric": "totals.counters.backlog", "op": ">", "value": 10}]
    hot = {"totals": {"counters": {"backlog": 50}}, "hosts": {}}
    cold = {"totals": {"counters": {"backlog": 3}}, "hosts": {}}
    (res, res2), root = _evaluate_both(
        tmp_path, rules, passes=((hot, 100.0), (hot, 110.0)))
    assert res["firing"] == ["backlog"]
    assert [t["kind"] for t in res["transitions"]] == ["alert.fired"]
    assert res2["transitions"] == []
    assert res2["alerts"][0]["since_wall"] == 100.0
    # A NEW engine (the one-shot CLI pattern) sees the persisted state
    # and journals the resolve, in both packages' roots.
    out = {}
    for pkg in (REF, PORT):
        r = os.path.join(str(tmp_path), pkg.pkg)
        eng = pkg.alerts.AlertEngine(pkg.alerts.load_rules(_write_rules(
            os.path.join(r, "r.json"), rules)), r)
        out[pkg.pkg] = (eng.evaluate(report=cold, now=120.0),
                        pkg.alerts.read_alert_events(r))
    assert out["lddl_tpu_torch"][0] == out["lddl_tpu"][0]
    res3, (events, torn) = out["lddl_tpu_torch"]
    assert res3["firing"] == []
    assert [t["kind"] for t in res3["transitions"]] == ["alert.resolved"]
    assert torn == 0
    assert [(e["kind"], e["args"]) for e in events] == \
        [(e["kind"], e["args"]) for e in out["lddl_tpu"][1][0]]
    assert [(e["kind"], e["args"]["rule"]) for e in events] == \
        [("alert.fired", "backlog"), ("alert.resolved", "backlog")]
    with open(os.path.join(root, ".telemetry", "alerts-state.json")) as f:
        port_state = json.load(f)
    with open(os.path.join(str(tmp_path), "lddl_tpu", ".telemetry",
                           "alerts-state.json")) as f:
        assert port_state == json.load(f)


def test_alert_wildcard_report_path(tmp_path):
    rules = [{"name": "worst-beat", "type": "threshold",
              "metric": "hosts.*.heartbeat_age_s", "op": ">", "value": 60}]
    report = {"hosts": {"a": {"heartbeat_age_s": 5.0},
                        "b": {"heartbeat_age_s": 120.0}}}
    (res,), _ = _evaluate_both(tmp_path, rules, passes=((report, 0.0),))
    assert res["firing"] == ["worst-beat"]
    assert res["alerts"][0]["value"] == 120.0


def test_alert_rate_rule_windows(tmp_path):
    now = 1000.0

    def prepare(root):
        _mk_series(root, "h1", [
            {"wall": 950.0, "mono": 0, "pid": 1,
             "d": {"units_total": 10.0}},
            {"wall": 990.0, "mono": 1, "pid": 1,
             "d": {"units_total": 10.0}},
        ])

    report = {"hosts": {}, "totals": {"counters": {}}}
    fast = [{"name": "r", "type": "rate", "metric": "units_total",
             "window_s": 60, "op": ">", "value": 0.3}]
    (res,), _ = _evaluate_both(tmp_path / "fast", fast, prepare,
                               passes=((report, now),))
    assert res["firing"] == ["r"]  # 20 units / 40 s span = 0.5/s
    narrow = [{"name": "r", "type": "rate", "metric": "units_total",
               "window_s": 20, "op": ">", "value": 0.3}]
    (res,), _ = _evaluate_both(tmp_path / "narrow", narrow, prepare,
                               passes=((report, now),))
    assert res["alerts"][0]["value"] == pytest.approx(10.0)
    (res,), _ = _evaluate_both(tmp_path / "cold", fast, prepare,
                               passes=((report, now + 10_000),))
    assert res["firing"] == []


def test_alert_rate_tolerates_torn_series_tail(tmp_path):
    def prepare(root):
        d = os.path.join(root, ".telemetry", "h1")
        os.makedirs(d)
        line = json.dumps({"wall": 990.0, "mono": 0, "pid": 1,
                           "d": {"units_total": 30.0}})
        with open(os.path.join(d, "series-pid1.jsonl"), "w") as f:
            f.write(line + "\n" + line[:17])

    rules = [{"name": "r", "type": "rate", "metric": "units_total",
              "window_s": 60, "op": ">", "value": 0.1}]
    (res,), _ = _evaluate_both(tmp_path, rules, prepare,
                               passes=(({"hosts": {}}, 1000.0),))
    assert res["firing"] == ["r"]
    assert res["alerts"][0].get("error") is None


def test_alert_absence_fires_then_resolves(tmp_path):
    """The metric's appearance in a port-written holder snapshot resolves
    the absence rule, in both packages' engines."""
    rules = [{"name": "no-loader", "type": "absence",
              "metric": "loader_batches_total"}]
    report = {"hosts": {}}
    roots = {pkg.pkg: os.path.join(str(tmp_path), pkg.pkg)
             for pkg in (REF, PORT)}
    engines = {pkg.pkg: pkg.alerts.AlertEngine(rules, roots[pkg.pkg])
               for pkg in (REF, PORT)}
    first = {k: e.evaluate(report=report, now=100.0)
             for k, e in engines.items()}
    assert first["lddl_tpu_torch"] == first["lddl_tpu"]
    assert first["lddl_tpu_torch"]["firing"] == ["no-loader"]
    # A port spool carrying the metric, copied into the reference's root.
    fleet.configure(roots["lddl_tpu_torch"], holder_id="h1", ttl=30,
                    interval=3600)
    obs.inc("loader_batches_total", 5)
    fleet.heartbeat()
    fc.reset_both()
    shutil.copytree(os.path.join(roots["lddl_tpu_torch"], ".telemetry",
                                 "h1"),
                    os.path.join(roots["lddl_tpu"], ".telemetry", "h1"))
    second = {k: e.evaluate(report=report, now=110.0)
              for k, e in engines.items()}
    assert second["lddl_tpu_torch"] == second["lddl_tpu"]
    res = second["lddl_tpu_torch"]
    assert res["firing"] == []
    assert [t["kind"] for t in res["transitions"]] == ["alert.resolved"]
    # Windowed absence: no series point inside the window re-fires it.
    windowed = [{"name": "no-loader", "type": "absence",
                 "metric": "loader_batches_total", "window_s": 30}]
    later = time.time() + 10_000.0
    third = {pkg.pkg: pkg.alerts.AlertEngine(windowed, roots[pkg.pkg])
             .evaluate(report=report, now=later) for pkg in (REF, PORT)}
    assert third["lddl_tpu_torch"] == third["lddl_tpu"]
    assert third["lddl_tpu_torch"]["firing"] == ["no-loader"]


def test_alert_bad_metric_is_error_not_crash(tmp_path):
    rules = [{"name": "weird", "type": "threshold",
              "metric": "no.such.path", "op": ">", "value": 1}]
    (res,), _ = _evaluate_both(tmp_path, rules,
                               passes=(({"hosts": {}}, 0.0),))
    assert res["firing"] == [] and res["alerts"][0]["value"] is None


def test_alerts_fired_counter_increments(tmp_path):
    rules = [{"name": "hot", "type": "threshold",
              "metric": "totals.counters.x", "op": ">", "value": 1}]
    report = {"totals": {"counters": {"x": 5}}, "hosts": {}}
    os.environ["LDDL_TPU_METRICS_DIR"] = str(tmp_path / "m")
    _evaluate_both(tmp_path, rules, passes=((report, 0.0),))
    for pkg in (REF, PORT):
        snap = pkg.obs.registry().snapshot()
        assert snap[pkg.alerts.FIRED_COUNTER]["values"]["rule=hot"] == 1


# --------------------------------------------------- status CLI + rollup


def _status(tool, argv, capsys, monkeypatch, now):
    monkeypatch.setattr(time, "time", lambda: now)
    try:
        rc = tool.main(argv)
    finally:
        monkeypatch.undo()
    return rc, capsys.readouterr().out


def test_pipeline_status_window_alerts_and_backend(tmp_path, capsys,
                                                   monkeypatch):
    """One port-written spool, copied once per package: each package's
    status tool over its copy, with the same rules, the wall clock
    pinned and each analyzer's SARIF read from one directory holding the
    same artifact under both names, prints the same report (its
    ``static_analysis`` section included) and exits with the same
    code."""
    root = str(tmp_path / "spool")
    fleet.configure(root, holder_id="cli", ttl=30, interval=3600)
    obs.inc("elastic_units_completed_total", 4, phase="gather")
    stage = attribution.stage_counter()
    stage.inc(0.6, stage="shard_read")
    stage.inc(0.8, stage="batch_wait")
    stage.inc(0.2, stage="step_gap")
    fleet.heartbeat(closed=True)
    fc.reset_both()
    now = time.time() + 5.0
    tools = {"lddl_tpu": fc.ref_tool("pipeline_status"),
             "lddl_tpu_torch": fc.port_tool("pipeline_status")}
    roots = {}
    for name in tools:
        roots[name] = str(tmp_path / name)
        shutil.copytree(root, roots[name])
    sarif_dir = tmp_path / "sarif"
    sarif_dir.mkdir()
    sarif = {"version": "2.1.0", "runs": [{
        "tool": {"driver": {"name": "lddl-check", "rules": [
            {"id": "wall-clock"}, {"id": "global-rng"}]}},
        "results": [{"ruleId": "wall-clock",
                     "baselineState": "unchanged"}]}]}
    for name in ("lddl_check.sarif", "lddl_tpu_torch_check.sarif"):
        (sarif_dir / name).write_text(json.dumps(sarif))
    loaders = {name: tool.load_static_analysis
               for name, tool in tools.items()}

    def run_both(extra, rules=None, json_mode=True):
        outs = {}
        for name, tool in tools.items():
            argv = [roots[name]] + (["--json"] if json_mode else []) + extra
            if rules is not None:
                argv += ["--alerts", _write_rules(
                    os.path.join(roots[name], "rules.json"), rules)]
            monkeypatch.setattr(
                tool, "load_static_analysis",
                lambda _root, load=loaders[name]: load(str(sarif_dir)))
            rc, text = _status(tool, argv, capsys, monkeypatch, now)
            if json_mode:
                doc = json.loads(text.replace(roots[name], "ROOT"))
                assert doc["static_analysis"] == {
                    "new": 0, "baselined": 1, "by_rule": {"wall-clock": 1},
                    "rules_enabled": 2}
                outs[name] = (rc, doc)
            else:
                outs[name] = (rc, text.replace(roots[name], "ROOT"))
        assert outs["lddl_tpu_torch"] == outs["lddl_tpu"]
        return outs["lddl_tpu_torch"]

    trip = [{"name": "trip", "type": "threshold",
             "metric": "totals.counters.units_completed", "op": "<",
             "value": 100}]
    rc, doc = run_both(["--window", "120"], trip)
    assert rc == 2  # healthy, but the tripped alert forces exit 2
    assert doc["health"]["ok"]
    assert doc["alerts"]["firing"] == ["trip"]
    assert doc["attribution"]["verdict"] == "input-bound"
    assert any(k.startswith("backend_ops_total")
               for k in doc["window"]["rates"])
    assert doc["backend"]["ops"]
    assert any(lbl.startswith("backend=")
               for lbl in doc["backend"]["latency"])
    win = doc["hosts"]["cli"]["window"]
    assert win["rates"].get(
        "loader_stage_seconds_total{stage=shard_read}") == \
        pytest.approx(0.6 / win["span_s"])

    resolve = [dict(trip[0], value=0)]
    rc, doc = run_both([], resolve)
    assert rc == 0
    assert doc["alerts"]["firing"] == []
    events, _ = alerts.read_alert_events(roots["lddl_tpu_torch"])
    assert [e["kind"] for e in events] == ["alert.fired", "alert.resolved"]
    assert all("wall" in e and "mono" in e and "pid" in e for e in events)

    rc, text = run_both(["--window", "120"], json_mode=False)
    assert rc == 0
    assert "loader bound verdict: input-bound" in text
    assert "window: last 120s" in text
    assert ("static analysis: 0 new, 1 baselined finding(s); by rule: "
            "wall-clock=1") in text


def test_pipeline_status_help_names_the_left_out_line():
    """The static-analysis line the port's status tool once left out is
    back: its ``--help`` names the section and the port's own SARIF
    artifact, and no longer says the port has no analyzer."""
    tool = fc.port_tool("pipeline_status")
    help_text = tool.__doc__
    assert "static analysis" in help_text and "no analyzer" not in help_text
    assert "lddl_tpu_torch_check.sarif" in help_text
    assert "ci_check.sh --full" in help_text
    assert tool.load_static_analysis(str(fc.REPO_ROOT) + "/nowhere") is None


def test_backend_latency_histogram_from_io_ops(tmp_path):
    label_sets = {}
    for pkg in (REF, PORT):
        import importlib
        rio = importlib.import_module(pkg.pkg + ".resilience.io")
        os.environ["LDDL_TPU_METRICS_DIR"] = str(tmp_path / pkg.pkg)
        p = str(tmp_path / "{}.bin".format(pkg.pkg))
        rio.atomic_write(p, b"payload")
        assert rio.read_bytes(p) == b"payload"
        assert rio.list_dir(str(tmp_path)) is not None
        rio.remove(p)
        snap = pkg.obs.registry().snapshot()
        lat = snap["backend_op_latency_seconds"]
        assert lat["type"] == "histogram"
        ops = {lbl.split("op=")[1].split(",")[0] for lbl in lat["values"]}
        assert {"put", "get", "list", "delete"} <= ops
        for stats in lat["values"].values():
            assert stats["count"] >= 1 and stats["sum"] >= 0.0
        label_sets[pkg.pkg] = {lbl: st["count"]
                               for lbl, st in lat["values"].items()}
        fc.reset_both()
    assert label_sets["lddl_tpu_torch"] == label_sets["lddl_tpu"]


# ------------------------------------------------ SIGTERM series flushing

_SIGTERM_SERIES_PROBE = """
import os, sys, time
root = sys.argv[1]
os.environ["LDDL_TPU_FLEET_DIR"] = root
os.environ["LDDL_TPU_FLEET_HOLDER"] = "sender"
os.environ["LDDL_TPU_FLEET_INTERVAL_S"] = "3600"  # only exit paths flush
from lddl_tpu_torch.observability import attribution, fleet
import lddl_tpu_torch.observability as obs
fleet.ensure_started()
obs.inc("units_total", 7)
attribution.stage_counter().inc(0.25, stage="decode")
print("READY", flush=True)
time.sleep(120)
"""


def test_sigterm_flushes_series_segments(tmp_path):
    """Series history rides the same SIGTERM flush as the snapshot: with
    the heartbeat parked for an hour, only the handler can have
    published these points (read back by both packages)."""
    root = str(tmp_path)
    proc = subprocess.Popen(
        [sys.executable, "-c", _SIGTERM_SERIES_PROBE, root],
        env=fc.subprocess_env(), cwd=fc.REPO_ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        assert proc.stdout.readline().strip() == "READY"
        proc.send_signal(signal.SIGTERM)
        out = proc.communicate(timeout=60)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
    assert proc.returncode == -signal.SIGTERM, out
    points, torn = series.read_series(root, "sender")
    assert (points, torn) == REF.series.read_series(root, "sender")
    assert torn == 0
    deltas = {}
    for p in points:
        for k, v in p.get("d", {}).items():
            deltas[k] = deltas.get(k, 0.0) + v
    assert deltas.get("units_total") == 7
    assert deltas.get(
        attribution.STAGE_METRIC + "{stage=decode}") == pytest.approx(0.25)
