"""The port's telemetry-driven autoscaler
(lddl_tpu_torch.observability.autoscale) against lddl_tpu's, one
counterpart per test of ``tests/test_autoscale.py`` (its analyzer test,
``test_autoscale_not_wall_clock_allowlisted``, waits for the port's
analyzer): the decision policy over the reference tests' synthetic
aggregate reports, with both packages' autoscalers fed the same report
sequence and their spawn and retire sequences, decisions and
observations compared; journaling into the fleet event log; and a step
over a real published spool.
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_fleet_common as fc  # noqa: E402

REF, PORT = fc.REF, fc.PORT


@pytest.fixture(autouse=True)
def clean_telemetry():
    fc.reset_both()
    yield
    fc.reset_both()


def _report(backlog=0, wedged=False, pending=None, extra_hosts=()):
    hosts = {"h0": {"gauges": {"ingest_backlog_docs": backlog}}}
    for name, b in extra_hosts:
        hosts[name] = {"gauges": {"ingest_backlog_docs": b}}
    return {"hosts": hosts, "health": {"wedged": wedged},
            "pending_work": pending}


class _Fleet:
    """Recording spawn/retire callables; handles are increasing ints."""

    def __init__(self):
        self.spawned, self.retired = [], []

    def spawn(self):
        h = len(self.spawned)
        self.spawned.append(h)
        return h

    def retire(self, h):
        self.retired.append(h)


class _Pair:
    """The same autoscaler settings in both packages, observed in step:
    every observation must agree, and so must the spawn/retire record."""

    def __init__(self, **kw):
        kw.setdefault("backlog_slo_docs", 100)
        kw.setdefault("max_helpers", 2)
        kw.setdefault("drain_rounds", 2)
        self.fleets = {}
        self.scalers = {}
        for pkg in (REF, PORT):
            fl = _Fleet()
            self.fleets[pkg.pkg] = fl
            self.scalers[pkg.pkg] = pkg.autoscale.Autoscaler(
                "/nowhere", fl.spawn, fl.retire, **kw)
        self.fl = self.fleets["lddl_tpu_torch"]
        self.a = self.scalers["lddl_tpu_torch"]

    def _agree(self):
        ref, port = self.scalers["lddl_tpu"], self.a
        assert port.decisions == ref.decisions
        assert port.helper_count == ref.helper_count
        rf, pf = self.fleets["lddl_tpu"], self.fl
        assert (pf.spawned, pf.retired) == (rf.spawned, rf.retired)

    def observe(self, report):
        want = self.scalers["lddl_tpu"].observe(report)
        got = self.a.observe(report)
        assert got == want
        self._agree()
        return got

    def shutdown(self):
        self.scalers["lddl_tpu"].shutdown()
        self.a.shutdown()
        self._agree()


# ------------------------------------------------------------------ policy


def test_backlog_of_takes_fleet_max():
    rep = _report(backlog=5, extra_hosts=(("h1", 40), ("h2", 7)))
    for pkg in (REF, PORT):
        backlog_of = pkg.autoscale.backlog_of
        assert backlog_of(rep) == 40
        assert backlog_of({"hosts": {"h0": {"gauges": {}}}}) == 0
        assert backlog_of({}) == 0


def test_scale_up_on_backlog_until_ceiling():
    p = _Pair()
    assert p.observe(_report(backlog=500))["decision"] == "scale_up"
    assert p.observe(_report(backlog=500))["decision"] == "scale_up"
    # Ceiling: still hot, but max_helpers run already.
    assert p.observe(_report(backlog=500))["decision"] is None
    assert p.a.helper_count == 2 and p.fl.spawned == [0, 1]


def test_scale_up_on_wedge_without_backlog():
    p = _Pair()
    ob = p.observe(_report(backlog=0, wedged=True))
    assert ob["decision"] == "scale_up"
    assert p.a.decisions[-1] == ("scale_up", "wedged")


def test_scale_down_needs_consecutive_calm_rounds():
    p = _Pair(drain_rounds=3)
    p.observe(_report(backlog=500))
    assert p.a.helper_count == 1
    # calm, calm, NOT calm (pending work): the calm streak resets.
    assert p.observe(_report())["decision"] is None
    assert p.observe(_report())["decision"] is None
    assert p.observe(_report(pending="delta preprocess"))["decision"] is None
    assert p.observe(_report())["decision"] is None
    assert p.observe(_report())["decision"] is None
    assert p.observe(_report())["decision"] == "scale_down"
    assert p.a.helper_count == 0 and p.fl.retired == [0]


def test_scale_down_floor_and_lifo_retirement():
    p = _Pair(min_helpers=1, drain_rounds=1)
    p.observe(_report(backlog=500))
    p.observe(_report(backlog=500))
    assert p.a.helper_count == 2
    assert p.observe(_report())["decision"] == "scale_down"
    assert p.fl.retired == [1]  # the most recent helper leaves first
    # Floor: min_helpers stays running however calm it gets.
    assert p.observe(_report())["decision"] is None
    assert p.a.helper_count == 1


def test_shutdown_retires_everything():
    p = _Pair()
    p.observe(_report(backlog=500))
    p.observe(_report(backlog=500))
    p.shutdown()
    assert p.a.helper_count == 0
    assert p.fl.retired == [1, 0]
    assert [d for d in p.a.decisions if d[0] == "scale_down"] == \
        [("scale_down", "service shutdown")] * 2


def test_constructor_validation():
    fl = _Fleet()
    for pkg in (REF, PORT):
        Autoscaler = pkg.autoscale.Autoscaler
        with pytest.raises(ValueError, match="backlog_slo_docs"):
            Autoscaler("/x", fl.spawn, fl.retire, backlog_slo_docs=0,
                       max_helpers=1)
        with pytest.raises(ValueError, match="min_helpers"):
            Autoscaler("/x", fl.spawn, fl.retire, backlog_slo_docs=1,
                       max_helpers=1, min_helpers=2)


# ------------------------------------------------------------- journaling


def _journal(pkg, root):
    spool = pkg.fleet.configure(root, holder_id="ctrl", ttl=5, interval=60)
    fl = _Fleet()
    a = pkg.autoscale.Autoscaler(root, fl.spawn, fl.retire,
                                 backlog_slo_docs=100, max_helpers=2,
                                 drain_rounds=1)
    a.observe(_report(backlog=500))
    a.observe(_report())
    pkg.fleet.flush_events()
    events, torn = pkg.fleet.read_jsonl(os.path.join(
        spool, "events-pid{}.jsonl".format(os.getpid())))
    c = pkg.obs.registry().counter("autoscale_decisions_total")
    counts = (c.value(action="scale_up"), c.value(action="scale_down"))
    return events, torn, counts


def test_decisions_are_journaled_as_fleet_events(tmp_path):
    """Both packages journal the same decisions with the same arguments
    (each armed in turn, in its own spool)."""
    want = _journal(REF, str(tmp_path / "ref"))
    fc.reset_both()
    events, torn, counts = _journal(PORT, str(tmp_path / "port"))
    assert torn == 0 == want[1]
    assert counts == want[2] == (1, 1)
    assert [(e["kind"], e["args"]) for e in events] == \
        [(e["kind"], e["args"]) for e in want[0]]
    kinds = [ev["kind"] for ev in events]
    assert "autoscale.scale_up" in kinds and "autoscale.scale_down" in kinds
    up = events[kinds.index("autoscale.scale_up")]["args"]
    assert up["backlog_docs"] == 500 and up["slo_docs"] == 100


def test_step_reads_real_aggregate(tmp_path):
    """End to end through ``fleet.aggregate``: a backlog gauge published
    in a port spool drives a real scale-up, in the port's autoscaler and
    in the reference's reading the same spool."""
    root = str(tmp_path)
    PORT.fleet.configure(root, holder_id="svc", ttl=5, interval=60)
    PORT.obs.set_gauge("ingest_backlog_docs", 900)
    PORT.fleet.heartbeat()
    # Disarm before stepping: an armed reference scale-up would journal
    # into the same spool under this pid's snapshot name.
    fc.scrub_env()
    obs_by_pkg = {}
    for pkg in (REF, PORT):
        fl = _Fleet()
        a = pkg.autoscale.Autoscaler(root, fl.spawn, fl.retire,
                                     backlog_slo_docs=100, max_helpers=2,
                                     drain_rounds=2)
        obs_by_pkg[pkg.pkg] = a.step()
        assert fl.spawned == [0]
    assert obs_by_pkg["lddl_tpu_torch"] == obs_by_pkg["lddl_tpu"]
    ob = obs_by_pkg["lddl_tpu_torch"]
    assert ob["backlog_docs"] == 900
    assert ob["decision"] == "scale_up"
