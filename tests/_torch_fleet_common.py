"""Shared helpers of the fleet-telemetry parity tests
(``test_torch_fleet``, ``test_torch_diagnosis``, ``test_torch_autoscale``,
``test_torch_observability``): both packages' telemetry modules, the
environment scrub and module resets every test runs before and after,
and the fake-spool writer the reference's tests use.

Both packages read the same environment variables, so one side's
``configure`` arms the other side's hooks too, and both registries
export into ``metrics-rank<r>-pid<p>.jsonl`` of the same directory. Each
test therefore runs each side in its own directory and resets both
packages' registries, tracing and fleet state around itself. The scrub
is a plain ``os.environ.pop``: ``monkeypatch.delenv`` would put a value
leaked by an earlier test of the worker back at teardown.
"""

import importlib
import json
import os
import sys

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ENVS = ("LDDL_TPU_FLEET_DIR", "LDDL_TPU_FLEET_HOLDER",
        "LDDL_TPU_FLEET_TTL_S", "LDDL_TPU_FLEET_INTERVAL_S",
        "LDDL_TPU_FLEET_ROTATE_BYTES", "LDDL_TPU_FLEET_RETAIN_BYTES",
        "LDDL_TPU_FLEET_RETAIN_AGE_S", "LDDL_TPU_SERIES_RING",
        "LDDL_TPU_METRICS_DIR", "LDDL_TPU_METRICS_RANK",
        "LDDL_TPU_METRICS_INTERVAL_S")


class Obs:
    """One package's observability surface."""

    def __init__(self, pkg):
        self.pkg = pkg

        def imp(m):
            return importlib.import_module("{}.observability{}".format(
                pkg, "." + m if m else ""))

        self.obs = imp("")
        self.fleet = imp("fleet")
        self.series = imp("series")
        self.alerts = imp("alerts")
        self.autoscale = imp("autoscale")
        self.tracing = imp("tracing")
        self.exporters = imp("exporters")
        self.attribution = imp("attribution")

    def reset(self):
        self.exporters.stop_periodic_export()
        self.obs.registry().reset()
        self.tracing._reset_for_tests()
        self.fleet._reset_for_tests()


REF, PORT = Obs("lddl_tpu"), Obs("lddl_tpu_torch")


def scrub_env():
    for name in ENVS:
        os.environ.pop(name, None)


def reset_both():
    scrub_env()
    REF.reset()
    PORT.reset()
    scrub_env()


def quiet(*_a):
    return None


def aggregate_both(root, **kw):
    """``fleet.aggregate`` of both packages over one spool dir (a fixed
    ``now`` makes the whole report a function of the spool bytes); the
    two reports must be equal. Returns the port's."""
    kw.setdefault("warn", quiet)
    want = REF.fleet.aggregate(root, **kw)
    got = PORT.fleet.aggregate(root, **kw)
    assert got == want
    json.dumps(got)  # the --json contract: fully serializable
    return got


def fake_spool(root, holder, pid, wall, counters=None, gauges=None,
               closed=False, ttl=5.0, events=(), torn_tail=False,
               started=None):
    """One holder's spool as the reference's tests write it: a snapshot
    and an event log (optionally with a torn tail)."""
    d = os.path.join(root, ".telemetry", holder)
    os.makedirs(d, exist_ok=True)
    metrics = {}
    for name, total in (counters or {}).items():
        metrics[name] = {"type": "counter", "values": {"": total}}
    for name, value in (gauges or {}).items():
        metrics[name] = {"type": "gauge", "values": {"": value}}
    snap = {"holder": holder, "pid": pid, "rank": 0, "wall": wall,
            "mono": 100.0, "started_wall": started if started is not None
            else wall - 60.0, "interval_s": 1.0, "ttl_s": ttl,
            "closed": closed, "metrics": metrics}
    with open(os.path.join(d, "snapshot-pid{}.json".format(pid)), "w") as f:
        json.dump(snap, f)
    with open(os.path.join(d, "events-pid{}.jsonl".format(pid)), "w") as f:
        for ev in events:
            f.write(json.dumps(ev) + "\n")
        if torn_tail:
            f.write('{"kind": "unit.cl')
    return d


def write_trace(root, holder, pid, events):
    d = os.path.join(root, ".telemetry", holder)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "trace-rank0-pid{}.jsonl".format(pid)),
              "w") as f:
        for ev in events:
            f.write(json.dumps(ev) + "\n")


def subprocess_env():
    """The environment of a probe subprocess: the repo on the path,
    every telemetry variable unset (the probe arms its own)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO_ROOT + os.pathsep + env.get("PYTHONPATH", "")
    for name in ENVS:
        env.pop(name, None)
    return env


def ref_tool(name):
    """The reference's status tool module (``tools/<name>.py``)."""
    if REPO_ROOT not in sys.path:
        sys.path.insert(0, REPO_ROOT)
    return importlib.import_module("tools." + name)


def port_tool(name):
    return importlib.import_module("lddl_tpu_torch.tools." + name)
