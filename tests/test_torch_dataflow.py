"""The port's interprocedural dataflow engine (lddl_tpu_torch/analysis/
{project,dataflow,flow_rules}) against lddl_tpu's, one counterpart per
test of ``tests/test_dataflow.py``.

Layers:

1. Project model — import/name resolution across modules, relative
   imports, re-export chains, method binding.
2. Fixture corpus — for EACH of the flow rules: at least one
   interprocedural true positive its syntactic ancestor cannot see
   (the laundering helper lives in another function/file) and at least
   one sanitized case that must stay silent. Every fixture tree is
   written in the port's terms and mirrored, paths and names mapped,
   for lddl_tpu's analyzer (``tests/_torch_analysis_common.py``): both
   reports must agree finding for finding.
3. Integration — suppressions and the baseline apply to flow findings
   exactly as to syntactic ones; same-function (non-crossing) flows are
   left to the syntactic rules.
4. The cache — content-hash hits skip re-analysis; editing one file
   recomputes its facts AND its dependents' findings while untouched
   files are served from cache.
"""

import ast
import textwrap

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _torch_analysis_common import analysis, ref_cache_path  # noqa: E402
from lddl_tpu_torch.analysis import dataflow, flow_rules, project  # noqa: E402


def write_tree(root, files):
    for rel, src in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))


def run_tree(tmp_path, files, rules=None, cache=False, **kw):
    write_tree(tmp_path, files)
    top = sorted({rel.split("/")[0] for rel in files})
    return analysis.run_check(
        top, root=str(tmp_path), baseline_path=kw.pop("baseline_path", ""),
        rules=analysis.get_rules(rules) if rules else None,
        cache_path=str(tmp_path / "cache.json") if cache else None, **kw)


def flow_findings(report, rule=None):
    out = [f for f in report.new if f.rule.endswith("-flow")]
    if rule:
        out = [f for f in out if f.rule == rule]
    return out


# ---------------------------------------------------------- project model


def test_module_name_mapping():
    assert project.module_name_of("lddl_tpu_torch/utils/fs.py") == \
        "lddl_tpu_torch.utils.fs"
    assert project.module_name_of("lddl_tpu_torch/analysis/__init__.py") == \
        "lddl_tpu_torch.analysis"
    assert project.module_name_of("lddl_tpu_torch/tools/lddl_check.py") \
        == "lddl_tpu_torch.tools.lddl_check"


def test_relative_import_and_reexport_resolution():
    proj = project.build_project({
        "pkg/__init__.py": "from .impl import helper\n",
        "pkg/impl.py": "def helper():\n    return 1\n",
        "pkg/sub/user.py": ("from .. import impl\n"
                            "from ..impl import helper as h2\n"
                            "import pkg\n"
                            "def a():\n    return impl.helper()\n"
                            "def b():\n    return h2()\n"
                            "def c():\n    return pkg.helper()\n"),
    })
    user = proj.modules_by_path["pkg/sub/user.py"]
    target = "pkg.impl.helper"
    for dotted in ("pkg.impl.helper", "pkg.helper"):
        fi = proj.resolve_function(user, dotted)
        assert fi is not None and fi.qualname == target, dotted
    # Aliased from-import resolves through the alias map.
    assert proj.resolve_dotted(
        user, ast.parse("h2").body[0].value) == "pkg.impl.helper"


def test_self_method_resolution():
    proj = project.build_project({
        "pkg/mod.py": ("class C:\n"
                       "    def helper(self):\n        return 1\n"
                       "    def run(self):\n"
                       "        return self.helper()\n"),
    })
    mod = proj.modules_by_path["pkg/mod.py"]
    fi = proj.resolve_function(mod, "self.helper", cls="C")
    assert fi is not None and fi.qualname == "pkg.mod.C.helper"


# -------------------------------------------- wall-clock-flow fixtures


WALLCLOCK_HELPER = """
    import time
    import os

    def now_tag():
        return "run-{}".format(time.time())

    def pid_of():
        return os.getpid()

    def fixed_tag(version):
        return "run-{}".format(version)
"""


def test_wall_clock_flow_interprocedural_true_positive(tmp_path):
    """A clock value laundered through a helper in an ALLOWLISTED file
    (tracing legitimately reads clocks; the observability allowlist
    names files individually so autoscale.py stays checked) reaching
    manifest content — invisible to the syntactic wall-clock rule, which
    never fires in the allowlisted file and sees no time.* at the
    manifest call site."""
    report = run_tree(tmp_path, {
        "lddl_tpu_torch/observability/tracing.py": WALLCLOCK_HELPER,
        "lddl_tpu_torch/balance/manifest.py": """
            from ..observability.tracing import now_tag

            def build_manifest(names):
                return {"tag": now_tag(), "shards": sorted(names)}
        """,
    })
    [f] = flow_findings(report, "wall-clock-flow")
    assert f.path == "lddl_tpu_torch/balance/manifest.py"
    assert "time.time" in f.message and "now_tag" in f.message
    # The syntactic ancestor indeed misses it.
    assert not any(f.rule == "wall-clock" for f in report.new)
    assert not any(f.rule == "manifest-determinism" for f in report.new)


def test_wall_clock_flow_publish_argument_sink(tmp_path):
    """A pid flowing into an atomic_write PATH argument: the published
    NAME would differ across ranks even though the write is atomic."""
    report = run_tree(tmp_path, {
        "lddl_tpu_torch/observability/stamp.py": WALLCLOCK_HELPER,
        "lddl_tpu_torch/preprocess/sink.py": """
            from ..resilience.io import atomic_write
            from ..observability.stamp import pid_of

            def publish(out_dir, data):
                atomic_write(out_dir + "/shard-{}.json".format(pid_of()),
                             data)
        """,
        "lddl_tpu_torch/resilience/io.py": "def atomic_write(path, data):\n"
                                     "    raise NotImplementedError\n",
    }, rules=["wall-clock-flow"])
    [f] = flow_findings(report, "wall-clock-flow")
    assert "os.getpid" in f.message and "atomic_write" in f.message


def test_wall_clock_flow_sanitized_false_positive(tmp_path):
    """A helper returning a value built from its (deterministic) argument
    must NOT taint the manifest: summaries distinguish param passthrough
    from source introduction."""
    report = run_tree(tmp_path, {
        "lddl_tpu_torch/observability/stamp.py": WALLCLOCK_HELPER,
        "lddl_tpu_torch/balance/manifest.py": """
            from ..observability.stamp import fixed_tag

            def build_manifest(names, version):
                return {"tag": fixed_tag(version),
                        "shards": sorted(names)}
        """,
    })
    assert flow_findings(report) == []


# --------------------------------------------------- rng-flow fixtures


RNG_HELPER = """
    import numpy as np

    def thread_rng():
        return np.random.default_rng()

    def keyed_rng(seed):
        return np.random.default_rng(seed)
"""


def test_rng_flow_interprocedural_true_positive(tmp_path):
    """An UNKEYED generator built inside utils/rng.py — the file the
    syntactic global-rng rule ALLOWLISTS (it may construct whatever it
    needs) — escaping to pipeline code that draws from it. Only the flow
    rule can see the draw is unkeyed."""
    report = run_tree(tmp_path, {
        "lddl_tpu_torch/utils/rng.py": RNG_HELPER,
        "lddl_tpu_torch/loader/pick.py": """
            from ..utils.rng import thread_rng

            def choose(files):
                g = thread_rng()
                g.shuffle(files)
                return files
        """,
    })
    [f] = flow_findings(report, "rng-flow")
    assert f.path == "lddl_tpu_torch/loader/pick.py"
    assert "default_rng" in f.message and "shuffle" in f.message
    assert not any(f.rule == "global-rng" for f in report.new)


def test_rng_flow_keyed_stream_is_clean(tmp_path):
    report = run_tree(tmp_path, {
        "lddl_tpu_torch/utils/rng.py": RNG_HELPER,
        "lddl_tpu_torch/loader/pick.py": """
            from ..utils.rng import keyed_rng

            def choose(files, seed):
                g = keyed_rng(seed)
                g.shuffle(files)
                return files
        """,
    })
    assert flow_findings(report) == []


def test_rng_flow_module_global_generator(tmp_path):
    """Module-global unkeyed RNG state consumed inside a function — the
    flow crosses a scope boundary no per-function rule can see."""
    report = run_tree(tmp_path, {
        "lddl_tpu_torch/loader/jitterbug.py": """
            import random

            _rng = random.Random()

            def pick_delay(base):
                return base * _rng.uniform(0.5, 1.5)
        """,
    })
    [f] = flow_findings(report, "rng-flow")
    assert "module global _rng" in f.message


# --------------------------------------------- fs-order-flow fixtures


FS_HELPER = """
    import os

    def entries(d):
        # raw listing; callers must sort -- lddl: disable=unsorted-iteration
        return os.listdir(d)

    def entries_sorted(d):
        return sorted(os.listdir(d))
"""


def test_fs_order_flow_interprocedural_true_positive(tmp_path):
    """Unsorted listdir escaping through a helper whose own listing is
    SUPPRESSED ("callers must sort") and iterated by a caller that does
    not sort — across files, which the statement-local syntactic rule
    cannot track, and past a producer-side suppression that silences it
    entirely."""
    report = run_tree(tmp_path, {
        "lddl_tpu_torch/utils/listing.py": FS_HELPER,
        "lddl_tpu_torch/balance/scan.py": """
            from ..utils.listing import entries

            def shards(d):
                out = []
                for n in entries(d):
                    out.append(n)
                return out
        """,
    })
    [f] = flow_findings(report, "fs-order-flow")
    assert f.path == "lddl_tpu_torch/balance/scan.py"
    assert "os.listdir" in f.message and "entries" in f.message
    assert not any(f.rule == "unsorted-iteration" for f in report.new)


def test_fs_order_flow_sink_side_laundering(tmp_path):
    """The DUAL direction: the caller produces the listing and a helper
    iterates it — the finding lands at the call site that handed the
    unsorted value over."""
    report = run_tree(tmp_path, {
        "lddl_tpu_torch/balance/scan.py": """
            import os

            def census(names):
                out = {}
                for n in names:
                    out[n] = 1
                return out

            def run(d):
                return census(os.listdir(d))
        """,
    }, rules=["fs-order-flow"])
    [f] = flow_findings(report, "fs-order-flow")
    assert "census" in f.message


def test_fs_order_flow_sorted_and_reductions_are_clean(tmp_path):
    report = run_tree(tmp_path, {
        "lddl_tpu_torch/utils/listing.py": FS_HELPER,
        "lddl_tpu_torch/balance/scan.py": """
            from ..utils.listing import entries, entries_sorted

            def shards(d):
                return [n for n in entries_sorted(d)]

            def count(d):
                return len(entries(d))

            def uniq(d):
                return set(entries(d))

            def shards2(d):
                return sorted(entries(d))
        """,
    })
    assert flow_findings(report) == []


def test_fs_order_flow_error_text_sink(tmp_path):
    """FS-ordered content rendered into exception text diverges error
    messages across hosts (a balancer bug class, here cross-function)."""
    report = run_tree(tmp_path, {
        "lddl_tpu_torch/utils/listing.py": FS_HELPER,
        "lddl_tpu_torch/balance/guard.py": """
            from ..utils.listing import entries

            def refuse_dirty(d):
                stale = entries(d)
                raise ValueError("dirty dir, e.g. {}".format(stale[0]))
        """,
    }, rules=["fs-order-flow"])
    found = flow_findings(report, "fs-order-flow")
    assert found, "indexing/formatting an unsorted listing must flag"


# ------------------------------------------ publish-path-flow fixtures


def test_publish_path_flow_interprocedural_true_positive(tmp_path):
    """A raw write hidden in a helper OUTSIDE the shard packages, invoked
    from preprocess: the syntactic atomic-publish rule scopes write-mode
    open() to shard packages, so only the flow rule can see this."""
    report = run_tree(tmp_path, {
        "lddl_tpu_torch/utils/textio.py": """
            def write_text(path, text):
                with open(path, "w") as f:
                    f.write(text)
        """,
        "lddl_tpu_torch/preprocess/sink.py": """
            from ..utils.textio import write_text

            def dump(out_dir, rows):
                write_text(out_dir + "/x.txt", rows)
        """,
    })
    [f] = flow_findings(report, "publish-path-flow")
    assert f.path == "lddl_tpu_torch/preprocess/sink.py"
    assert "write_text" in f.message and "open(mode='w')" in f.message
    assert not any(f.rule == "atomic-publish" for f in report.new)


def test_publish_path_flow_transitive_chain(tmp_path):
    """The effect propagates through intermediate helpers."""
    report = run_tree(tmp_path, {
        "lddl_tpu_torch/utils/textio.py": """
            def _raw(path, text):
                with open(path, "w") as f:
                    f.write(text)

            def write_text(path, text):
                _raw(path, text)
        """,
        "lddl_tpu_torch/balance/sink.py": """
            from ..utils.textio import write_text

            def dump(out_dir, rows):
                write_text(out_dir + "/x.txt", rows)
        """,
    }, rules=["publish-path-flow"])
    [f] = flow_findings(report, "publish-path-flow")
    assert "write_text" in f.message


def test_publish_path_flow_through_async_sink_submit(tmp_path):
    """The writer-thread boundary cannot launder a raw write: a raw-
    writing helper handed to ``writer.submit(...)`` (deferred execution
    on the sink thread) is treated as called at the enqueue site, so the
    publish-path rule still fires in the enqueuing shard-package
    function."""
    report = run_tree(tmp_path, {
        "lddl_tpu_torch/utils/rawio.py": """
            def raw_dump():
                with open("/out/x.parquet", "w") as f:
                    f.write("bytes")
        """,
        "lddl_tpu_torch/preprocess/sink.py": """
            class ShardWriter:
                def __init__(self):
                    self._q = []

                def submit(self, unit, fn, fence=None):
                    self._q.append((unit, fn, fence))
        """,
        "lddl_tpu_torch/preprocess/runner.py": """
            from ..utils.rawio import raw_dump
            from .sink import ShardWriter

            def gather(out_dir, rows):
                writer = ShardWriter()
                writer.submit(7, raw_dump)
        """,
    }, rules=["publish-path-flow"])
    [f] = flow_findings(report, "publish-path-flow")
    assert f.path == "lddl_tpu_torch/preprocess/runner.py"
    assert "raw_dump" in f.message


def test_publish_path_flow_async_sink_lambda_argument(tmp_path):
    """A lambda enqueued on the sink is walked at the enqueue site: the
    raw write reached through its body is attributed to the enqueuing
    function."""
    report = run_tree(tmp_path, {
        "lddl_tpu_torch/utils/rawio.py": """
            def raw_dump(path):
                with open(path, "w") as f:
                    f.write("bytes")
        """,
        "lddl_tpu_torch/preprocess/runner.py": """
            from ..utils.rawio import raw_dump

            def gather(writer, out_dir):
                writer.submit(7, lambda: raw_dump(out_dir + "/x.parquet"))
        """,
    }, rules=["publish-path-flow"])
    [f] = flow_findings(report, "publish-path-flow")
    assert f.path == "lddl_tpu_torch/preprocess/runner.py"
    assert "raw_dump" in f.message


def test_publish_path_flow_async_sink_clean_closure_is_silent(tmp_path):
    """The sanctioned pattern — a deferred closure publishing through
    resilience.io — stays silent across the submit boundary."""
    report = run_tree(tmp_path, {
        "lddl_tpu_torch/resilience/io.py": """
            import os

            def write_table_atomic(table, path):
                tmp = path + ".tmp"
                with open(tmp, "wb") as f:
                    f.write(table)
                os.replace(tmp, path)
        """,
        "lddl_tpu_torch/preprocess/runner.py": """
            from ..resilience.io import write_table_atomic

            def publish_shard():
                write_table_atomic(b"t", "/out/part.0.parquet")

            def gather(writer):
                writer.submit(7, publish_shard)
        """,
    }, rules=["publish-path-flow"])
    assert flow_findings(report) == []


def test_publish_path_flow_atomic_publisher_is_sanctioned(tmp_path):
    """Calling through resilience.io is THE sanctioned path: no finding,
    even though io.py internally write-opens and os.replaces."""
    report = run_tree(tmp_path, {
        "lddl_tpu_torch/resilience/io.py": """
            import os

            def atomic_write(path, data):
                tmp = path + ".tmp"
                with open(tmp, "wb") as f:
                    f.write(data)
                os.replace(tmp, path)
        """,
        "lddl_tpu_torch/preprocess/sink.py": """
            from ..resilience.io import atomic_write

            def dump(out_dir, rows):
                atomic_write(out_dir + "/x.txt", rows)
        """,
    }, rules=["publish-path-flow"])
    assert flow_findings(report) == []


def test_publish_path_flow_observability_writes_exempt(tmp_path):
    """Trace/metrics writers never land in shard dirs by construction;
    a shard-package call into them is not a publish violation."""
    report = run_tree(tmp_path, {
        "lddl_tpu_torch/observability/tracing.py": """
            def flush(path, buf):
                with open(path, "a") as f:
                    f.write(buf)
        """,
        "lddl_tpu_torch/preprocess/runner.py": """
            from ..observability.tracing import flush

            def finish(trace_path, buf):
                flush(trace_path, buf)
        """,
    }, rules=["publish-path-flow"])
    assert flow_findings(report) == []


def test_publish_path_flow_fleet_spool_writes_exempt_shard_write_caught(
        tmp_path):
    """The fleet-telemetry spool writers (.telemetry/ event logs and
    snapshots, observability/fleet.py) are non-shard sinks by
    construction: lifecycle emission from the elastic claim loop must not
    read as a publish violation. A raw write laundered through a
    NON-exempt helper on the same call path is still caught — the
    exemption is the module, never the caller."""
    report = run_tree(tmp_path, {
        "lddl_tpu_torch/observability/fleet.py": """
            def flush_events(spool_dir, batch):
                with open(spool_dir + "/events-pid0.jsonl", "a") as f:
                    f.write(batch)
        """,
        "lddl_tpu_torch/utils/rawio.py": """
            def dump(path, data):
                with open(path, "w") as f:
                    f.write(data)
        """,
        "lddl_tpu_torch/preprocess/steal.py": """
            from ..observability.fleet import flush_events
            from ..utils.rawio import dump

            def complete_unit(out_dir, rec):
                flush_events(out_dir + "/.telemetry/h0", rec)
                dump(out_dir + "/part.0.txt", rec)
        """,
    }, rules=["publish-path-flow"])
    findings = flow_findings(report, "publish-path-flow")
    assert len(findings) == 1, [f.format() for f in findings]
    assert findings[0].path == "lddl_tpu_torch/preprocess/steal.py"
    assert "dump" in findings[0].message
    assert "flush_events" not in findings[0].message


# ------------------------------------------ lease-isolation fixtures


def _lease_findings(report):
    return [f for f in report.new if f.rule == "lease-isolation"]


# A minimal stand-in for the real lease module at its real path (the
# engine keys lease sources off dataflow.LEASE_MODULE).
_LEASE_FIXTURE = """
    import json, os, time

    def try_acquire(root, unit, holder, ttl_s):
        rec = {"unit": unit, "holder": holder, "epoch": 0,
               "deadline": time.time() + ttl_s}
        with open(os.path.join(root, unit), "w") as f:
            json.dump(rec, f)
        return rec

    def read_lease(root, unit):
        with open(os.path.join(root, unit)) as f:
            return json.load(f)
"""


def test_lease_isolation_publish_argument_true_positive(tmp_path):
    """Lease state (the epoch) flowing into an atomic_write payload in a
    pipeline module: the exact corruption the fence exists to prevent —
    lease scheduling state reaching published bytes."""
    report = run_tree(tmp_path, {
        "lddl_tpu_torch/resilience/leases.py": _LEASE_FIXTURE,
        "lddl_tpu_torch/resilience/io.py": """
            def atomic_write(path, data):
                return None
        """,
        "lddl_tpu_torch/preprocess/bad.py": """
            from ..resilience import leases
            from ..resilience.io import atomic_write

            def journal(root, unit, out):
                lease = leases.try_acquire(root, unit, "h", 5.0)
                atomic_write(out, str(lease["epoch"]))
        """,
    })
    found = _lease_findings(report)
    assert any(f.path == "lddl_tpu_torch/preprocess/bad.py" for f in found)
    assert any("try_acquire" in f.message for f in found)


def test_lease_isolation_manifest_content_true_positive(tmp_path):
    """Lease state stored into manifest/ledger builder content."""
    report = run_tree(tmp_path, {
        "lddl_tpu_torch/resilience/leases.py": _LEASE_FIXTURE,
        "lddl_tpu_torch/balance/census.py": """
            from ..resilience import leases

            def build_manifest_entry(root, unit):
                lease = leases.read_lease(root, unit)
                entry = {}
                entry["holder"] = lease["holder"]
                return entry
        """,
    })
    found = _lease_findings(report)
    assert any(f.path == "lddl_tpu_torch/balance/census.py" for f in found)


def test_lease_isolation_control_flow_only_is_silent(tmp_path):
    """Using a lease to DECIDE (claim check, fence branch) is the whole
    point; only data flows into published bytes may fire."""
    report = run_tree(tmp_path, {
        "lddl_tpu_torch/resilience/leases.py": _LEASE_FIXTURE,
        "lddl_tpu_torch/resilience/io.py": """
            def atomic_write(path, data):
                return None
        """,
        "lddl_tpu_torch/preprocess/ok.py": """
            from ..resilience import leases
            from ..resilience.io import atomic_write

            def guarded_publish(root, unit, out, data):
                lease = leases.try_acquire(root, unit, "h", 5.0)
                if lease is not None:
                    atomic_write(out, data)
        """,
    })
    assert _lease_findings(report) == []


def test_lease_isolation_lease_module_writes_exempt(tmp_path):
    """The lease module's own publishes ARE lease files — exempt at the
    engine level, so no caller-side or module-side finding fires for the
    protocol's own I/O."""
    report = run_tree(tmp_path, {
        "lddl_tpu_torch/resilience/leases.py": """
            from .io import atomic_write

            def renew(root, unit, holder, epoch, deadline):
                rec = "{}:{}:{}".format(holder, epoch, deadline)
                atomic_write(root + "/" + unit, rec)
        """,
        "lddl_tpu_torch/resilience/io.py": """
            def atomic_write(path, data):
                return None
        """,
        "lddl_tpu_torch/preprocess/user.py": """
            from ..resilience import leases

            def keep_alive(root, unit):
                leases.renew(root, unit, "h", 1, 2.0)
        """,
    }, rules=["lease-isolation"])
    assert _lease_findings(report) == []


def test_lease_isolation_suppression_applies(tmp_path):
    """The one sanctioned epoch-into-record flow pattern (steal.py's
    fence record) silences with a why-commented inline suppression, like
    every other rule."""
    report = run_tree(tmp_path, {
        "lddl_tpu_torch/resilience/leases.py": _LEASE_FIXTURE,
        "lddl_tpu_torch/resilience/io.py": """
            def atomic_write(path, data):
                return None
        """,
        "lddl_tpu_torch/preprocess/steal.py": """
            from ..resilience import leases
            from ..resilience.io import atomic_write

            def journal(root, unit, out):
                lease = leases.try_acquire(root, unit, "h", 5.0)
                # The record IS the epoch fence for spool bytes.
                atomic_write(out, str(lease["epoch"]))  # lddl: disable=lease-isolation,wall-clock-flow
        """,
    })
    assert _lease_findings(report) == []
    assert any(f.rule == "lease-isolation" for f in report.suppressed)


# ------------------------------------------------- framework integration


def test_flow_findings_respect_inline_suppressions(tmp_path):
    report = run_tree(tmp_path, {
        "lddl_tpu_torch/utils/listing.py": FS_HELPER,
        "lddl_tpu_torch/balance/scan.py": """
            from ..utils.listing import entries

            def shards(d):
                # order-insensitive census -- lddl: disable=fs-order-flow
                for n in entries(d):
                    yield n
        """,
    })
    assert flow_findings(report) == []
    assert any(f.rule == "fs-order-flow" for f in report.suppressed)


def test_flow_findings_respect_baseline_and_counts(tmp_path):
    files = {
        "lddl_tpu_torch/utils/listing.py": FS_HELPER,
        "lddl_tpu_torch/balance/scan.py": """
            from ..utils.listing import entries

            def shards(d):
                for n in entries(d):
                    yield n
        """,
    }
    write_tree(tmp_path, files)
    report = analysis.run_check(["lddl_tpu_torch"], root=str(tmp_path),
                                baseline_path="")
    [f] = flow_findings(report, "fs-order-flow")
    import json
    baseline = tmp_path / "baseline.json"
    baseline.write_text(json.dumps(
        {"entries": [analysis.baseline_entry(f, reason="fixture")]}))
    report = analysis.run_check(["lddl_tpu_torch"], root=str(tmp_path),
                                baseline_path=str(baseline))
    assert flow_findings(report) == []
    assert [b.rule for b in report.baselined] == ["fs-order-flow"]


def test_same_function_flow_is_left_to_syntactic_rules(tmp_path):
    """for n in os.listdir(d) in ONE function: unsorted-iteration fires,
    fs-order-flow stays silent — one violation, one finding."""
    report = run_tree(tmp_path, {
        "lddl_tpu_torch/balance/scan.py": """
            import os

            def shards(d):
                return [n for n in os.listdir(d)]
        """,
    })
    assert [f.rule for f in report.new] == ["unsorted-iteration"]


def test_count_aware_baseline_blocks_duplicate_lines():
    """One baseline entry must absorb exactly ONE copy of an identical
    line; a pasted duplicate is a NEW finding (the old matcher let any
    number ride on one entry)."""
    src = ("import os\n"
           "names = os.listdir(d)\n"
           "names = os.listdir(d)\n")
    findings, _ = analysis.analyze_source(src, "lddl_tpu_torch/x.py")
    assert len(findings) == 2
    assert findings[0].key() == findings[1].key()
    entry = analysis.baseline_entry(findings[0], "grandfathered")
    new, old = analysis.split_baselined(findings, [entry])
    assert len(old) == 1 and len(new) == 1
    # count=2 absorbs both; the CLI's --write-baseline emits counts.
    entry2 = analysis.baseline_entry(findings[0], "grandfathered", count=2)
    new, old = analysis.split_baselined(findings, [entry2])
    assert (len(new), len(old)) == (0, 2)


# ----------------------------------------------------------- the cache


CACHE_TREE = {
    "lddl_tpu_torch/utils/listing.py": FS_HELPER,
    "lddl_tpu_torch/balance/scan.py": """
        from ..utils.listing import entries

        def shards(d):
            out = []
            for n in entries(d):
                out.append(n)
            return out
    """,
}


def test_cache_hit_serves_unchanged_files(tmp_path):
    r1 = run_tree(tmp_path, CACHE_TREE, cache=True)
    assert r1.files_cached == 0
    assert len(flow_findings(r1, "fs-order-flow")) == 1
    r2 = analysis.run_check(["lddl_tpu_torch"], root=str(tmp_path),
                            baseline_path="",
                            cache_path=str(tmp_path / "cache.json"))
    assert r2.files_cached == r2.files == 2
    # Identical results from a fully-cached run, flow findings included.
    assert [f.format() for f in r2.new] == [f.format() for f in r1.new]


def test_cache_invalidation_recomputes_editee_and_dependents(tmp_path):
    run_tree(tmp_path, CACHE_TREE, cache=True)
    # Fix the HELPER only: its hash changes (re-analyzed), the caller is
    # served from cache, and the caller's finding must still disappear —
    # dependents' findings flow from the recomputed fixpoint, not from
    # stale cached output.
    helper = tmp_path / "lddl_tpu_torch/utils/listing.py"
    helper.write_text(textwrap.dedent("""
        import os

        def entries(d):
            return sorted(os.listdir(d))

        def entries_sorted(d):
            return sorted(os.listdir(d))
    """))
    r = analysis.run_check(["lddl_tpu_torch"], root=str(tmp_path),
                           baseline_path="",
                           cache_path=str(tmp_path / "cache.json"))
    assert r.files == 2 and r.files_cached == 1  # only the caller cached
    assert flow_findings(r) == []
    # And the reverse edit reintroduces the finding.
    (tmp_path / "lddl_tpu_torch/utils/listing.py").write_text(
        textwrap.dedent(FS_HELPER))
    r = analysis.run_check(["lddl_tpu_torch"], root=str(tmp_path),
                           baseline_path="",
                           cache_path=str(tmp_path / "cache.json"))
    assert len(flow_findings(r, "fs-order-flow")) == 1


def test_path_filtered_run_does_not_poison_full_tree_cache(tmp_path):
    """Facts extracted under a PARTIAL project model (explicit-path run)
    record cross-package calls as opaque externals; reusing them in a
    full-tree run would silently drop flow findings. The analyzed path
    set is part of the cache signature, so the full run re-extracts."""
    write_tree(tmp_path, CACHE_TREE)
    cache = str(tmp_path / "cache.json")
    partial = analysis.run_check(["lddl_tpu_torch/balance"],
                                 root=str(tmp_path),
                                 baseline_path="", cache_path=cache)
    assert flow_findings(partial) == []  # helper not in scope: no flow
    full = analysis.run_check(["lddl_tpu_torch"], root=str(tmp_path),
                              baseline_path="", cache_path=cache)
    assert full.files_cached == 0  # partial-run cache must NOT be reused
    assert len(flow_findings(full, "fs-order-flow")) == 1


def test_overlapping_paths_analyze_each_file_once(tmp_path):
    """Overlapping path args must not analyze a file twice: duplicate
    findings would overflow count-aware baseline entries and report.files
    would double-count."""
    write_tree(tmp_path, CACHE_TREE)
    once = analysis.run_check(["lddl_tpu_torch"], root=str(tmp_path),
                              baseline_path="")
    twice = analysis.run_check(["lddl_tpu_torch", "lddl_tpu_torch/balance"],
                               root=str(tmp_path), baseline_path="")
    assert twice.files == once.files == 2
    assert [f.format() for f in twice.new] == \
        [f.format() for f in once.new]


def test_cache_tolerates_corruption(tmp_path):
    write_tree(tmp_path, CACHE_TREE)
    cache = tmp_path / "cache.json"
    cache.write_text("{ not json")
    with open(ref_cache_path(str(cache)), "w") as f:
        f.write("{ not json")
    r = analysis.run_check(["lddl_tpu_torch"], root=str(tmp_path),
                           baseline_path="", cache_path=str(cache))
    assert r.files_cached == 0
    assert len(flow_findings(r, "fs-order-flow")) == 1


# ------------------------------------------------- engine unit coverage


def _summaries_of(files):
    proj = project.build_project(
        {p: textwrap.dedent(s) for p, s in files.items()})
    facts = [dataflow.extract_module_facts(proj, proj.modules_by_path[p])
             for p in sorted(proj.modules_by_path)]
    eng = dataflow.Engine(facts)
    eng.solve()
    return eng


def test_summaries_param_passthrough_vs_source():
    eng = _summaries_of({
        "m.py": """
            import time

            def ident(x):
                return x

            def stamped():
                return time.time()
        """,
    })
    ident = eng.summaries["m.ident"]
    stamped = eng.summaries["m.stamped"]
    assert ident.ret_params["wallclock"] == frozenset({0})
    assert ident.ret_srcs["wallclock"] == frozenset()
    assert not stamped.ret_params["wallclock"]
    [(name, path, line)] = stamped.ret_srcs["wallclock"]
    assert name == "time.time"


def test_summaries_recursive_functions_terminate():
    eng = _summaries_of({
        "m.py": """
            import os

            def a(d, depth):
                if depth:
                    return a(d, depth - 1)
                return os.listdir(d)

            def b(d):
                return c(d)

            def c(d):
                return b(d)
        """,
    })
    assert eng.summaries["m.a"].ret_srcs["fsorder"]


def test_flow_rule_ids_are_registered():
    ids = {r.id for r in analysis.all_rules()}
    for rid in flow_rules.FLOW_RULE_IDS:
        assert rid in ids


def test_fixture_rules_scope_marking():
    by_id = {r.id: r for r in analysis.all_rules()}
    assert by_id["fs-order-flow"].scope == "project"
    assert by_id["unsorted-iteration"].scope == "file"


# ----------------------- ingest journal/generation builders


def test_wall_clock_flow_into_journal_builder_content(tmp_path):
    """Journal segments are resume-compared, content-hash-only bytes —
    a clock value laundered through an observability helper into a
    journal builder's content must flag exactly like a manifest."""
    report = run_tree(tmp_path, {
        "lddl_tpu_torch/observability/stamp.py": WALLCLOCK_HELPER,
        "lddl_tpu_torch/ingest/journal.py": """
            from ..observability.stamp import now_tag

            def build_journal_segment(hashes):
                return {"stamp": now_tag(), "hashes": sorted(hashes)}
        """,
    })
    [f] = flow_findings(report, "wall-clock-flow")
    assert f.path == "lddl_tpu_torch/ingest/journal.py"
    assert "time.time" in f.message
    # Direct-call rule has nothing to see (the clock is in the helper).
    assert not any(f.rule == "manifest-determinism" for f in report.new)


def test_manifest_determinism_covers_ingest_builder_names(tmp_path):
    """The syntactic rule's name gate extends to the ingest record
    builders: journal / intake / generation functions drawing
    nondeterminism directly each flag."""
    report = run_tree(tmp_path, {
        "lddl_tpu_torch/ingest/records.py": """
            import os
            import time
            import uuid

            def build_journal_record(hashes):
                return {"at": time.time(), "hashes": sorted(hashes)}

            def publish_intake_record(docs):
                return {"pid": os.getpid(), "docs": sorted(docs)}

            def generation_meta(n):
                return {"id": str(uuid.uuid4()), "generation": n}
        """,
    }, rules=["manifest-determinism"])
    found = [f for f in report.new if f.rule == "manifest-determinism"]
    assert len(found) == 3


def test_fs_order_flow_into_journal_record(tmp_path):
    """Landing-scan order must never shape journal bytes: an unsorted
    listing crossing into an intake builder and iterated there flags."""
    report = run_tree(tmp_path, {
        "lddl_tpu_torch/utils/listing.py": FS_HELPER,
        "lddl_tpu_torch/ingest/scan.py": """
            from ..utils.listing import entries

            def build_intake_hashes(d):
                out = []
                for name in entries(d):
                    out.append(name)
                return out
        """,
    })
    [f] = flow_findings(report, "fs-order-flow")
    assert f.path == "lddl_tpu_torch/ingest/scan.py"


def test_journal_builder_content_hash_only_is_clean(tmp_path):
    """The sanctioned shape: content hashes + sorted iteration + a
    deterministic generation counter — silent under BOTH rule families."""
    report = run_tree(tmp_path, {
        "lddl_tpu_torch/ingest/journal.py": """
            import hashlib
            import os

            def doc_hash(text):
                return hashlib.blake2b(text, digest_size=16).hexdigest()

            def build_journal_segment(generation, texts):
                hashes = sorted(doc_hash(t) for t in texts)
                return {"generation": generation, "hashes": hashes}

            def scan_landing(d):
                return sorted(os.listdir(d))
        """,
    })
    assert report.new == []


def test_publish_path_flow_covers_ingest_package(tmp_path):
    """lddl_tpu_torch/ingest/ is a shard package: a raw write laundered
    through an outside helper flags exactly as it would from
    preprocess/."""
    report = run_tree(tmp_path, {
        "lddl_tpu_torch/utils/textio.py": """
            def write_text(path, text):
                with open(path, "w") as f:
                    f.write(text)
        """,
        "lddl_tpu_torch/ingest/sink.py": """
            from ..utils.textio import write_text

            def dump_segment(out_dir, payload):
                write_text(out_dir + "/gen-0001.json", payload)
        """,
    }, rules=["publish-path-flow"])
    [f] = flow_findings(report, "publish-path-flow")
    assert f.path == "lddl_tpu_torch/ingest/sink.py"


# ----------------------- offline packer module


def test_manifest_determinism_covers_pack_meta_builder(tmp_path):
    """The packer's manifest-meta fragment (pack_meta_of) is
    resume-compared content: the builder-name gate extends to pack_meta
    so a clock-shaped packed shape flags like any other manifest
    nondeterminism."""
    report = run_tree(tmp_path, {
        "lddl_tpu_torch/preprocess/packing.py": """
            import time

            def pack_meta_of(budget, per_row):
                return {"pack_seq_length": budget,
                        "pack_max_per_row": per_row,
                        "packed_at": time.time()}
        """,
    }, rules=["manifest-determinism"])
    found = [f for f in report.new if f.rule == "manifest-determinism"]
    assert len(found) == 1
    assert found[0].path == "lddl_tpu_torch/preprocess/packing.py"


def test_publish_path_flow_covers_packer_module(tmp_path):
    """The packer module lives in a shard package: a raw parquet write
    laundered through an outside helper on its call path flags — the
    packed sink must publish through resilience.io like every other
    sink."""
    report = run_tree(tmp_path, {
        "lddl_tpu_torch/utils/rawpq.py": """
            import pyarrow.parquet as pq

            def dump_table(table, path):
                pq.write_table(table, path)
        """,
        "lddl_tpu_torch/preprocess/packing.py": """
            from ..utils.rawpq import dump_table

            def write_packed_shard(table, out_dir):
                dump_table(table, out_dir + "/part.0.parquet")
        """,
    }, rules=["publish-path-flow"])
    [f] = flow_findings(report, "publish-path-flow")
    assert f.path == "lddl_tpu_torch/preprocess/packing.py"
