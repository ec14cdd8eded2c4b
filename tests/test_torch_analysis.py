"""The port's determinism / SPMD-safety analyzer (lddl_tpu_torch/analysis)
against lddl_tpu's, one counterpart per test of ``tests/test_analysis.py``.

Three layers:

1. Framework mechanics — suppressions, baseline matching, JSON output,
   exit codes.
2. Per-rule fixtures — every rule gets at least one true-positive bad
   snippet AND one suppressed/allowlisted case. Each fixture is written
   in the port's terms and also analyzed by lddl_tpu's analyzer with its
   paths and names mapped (``tests/_torch_analysis_common.py``): the two
   must give the same findings.
3. The CI gate — a full run over lddl_tpu_torch/ must produce zero
   non-baselined findings, with a bounded, justified baseline; the CLI
   (``python -m lddl_tpu_torch.tools.lddl_check``), its ``ci_check.sh``
   and SARIF; plus ordered-iteration determinism proofs for the port's
   shard enumeration paths.

The port's analyzer keeps its own cache (``.lddl_tpu_torch_check_cache
.json``) and SARIF (``lddl_tpu_torch_check.sarif``): nothing here reads or
writes lddl_tpu's ``.lddl_check_cache.json`` or ``lddl_check.sarif``.
"""

import json
import os
import re
import subprocess
import sys
import textwrap

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _torch_analysis_common import REF, PORT, analysis  # noqa: E402

REPO_ROOT = PORT.REPO_ROOT
CLI = [sys.executable, "-m", "lddl_tpu_torch.tools.lddl_check"]
ENV = dict(os.environ, PYTHONPATH=REPO_ROOT)


def check(source, path, rules=None):
    """Findings for one in-memory snippet under a virtual repo path (the
    port's, checked equal to the reference's on the mapped path)."""
    findings, _ = analysis.analyze_source(
        textwrap.dedent(source), path,
        analysis.get_rules(rules) if rules else None)
    return findings


def rule_ids(findings):
    return [f.rule for f in findings]


# ------------------------------------------------------------- framework


def test_every_rule_is_registered_once():
    ids = [r.id for r in analysis.all_rules()]
    assert len(ids) == len(set(ids))
    assert set(ids) == {
        # file-scope (syntactic) rules
        "global-rng", "wall-clock", "atomic-publish", "unsorted-iteration",
        "swallowed-error", "stage-span", "jit-host-effect",
        "manifest-determinism", "python-hot-loop",
        # project-scope (interprocedural flow) rules —
        # tests/test_torch_dataflow.py
        "wall-clock-flow", "rng-flow", "fs-order-flow",
        "publish-path-flow", "lease-isolation",
        # concurrency rules — tests/test_torch_concurrency_rules.py
        "thread-escape", "lock-order", "signal-safety",
        "env-read-after-spawn",
    }
    assert ids == [r.id for r in REF.all_rules()]


def test_unknown_rule_filter_raises():
    with pytest.raises(ValueError, match="unknown rule"):
        analysis.get_rules(["no-such-rule"])


def test_inline_suppression_same_line():
    src = ("import os\n"
           "names = os.listdir(d)  # lddl: disable=unsorted-iteration\n")
    findings, suppressed = analysis.analyze_source(src, "lddl_tpu_torch/x.py")
    assert rule_ids(findings) == []
    assert rule_ids(suppressed) == ["unsorted-iteration"]


def test_inline_suppression_comment_line_above():
    src = ("import os\n"
           "# why: count only -- lddl: disable=unsorted-iteration\n"
           "names = os.listdir(d)\n")
    findings, suppressed = analysis.analyze_source(src, "lddl_tpu_torch/x.py")
    assert rule_ids(findings) == []
    assert rule_ids(suppressed) == ["unsorted-iteration"]


def test_suppression_is_rule_specific():
    src = "import os\nnames = os.listdir(d)  # lddl: disable=wall-clock\n"
    findings, _ = analysis.analyze_source(src, "lddl_tpu_torch/x.py")
    assert rule_ids(findings) == ["unsorted-iteration"]


def test_baseline_matches_on_rule_path_and_line_text():
    src = "import os\nnames = os.listdir(d)\n"
    findings, _ = analysis.analyze_source(src, "lddl_tpu_torch/x.py")
    [f] = findings
    entry = analysis.baseline_entry(f, "grandfathered")
    new, old = analysis.split_baselined([f], [entry])
    assert (new, old) == ([], [f])
    # A different line text (the code changed) is a NEW finding again.
    entry2 = dict(entry, match="something_else()")
    new, old = analysis.split_baselined([f], [entry2])
    assert (new, old) == ([f], [])


# ---------------------------------------------------------- rule fixtures


def test_global_rng_true_positives():
    src = """
    import random
    import numpy as np

    def pick(files):
        random.shuffle(files)
        g = np.random.default_rng(0)
        np.random.seed(1)
        return files
    """
    ids = rule_ids(check(src, "lddl_tpu_torch/loader/x.py", ["global-rng"]))
    assert ids == ["global-rng"] * 3


def test_global_rng_allows_keyed_streams_and_allowlisted_files():
    src = """
    import numpy as np
    from lddl_tpu_torch.utils.rng import sample_rng

    def pick(seed):
        g = sample_rng(seed)          # keyed stream: fine
        r = g.random(4)               # method on a Generator: fine
        k = np.random.Philox(key=[1]) # explicit keying: fine
        return r, k
    """
    assert check(src, "lddl_tpu_torch/loader/x.py", ["global-rng"]) == []
    # The allowlisted owners may construct whatever they need.
    bad = "import numpy as np\ng = np.random.default_rng(0)\n"
    assert check(bad, "lddl_tpu_torch/utils/rng.py", ["global-rng"]) == []
    assert check(bad, "lddl_tpu_torch/testing.py", ["global-rng"]) == []


def test_wall_clock_true_positive_and_aliased_import():
    src = """
    import time
    from datetime import datetime

    def shard_name(i):
        return "shard-{}-{}".format(i, time.time())

    def stamp():
        return datetime.now()
    """
    ids = rule_ids(check(src, "lddl_tpu_torch/preprocess/x.py",
                         ["wall-clock"]))
    assert ids == ["wall-clock"] * 2


def test_wall_clock_allows_observability_and_monotonic():
    bad = "import time\nts = time.time()\n"
    assert check(bad, "lddl_tpu_torch/observability/tracing.py",
                 ["wall-clock"]) == []
    assert check(bad, "lddl_tpu_torch/benchmarks/foo_bench.py",
                 ["wall-clock"]) == []
    ok = "import time\nt0 = time.monotonic()\nt1 = time.perf_counter()\n"
    assert check(ok, "lddl_tpu_torch/preprocess/x.py", ["wall-clock"]) == []


def test_atomic_publish_flags_moves_everywhere():
    src = """
    import os
    import shutil

    def publish(tmp, dst):
        os.replace(tmp, dst)
        os.rename(tmp, dst)
        shutil.move(tmp, dst)
    """
    ids = rule_ids(check(src, "lddl_tpu_torch/preprocess/x.py",
                         ["atomic-publish"]))
    assert ids == ["atomic-publish"] * 3
    # ...including outside the shard packages (the old grep lint's scope).
    ids = rule_ids(check(src, "lddl_tpu_torch/observability/x.py",
                         ["atomic-publish"]))
    assert ids == ["atomic-publish"] * 3


def test_atomic_publish_flags_raw_parquet_and_write_open():
    src = """
    import pyarrow.parquet as pq

    def sink(table, path, rows):
        pq.write_table(table, path)
        with open(path + ".txt", "w") as f:
            f.write(rows)
    """
    ids = rule_ids(check(src, "lddl_tpu_torch/preprocess/x.py",
                         ["atomic-publish"]))
    assert ids == ["atomic-publish"] * 2


def test_atomic_publish_allows_resilience_io_and_reads():
    src = "import os\nos.replace('a', 'b')\n"
    assert check(src, "lddl_tpu_torch/resilience/io.py",
                 ["atomic-publish"]) == []
    ok = "rows = open(path).read()\nmore = open(path, 'rb').read()\n"
    assert check(ok, "lddl_tpu_torch/preprocess/x.py",
                 ["atomic-publish"]) == []


def test_unsorted_iteration_true_positives():
    src = """
    import glob
    import os

    def shards(d):
        return [n for n in os.listdir(d) if ".parquet" in n]

    def parts(d):
        for p in glob.glob(d + "/part.*"):
            yield p
    """
    ids = rule_ids(check(src, "lddl_tpu_torch/balance/x.py",
                         ["unsorted-iteration"]))
    assert ids == ["unsorted-iteration"] * 2


def test_unsorted_iteration_allows_sorted_and_reductions():
    src = """
    import glob
    import os

    def shards(d):
        return sorted(n for n in os.listdir(d) if ".parquet" in n)

    def count(d):
        return len(os.listdir(d))

    def names(d):
        return set(os.listdir(d)) | {s for s in glob.glob(d + "/*")}
    """
    assert check(src, "lddl_tpu_torch/balance/x.py",
                 ["unsorted-iteration"]) == []


def test_swallowed_error_true_positives():
    src = """
    def load(path):
        try:
            return open(path).read()
        except:
            return None

    def sweep(path):
        import os
        try:
            os.remove(path)
        except OSError:
            pass
    """
    ids = rule_ids(check(src, "lddl_tpu_torch/loader/x.py",
                         ["swallowed-error"]))
    assert ids == ["swallowed-error"] * 2


def test_swallowed_error_allows_handled_oserror():
    src = """
    def read_or_default(path):
        try:
            return open(path).read()
        except OSError:
            return ""
    """
    assert check(src, "lddl_tpu_torch/loader/x.py", ["swallowed-error"]) == []


def test_stage_span_missing_span_is_flagged():
    src = """
    def balance_shards(in_dir, out_dir):
        return do_work(in_dir, out_dir)
    """
    ids = rule_ids(check(src, "lddl_tpu_torch/balance/balancer.py",
                         ["stage-span"]))
    assert ids == ["stage-span"]
    # Non-entry files carry no span obligation.
    assert check(src, "lddl_tpu_torch/balance/other.py", ["stage-span"]) == []


def test_stage_span_present_span_passes():
    src = """
    from .. import observability as obs

    def balance_shards(in_dir, out_dir):
        with obs.span("balance.run"):
            return do_work(in_dir, out_dir)
    """
    assert check(src, "lddl_tpu_torch/balance/balancer.py",
                 ["stage-span"]) == []


def test_stage_span_covers_elastic_and_ingest_entry_points():
    """The elastic claim loop and the streaming-ingest service are stage
    entry points too: steal.py owes BOTH its gather and finalize spans
    (one finding per missing name), incremental.py owes ingest.run."""
    bare = """
    def run_elastic_pipeline(spec):
        return claim(spec)
    """
    ids = rule_ids(check(bare, "lddl_tpu_torch/preprocess/steal.py",
                         ["stage-span"]))
    assert ids == ["stage-span", "stage-span"]
    partial = """
    from .. import observability as obs

    def run_elastic_pipeline(spec):
        with obs.span("preprocess.gather", elastic=True):
            return claim(spec)
    """
    assert len(check(partial, "lddl_tpu_torch/preprocess/steal.py",
                     ["stage-span"])) == 1  # finalize still missing
    full = partial + """
    def _finalize(spec):
        with obs.span("preprocess.finalize"):
            return done(spec)
    """
    assert check(full, "lddl_tpu_torch/preprocess/steal.py",
                 ["stage-span"]) == []
    assert rule_ids(check(bare, "lddl_tpu_torch/ingest/incremental.py",
                          ["stage-span"])) == ["stage-span"]
    ok = """
    from .. import observability as obs

    def ingest_once(root):
        with obs.span("ingest.run", root=root):
            return body(root)
    """
    assert check(ok, "lddl_tpu_torch/ingest/incremental.py",
                 ["stage-span"]) == []


def test_jit_host_effect_true_positives():
    src = """
    import functools
    import jax
    from .. import observability as obs

    def _impl(x, scale):
        print("tracing", x)
        obs.inc("steps_total")
        return float(x) * scale

    def make(scale):
        impl = functools.partial(_impl, scale=scale)
        return jax.jit(impl)

    @jax.jit
    def decorated(x):
        import time
        t = time.perf_counter()
        return x * t
    """
    ids = rule_ids(check(src, "lddl_tpu_torch/ops/x.py", ["jit-host-effect"]))
    assert sorted(ids) == ["jit-host-effect"] * 4


def test_jit_host_effect_ignores_unjitted_and_other_packages():
    src = """
    def helper(x):
        print("host-side is fine here")
        return float(x)
    """
    assert check(src, "lddl_tpu_torch/ops/x.py", ["jit-host-effect"]) == []
    jit_src = """
    import jax

    @jax.jit
    def f(x):
        print(x)
        return x
    """
    # Rule is scoped to ops/ and models/ only.
    assert check(jit_src, "lddl_tpu_torch/loader/x.py",
                 ["jit-host-effect"]) == []
    assert rule_ids(check(jit_src, "lddl_tpu_torch/models/x.py",
                          ["jit-host-effect"])) == ["jit-host-effect"]


def test_manifest_determinism_true_positive():
    src = """
    import os
    import time

    def build_manifest(names):
        return {"at": time.time(), "pid": os.getpid(),
                "shards": sorted(names)}

    def _ledger_write(out_dir, written):
        import uuid
        return {"id": str(uuid.uuid4()), "written": written}
    """
    ids = rule_ids(check(src, "lddl_tpu_torch/resilience/x.py",
                         ["manifest-determinism"]))
    assert ids == ["manifest-determinism"] * 3


def test_manifest_determinism_ignores_other_functions():
    src = """
    import time

    def progress_meter():
        return time.time()
    """
    assert check(src, "lddl_tpu_torch/resilience/x.py",
                 ["manifest-determinism"]) == []


# ------------------------------------------------------------ the CI gate


def test_python_hot_loop_true_positives():
    src = """
        import numpy as np

        def decode(b):
            for row in b.to_pydict()["A"]:
                yield row

        def collate(token_lists, vocab):
            return np.fromiter(
                (vocab[t] for ts in token_lists for t in ts),
                dtype=np.int32)

        def lens(col):
            return [v.as_py() for v in col]
    """
    findings = check(src, "lddl_tpu_torch/loader/custom.py",
                     rules=["python-hot-loop"])
    assert rule_ids(findings) == ["python-hot-loop"] * 3


def test_python_hot_loop_scoped_to_loader_and_suppressible():
    src = """
        def anywhere(col):
            return col.to_pylist()
    """
    # The rule covers the loader AND the offline hot stages (preprocess/
    # balance, whose per-token loops the ROADMAP's native-preprocess item
    # targets) — but not e.g. models/ or tools/.
    assert rule_ids(check(src, "lddl_tpu_torch/preprocess/x.py",
                          rules=["python-hot-loop"])) == ["python-hot-loop"]
    assert rule_ids(check(src, "lddl_tpu_torch/balance/x.py",
                          rules=["python-hot-loop"])) == ["python-hot-loop"]
    assert check(src, "lddl_tpu_torch/models/x.py",
                 rules=["python-hot-loop"]) == []
    assert check(src, "lddl_tpu_torch/tools/x.py",
                 rules=["python-hot-loop"]) == []
    supp = """
        def legacy(b):
            return b.to_pydict()  # v1 shards -- lddl: disable=python-hot-loop
    """
    assert check(supp, "lddl_tpu_torch/loader/x.py",
                 rules=["python-hot-loop"]) == []
    # Per-SAMPLE (single-generator) fromiter and map() stay allowed:
    # lengths and offsets are per-row work, not per-token.
    ok = """
        import numpy as np

        def lens(seqs):
            return np.fromiter((len(s) for s in seqs), dtype=np.int64)
    """
    assert check(ok, "lddl_tpu_torch/loader/x.py",
                 rules=["python-hot-loop"]) == []


def test_full_tree_has_zero_non_baselined_findings():
    """THE gate: every invariant holds over lddl_tpu_torch/ right now,
    modulo the committed, justified baseline."""
    report = analysis.run_check(["lddl_tpu_torch"])
    assert report.errors == []
    assert report.new == [], "\n".join(f.format() for f in report.new)
    assert report.files > 90
    # The fixes the port's tree needed leave no baselined finding in the
    # files they touched.
    assert {f.path for f in report.baselined} <= {
        "lddl_tpu_torch/download/common_crawl.py",
        "lddl_tpu_torch/resilience/faults.py",
        "lddl_tpu_torch/resilience/io.py"}


def test_baseline_is_bounded_and_justified():
    entries = analysis.load_baseline(
        os.path.join(REPO_ROOT, analysis.DEFAULT_BASELINE))
    assert analysis.DEFAULT_BASELINE == os.path.join(
        "lddl_tpu_torch", "tools", "lddl_check_baseline.json")
    assert 0 < len(entries) <= 10
    for e in entries:
        assert e.get("reason", "").strip(), \
            "baseline entry without a justification: {}".format(e)
        assert "TODO" not in e["reason"]
        assert e["path"].startswith("lddl_tpu_torch/")


def test_analyzers_keep_their_own_artifacts():
    """Two analyzers, one tree: the port's cache, SARIF and baseline have
    names of their own (a shared cache would replay the other scope's
    findings), and the status tool reads the port's SARIF."""
    from lddl_tpu_torch.tools import pipeline_status
    assert PORT.DEFAULT_CACHE == ".lddl_tpu_torch_check_cache.json"
    assert PORT.DEFAULT_SARIF == "lddl_tpu_torch_check.sarif"
    assert pipeline_status.DEFAULT_SARIF == PORT.DEFAULT_SARIF
    assert PORT.DEFAULT_CACHE != REF.DEFAULT_CACHE
    assert PORT.DEFAULT_BASELINE != REF.DEFAULT_BASELINE
    assert PORT.REPO_ROOT == REF.REPO_ROOT
    with open(os.path.join(REPO_ROOT, ".gitignore")) as f:
        ignored = f.read().split()
    assert PORT.DEFAULT_CACHE in ignored and PORT.DEFAULT_SARIF in ignored


def test_scopes_name_only_the_port_tree():
    """Every allow/only pattern and engine scope names a port path, and
    none of them matches a lddl_tpu/ path (``lddl_tpu_torch/`` is not a
    prefix the reference's tree can match, and the reverse)."""
    from lddl_tpu_torch.analysis import (concurrency, dataflow, flow_rules,
                                         rules)
    pats = [p for r in PORT.all_rules()
            for p in tuple(r.allow) + tuple(r.only or ())]
    pats += list(flow_rules.SHARD_PKGS) + list(flow_rules.SANCTIONED)
    pats += list(flow_rules.PUBLISH_SOURCE_EXEMPT)
    pats += list(rules._SHARD_PKGS) + list(rules.STAGE_SPANS)
    prefixes = list(concurrency.ENV_SOURCE_EXEMPT_PREFIXES) + list(
        concurrency.SIGNAL_BLOCKING_SANCTIONED_PREFIXES)
    assert pats and prefixes
    for p in pats + prefixes + [dataflow.LEASE_MODULE]:
        assert p.startswith("lddl_tpu_torch/"), p
    for ref_file in ("lddl_tpu/utils/rng.py", "lddl_tpu/resilience/io.py",
                     "lddl_tpu/observability/fleet.py",
                     "lddl_tpu/preprocess/runner.py"):
        assert not any(PORT.core._match_any(ref_file, [p]) for p in pats)
        assert not any(ref_file.startswith(p) for p in prefixes)


def test_introducing_a_bad_snippet_fails_the_tree(tmp_path):
    """End-to-end: drop one bad fixture file into an analyzed tree and the
    checker (API and CLI alike) must go red."""
    pkg = tmp_path / "lddl_tpu_fixture"
    pkg.mkdir()
    bad = pkg / "regression.py"
    bad.write_text("import os\n\n"
                   "def publish(tmp, dst):\n"
                   "    os.replace(tmp, dst)\n")
    report = analysis.run_check([str(bad)], root=str(tmp_path))
    assert [f.rule for f in report.new] == ["atomic-publish"]
    assert not report.ok
    proc = subprocess.run(
        CLI + [str(bad), "--baseline", "", "--no-cache"],
        cwd=REPO_ROOT, capture_output=True, text=True, env=ENV)
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert "[atomic-publish]" in proc.stdout


def test_cli_json_mode_and_exit_codes(tmp_path):
    proc = subprocess.run(CLI + ["--json"], cwd=REPO_ROOT,
                          capture_output=True, text=True, env=ENV)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    payload = json.loads(proc.stdout)
    assert payload["ok"] is True
    assert payload["findings"] == []
    assert payload["files"] > 50
    assert len(payload["baselined"]) <= 10
    assert all(f["path"].startswith("lddl_tpu_torch/")
               for f in payload["baselined"] + payload["suppressed"])

    # A tree with a violation exits 1 and reports it in JSON.
    bad = tmp_path / "bad.py"
    bad.write_text("import random\nrandom.shuffle([1, 2])\n")
    proc = subprocess.run(
        CLI + [str(bad), "--baseline", "", "--json", "--no-cache"],
        cwd=REPO_ROOT, capture_output=True, text=True, env=ENV)
    assert proc.returncode == 1
    payload = json.loads(proc.stdout)
    assert [f["rule"] for f in payload["findings"]] == ["global-rng"]


def test_nonexistent_path_is_a_loud_error():
    """A typo'd path must not make the gate silently green (0 files,
    exit 0)."""
    with pytest.raises(FileNotFoundError, match="lddl_tpu_torchh"):
        analysis.run_check(["lddl_tpu_torchh"])
    proc = subprocess.run(CLI + ["lddl_tpu_torchh"], cwd=REPO_ROOT,
                          capture_output=True, text=True, env=ENV)
    assert proc.returncode == 2
    assert "does not exist" in proc.stderr


def test_write_baseline_refuses_filtered_runs(tmp_path):
    """--write-baseline from a --rules/paths/changed-only-filtered run
    would silently drop every grandfathered entry outside the filter."""
    baseline = tmp_path / "b.json"
    for extra in (["--rules", "wall-clock"], ["lddl_tpu_torch/loader"],
                  ["--changed-only"]):
        proc = subprocess.run(
            CLI + ["--write-baseline", "--baseline", str(baseline)] + extra,
            cwd=REPO_ROOT, capture_output=True, text=True, env=ENV)
        assert proc.returncode == 2, proc.stdout + proc.stderr
        assert "full run" in proc.stderr
        assert not baseline.exists()


def test_write_baseline_keeps_reasons(tmp_path):
    """A full --write-baseline run rewrites the same entries with their
    reasons kept (the committed file is what it would write)."""
    baseline = tmp_path / "b.json"
    with open(os.path.join(REPO_ROOT, PORT.DEFAULT_BASELINE)) as f:
        committed = json.load(f)
    baseline.write_text(json.dumps(committed))
    proc = subprocess.run(
        CLI + ["--write-baseline", "--no-cache", "--baseline",
               str(baseline)],
        cwd=REPO_ROOT, capture_output=True, text=True, env=ENV)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert json.loads(baseline.read_text()) == committed


def _sarif_of(path):
    with open(path) as f:
        sarif = json.load(f)
    assert sarif["version"] == "2.1.0"
    return sarif["runs"][0]


def test_ci_check_script():
    """The port's static gate (--full): analyzer + syntax pass + SARIF
    artifact at the repo root, under the port's own name."""
    sarif_path = os.path.join(REPO_ROOT, PORT.DEFAULT_SARIF)
    ref_sarif = os.path.join(REPO_ROOT, "lddl_check.sarif")
    ref_before = os.path.getmtime(ref_sarif) \
        if os.path.exists(ref_sarif) else None
    proc = subprocess.run(
        ["bash", os.path.join(REPO_ROOT, "lddl_tpu_torch", "tools",
                              "ci_check.sh"), "--full"],
        cwd=REPO_ROOT, capture_output=True, text=True, env=ENV)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "ci_check: OK" in proc.stdout
    assert "SARIF artifact" in proc.stdout
    try:
        run = _sarif_of(sarif_path)
    finally:
        os.unlink(sarif_path)
    assert run["tool"]["driver"]["name"] == "lddl-check"
    # Zero gating results; grandfathered debt rides along as "unchanged".
    assert all(r.get("baselineState") == "unchanged"
               for r in run["results"])
    assert all(r["locations"][0]["physicalLocation"]["artifactLocation"]
               ["uri"].startswith("lddl_tpu_torch/") for r in run["results"])
    rule_ids = {r["id"] for r in run["tool"]["driver"]["rules"]}
    assert "fs-order-flow" in rule_ids
    assert len(rule_ids) == len(PORT.RULE_IDS)
    # The reference's artifact is neither written nor touched.
    assert (os.path.getmtime(ref_sarif)
            if os.path.exists(ref_sarif) else None) == ref_before


def test_ci_check_script_default_is_changed_only():
    """Without --full the gate reports only files changed vs HEAD — the
    pre-commit fast path (analysis still spans the tree via the cache)."""
    proc = subprocess.run(
        ["bash", os.path.join(REPO_ROOT, "lddl_tpu_torch", "tools",
                              "ci_check.sh")],
        cwd=REPO_ROOT, capture_output=True, text=True, env=ENV)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "ci_check: OK" in proc.stdout
    assert "SARIF" not in proc.stdout


def test_full_tree_run_is_inside_its_time_budget():
    """The analyzer rides tier-1 on every test run: a cold full-tree run
    (parse + per-file rules + whole-program fixpoint, no cache) must stay
    well under a minute, and the wall time must be reported so
    regressions are visible in CI output."""
    report = analysis.run_check(["lddl_tpu_torch"], cache_path=None)
    assert report.elapsed_s < 60.0, \
        "analyzer blew its budget: {:.1f}s".format(report.elapsed_s)
    proc = subprocess.run(CLI, cwd=REPO_ROOT, capture_output=True,
                          text=True, env=ENV)
    assert re.search(r"in \d+\.\d\ds", proc.stdout), proc.stdout


def test_cli_changed_only_mode(tmp_path):
    """--changed-only restricts the REPORT to changed files while the
    analysis still spans the paths; with a clean tree it reports nothing
    and exits 0. Where git is absent it falls back to a full report."""
    proc = subprocess.run(CLI + ["--changed-only"], cwd=REPO_ROOT,
                          capture_output=True, text=True, env=ENV)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    no_git = dict(ENV, PATH=str(tmp_path))
    proc = subprocess.run(CLI + ["--changed-only", "--json"],
                          cwd=REPO_ROOT, capture_output=True, text=True,
                          env=no_git)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "falling back to a full report" in proc.stderr
    payload = json.loads(proc.stdout)
    assert payload["files"] > 50 and len(payload["baselined"]) > 0


def test_changed_only_sees_files_in_untracked_directories(tmp_path):
    """A brand-new package directory shows up as `?? newdir/` in plain
    porcelain output; -uall must expand it so its .py files are not
    silently excluded from the changed-only report."""
    from lddl_tpu_torch.tools.lddl_check import changed_python_files
    subprocess.run(["git", "init", "-q"], cwd=tmp_path, check=True)
    pkg = tmp_path / "newpkg"
    pkg.mkdir()
    (pkg / "mod.py").write_text("x = 1\n")
    changed = changed_python_files(str(tmp_path))
    assert changed == {"newpkg/mod.py"}


def test_cli_sarif_output(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import random\nrandom.shuffle([1, 2])\n")
    out = tmp_path / "report.sarif"
    proc = subprocess.run(
        CLI + [str(bad), "--baseline", "", "--sarif", str(out),
               "--no-cache"],
        cwd=REPO_ROOT, capture_output=True, text=True, env=ENV)
    assert proc.returncode == 1
    sarif = json.loads(out.read_text())
    [result] = sarif["runs"][0]["results"]
    assert result["ruleId"] == "global-rng"
    assert result["level"] == "error"
    loc = result["locations"][0]["physicalLocation"]
    assert loc["region"]["startLine"] == 2


def test_cli_list_rules_names_every_rule():
    proc = subprocess.run(CLI + ["--list-rules"], cwd=REPO_ROOT,
                          capture_output=True, text=True, env=ENV)
    assert proc.returncode == 0
    listed = [line.split()[0] for line in proc.stdout.splitlines()]
    assert listed == list(PORT.RULE_IDS) == list(REF.RULE_IDS)


# ----------------------------- ordered-iteration determinism (satellite)


def test_shard_enumeration_is_immune_to_filesystem_order(monkeypatch):
    """The port's shard-listing helpers cannot leak FS order.
    os.walk/os.listdir are patched to yield entries REVERSED; every
    enumeration the pipeline consumes must come back sorted anyway."""
    import tempfile
    from lddl_tpu_torch.resilience import integrity
    from lddl_tpu_torch.utils import fs

    real_walk, real_listdir = os.walk, os.listdir

    def reversed_walk(top, **kw):
        for dirpath, dirnames, filenames in real_walk(top, **kw):
            yield dirpath, list(reversed(sorted(dirnames))), \
                list(reversed(sorted(filenames)))

    def reversed_listdir(path):
        return list(reversed(sorted(real_listdir(path))))

    with tempfile.TemporaryDirectory() as d:
        for name in ("part.2.parquet", "part.0.parquet", "part.1.parquet",
                     ".num_samples.json"):
            with open(os.path.join(d, name), "w") as f:
                f.write("x")
        monkeypatch.setattr(os, "walk", reversed_walk)
        monkeypatch.setattr(os, "listdir", reversed_listdir)

        paths = fs.get_all_parquets_under(d)
        assert paths == sorted(paths) and len(paths) == 3
        assert fs.get_all_files_paths_under(d) == sorted(
            os.path.join(d, n) for n in real_listdir(d))

        manifest = integrity.build_manifest(d)
        assert [n for n in manifest if not n.startswith("__")] == [
            "part.0.parquet", "part.1.parquet", "part.2.parquet"]


def test_balancer_stale_guard_reports_deterministically(monkeypatch,
                                                        tmp_path):
    """The port's balancer dirty-output guard sorts its listing: the
    reported example shard is the lexicographic first regardless of FS
    enumeration order."""
    from lddl_tpu_torch.balance.balancer import balance_shards

    out = tmp_path / "out"
    out.mkdir()
    for name in ("zzz.parquet", "aaa.parquet"):
        (out / name).write_text("x")
    real_listdir = os.listdir
    monkeypatch.setattr(
        os, "listdir",
        lambda p: list(reversed(sorted(real_listdir(p)))))
    with pytest.raises(ValueError, match=r"e\.g\. aaa\.parquet"):
        balance_shards(str(tmp_path / "nothing"), str(out), 2)


def test_object_store_generations_are_listed_in_order(monkeypatch,
                                                      tmp_path):
    """The mock object store's generation listing and its garbage
    collector see commit records in generation order whatever order the
    filesystem lists them in, as lddl_tpu's do: each package's collector
    deletes the same files in the same order. (The port listed them
    unsorted and collected in filesystem order.)"""
    import importlib
    real_listdir, real_unlink = os.listdir, os.unlink
    monkeypatch.setattr(
        os, "listdir", lambda p: list(reversed(sorted(real_listdir(p)))))
    order = {}
    for pkg in ("lddl_tpu", "lddl_tpu_torch"):
        backend = importlib.import_module(pkg + ".resilience.backend")
        store = backend.MockObjectStore()
        path = str(tmp_path / pkg / "obj.bin")
        os.makedirs(os.path.dirname(path))
        deleted = []

        def unlink(p, _deleted=deleted, _root=str(tmp_path / pkg)):
            _deleted.append(os.path.relpath(p, _root))
            return real_unlink(p)

        monkeypatch.setattr(os, "unlink", unlink)
        for i in range(6):
            store.put_atomic(path, "v{}".format(i).encode())
        monkeypatch.setattr(os, "unlink", real_unlink)
        odir = store._obj_dir(path)
        order[pkg] = [d for d in deleted if d.endswith(".json")]
        if pkg == "lddl_tpu_torch":
            gens = store._gens(odir)
            assert gens == sorted(gens) and len(gens) >= 2
    assert order["lddl_tpu_torch"] == order["lddl_tpu"]
    assert order["lddl_tpu"] == sorted(order["lddl_tpu"])
    assert len(order["lddl_tpu"]) >= 2
