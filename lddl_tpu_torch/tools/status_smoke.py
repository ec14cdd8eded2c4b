"""CI smoke for the diagnosis surface: a small fleet-armed preprocess ->
balance -> load run through the port's CLIs and loader, then
``python -m lddl_tpu_torch.tools.pipeline_status`` driven as an operator
(or a CI gate) drives it.

Run from the repository root::

    python -m lddl_tpu_torch.tools.status_smoke

``lddl_tpu_torch/tools/ci_check.sh`` runs it under
``LDDL_TPU_CI_SMOKE_BENCH=1``. ``LDDL_TPU_STATUS_SMOKE_MB`` sizes the
corpus (default 0.5). Its contract, each part gating:

- ``pipeline_status --json --window 600`` exits 0, parses, reports
  windowed rates from the series segments and carries the loader's
  bound-verdict attribution (the loader leg really iterated batches)
  (``check_healthy``);
- a rule that must fire forces exit code 2 with exactly it firing
  (``check_tripped``);
- the relaxed rules file then exits 0 with the resolve journaled
  (``check_resolved``).

It prints one JSON line with what it found (``"alert_fire_resolve":
true`` on success) and exits 1 on any broken part.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

from .smoke_common import ROOT, cli_env, corpus_with_vocab, smoke_mb

_LOADER_DRIVER = """
import os, sys, time
data, vocab = sys.argv[1], sys.argv[2]
os.environ["LDDL_TPU_FLEET_DIR"] = data
os.environ["LDDL_TPU_FLEET_HOLDER"] = "loaderhost"
os.environ["LDDL_TPU_FLEET_INTERVAL_S"] = "0.2"
from lddl_tpu_torch.loader import get_bert_pretrain_data_loader
loader = get_bert_pretrain_data_loader(
    data, vocab_file=vocab, batch_size=8, num_workers=0)
n = 0
for batch in loader:
    time.sleep(0.002)  # a (tiny) consumer step, so step_gap is real
    n += 1
print("BATCHES", n)
"""

# The alert rule on the units counter: ">=" 0 always fires, "<" 0 never.
_RULE = {"name": "tripped", "type": "threshold",
         "metric": "totals.counters.units_completed", "value": 0}


def status(data, *extra):
    """(exit code, parsed ``--json`` document or None) of one
    ``pipeline_status`` call on ``data``."""
    proc = subprocess.run(
        [sys.executable, "-m", "lddl_tpu_torch.tools.pipeline_status",
         data, "--json"] + list(extra),
        capture_output=True, text=True, cwd=ROOT, env=cli_env())
    try:
        doc = json.loads(proc.stdout)
    except ValueError:
        print("status smoke: --json did not parse (rc={}):\n{}\n{}".format(
            proc.returncode, proc.stdout[-2000:], proc.stderr[-2000:]),
            file=sys.stderr)
        return proc.returncode, None
    return proc.returncode, doc


def check_healthy(rc, doc):
    """None when the healthy run's status holds the contract, else what
    broke it."""
    if rc != 0:
        return "healthy run exited {} ({})".format(
            rc, doc.get("health", {}).get("verdicts"))
    attr = doc.get("attribution")
    if not attr or "verdict" not in attr:
        return ("no attribution verdict in the rollup (loader leg left no "
                "stage counters?)")
    if not (doc.get("window") or {}).get("rates"):
        return "--window reported no series rates"
    return None


def check_tripped(rc, doc):
    """None when the firing rule forced exit 2 with exactly it firing."""
    firing = doc.get("alerts", {}).get("firing")
    if rc != 2 or firing != ["tripped"]:
        return ("tripped alert rule did not force exit 2 (rc={}, "
                "firing={})".format(rc, firing))
    return None


def check_resolved(rc, doc):
    """None when the relaxed rules exit 0 with one resolve journaled."""
    kinds = [t["kind"] for t in doc.get("alerts", {}).get("transitions",
                                                           [])]
    if rc != 0 or kinds != ["alert.resolved"]:
        return ("relaxed rules did not resolve cleanly (rc={}, "
                "transitions={})".format(rc, kinds))
    return None


def _write_rules(path, op):
    with open(path, "w") as f:
        json.dump({"rules": [dict(_RULE, op=op)]}, f)


def main():
    target_mb = smoke_mb("LDDL_TPU_STATUS_SMOKE_MB", "0.5")
    tmp = tempfile.mkdtemp(prefix="lddl_status_smoke_")
    try:
        corpus, _, vocab, _ = corpus_with_vocab(tmp, target_mb, 300_000)
        pre = os.path.join(tmp, "pre")
        data = os.path.join(tmp, "data")
        env = cli_env()
        t0 = time.perf_counter()
        for cmd in (
            [sys.executable, "-m",
             "lddl_tpu_torch.cli.preprocess_bert_pretrain",
             "--wikipedia", corpus, "--sink", pre,
             "--vocab-file", vocab, "--masking",
             "--bin-size", "32", "--num-blocks", "8",
             "--seed", "7", "--local-workers", "2"],
            [sys.executable, "-m", "lddl_tpu_torch.cli.balance_shards",
             "--indir", pre, "--outdir", data, "--num-shards", "4",
             "--fleet-telemetry"],
            [sys.executable, "-c", _LOADER_DRIVER, data, vocab],
        ):
            rc = subprocess.call(cmd, env=env, cwd=ROOT,
                                 stdout=subprocess.DEVNULL,
                                 stderr=subprocess.STDOUT)
            if rc != 0:
                print("status smoke: leg failed rc={} ({})".format(
                    rc, cmd[2][:60]), file=sys.stderr)
                return 1
        report = {"pipeline_wall_s": round(time.perf_counter() - t0, 1)}

        rules = os.path.join(tmp, "rules.json")
        steps = ((("--window", "600"), None, check_healthy),
                 (("--alerts", rules), ">=", check_tripped),
                 (("--alerts", rules), "<", check_resolved))
        for args, op, check in steps:
            if op is not None:
                _write_rules(rules, op)
            rc, doc = status(data, *args)
            if doc is None:
                return 1
            broken = check(rc, doc)
            if broken:
                print("status smoke: " + broken, file=sys.stderr)
                return 1
            if check is check_healthy:
                attr = doc["attribution"]
                report["verdict"] = attr["verdict"]
                report["input_share"] = round(attr.get("input_share", 0.0),
                                              3)
                report["windowed_metrics"] = len(doc["window"]["rates"])
        report["alert_fire_resolve"] = True
        print(json.dumps(report, sort_keys=True))
        return 0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
