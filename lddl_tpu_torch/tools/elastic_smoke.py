"""CI smoke for elastic coordination: two ``--elastic`` preprocess
processes on one small corpus, legacy (``LDDL_TPU_COORD_LEGACY=1``)
against batched coordination, shard byte identity gated, the lease
operations per unit reported.

Run from the repository root::

    python -m lddl_tpu_torch.tools.elastic_smoke

``lddl_tpu_torch/tools/ci_check.sh`` runs it under
``LDDL_TPU_CI_SMOKE_BENCH=1``. ``LDDL_TPU_ELASTIC_SMOKE_MB`` sizes the
corpus (default 2). It prints one JSON line::

    {"identical": true, "ops_per_unit": {"legacy": ..., "batched": ...},
     "ops_per_unit_ratio": ..., "units": {...}, "wall_s": {...},
     "host_can_show_scaling": ...}

and exits 1 when a leg fails or the two legs' shards differ. The lease
op ratio is informational: the coordination protocol must never reach
shard bytes, and that is what gates.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

from .smoke_common import (ROOT, cli_env, corpus_with_vocab, identical,
                           parquet_digests, smoke_mb)


def counter(out_dir, metric, label=None):
    """A counter summed over every host's telemetry spool snapshots
    (``<out>/.telemetry/<holder>/snapshot-pid*.json``)."""
    total = 0
    tel = os.path.join(out_dir, ".telemetry")
    if not os.path.isdir(tel):
        return total
    for holder in sorted(os.listdir(tel)):
        d = os.path.join(tel, holder)
        if not os.path.isdir(d):
            continue
        merged = {}
        for name in sorted(os.listdir(d)):
            if not (name.startswith("snapshot-pid")
                    and name.endswith(".json")):
                continue
            try:
                with open(os.path.join(d, name), encoding="utf-8") as f:
                    snap = json.load(f)
            except (OSError, ValueError):
                continue
            values = ((snap.get("metrics") or {}).get(metric)
                      or {}).get("values") or {}
            for k, v in values.items():
                merged[k] = merged.get(k, 0) + v
        total += sum(v for k, v in merged.items()
                     if label is None or k == label)
    return total


def main():
    target_mb = smoke_mb("LDDL_TPU_ELASTIC_SMOKE_MB", "2")
    tmp = tempfile.mkdtemp(prefix="lddl_elastic_smoke_")
    try:
        from ..utils.cpus import usable_cpu_count

        corpus, _, vocab, _ = corpus_with_vocab(tmp, target_mb, 300_000)

        def cli(sink, holder):
            return [sys.executable, "-m",
                    "lddl_tpu_torch.cli.preprocess_bert_pretrain",
                    "--wikipedia", corpus, "--sink", sink,
                    "--vocab-file", vocab, "--masking",
                    "--bin-size", "32", "--num-blocks", "16",
                    "--seed", "7", "--local-workers", "1",
                    "--elastic", "--lease-ttl", "5",
                    "--elastic-host-id", holder, "--fleet-telemetry"]

        report = {"ops_per_unit": {}, "ops_per_unit_ratio": None,
                  "units": {}, "wall_s": {},
                  "host_can_show_scaling": usable_cpu_count() >= 2}
        digests = {}
        for mode, env_extra in (("legacy", {"LDDL_TPU_COORD_LEGACY": "1"}),
                                ("batched", {})):
            sink = os.path.join(tmp, mode)
            env = cli_env(**env_extra)
            t0 = time.perf_counter()
            procs = [subprocess.Popen(cli(sink, "s{}".format(i)), env=env,
                                      cwd=ROOT, stdout=subprocess.DEVNULL,
                                      stderr=subprocess.STDOUT)
                     for i in range(2)]
            rcs = [p.wait(timeout=1200) for p in procs]
            report["wall_s"][mode] = round(time.perf_counter() - t0, 1)
            if rcs != [0, 0]:
                print("elastic smoke: {} leg failed rc={}".format(
                    mode, rcs), file=sys.stderr)
                return 1
            ops = counter(sink, "lease_ops_total")
            units = counter(sink, "elastic_units_completed_total")
            report["units"][mode] = units
            report["ops_per_unit"][mode] = round(ops / max(units, 1), 2)
            digests[mode] = parquet_digests(sink)
        report["identical"] = identical(digests["legacy"],
                                        digests["batched"])
        if report["ops_per_unit"]["batched"]:
            report["ops_per_unit_ratio"] = round(
                report["ops_per_unit"]["legacy"]
                / report["ops_per_unit"]["batched"], 2)
        print(json.dumps(report, sort_keys=True))
        if not report["identical"]:
            print("elastic smoke: legacy and batched coordination shipped "
                  "DIFFERENT bytes", file=sys.stderr)
            return 1
        return 0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
