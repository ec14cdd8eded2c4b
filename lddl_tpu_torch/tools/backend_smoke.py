"""CI smoke for the storage backend: one small corpus through the port's
preprocess -> balance CLIs and the loader twice, on the local
filesystem and on the mock object store (``--storage-backend mock``),
byte identity gated end to end.

Run from the repository root::

    python -m lddl_tpu_torch.tools.backend_smoke

``lddl_tpu_torch/tools/ci_check.sh`` runs it under
``LDDL_TPU_CI_SMOKE_BENCH=1``. ``LDDL_TPU_BACKEND_SMOKE_MB`` sizes the
corpus (default 1). It prints one JSON line::

    {"identical": true, "shards": N, "samples": {"local": n, "mock": n},
     "wall_s": {"local": ..., "mock": ...}, "loader_identical": true}

and exits 1 when a leg fails, the published files differ, or the loader
gives other batches. The backend is publish and coordination plumbing
and must never reach the bytes; the walls are informational.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

from .smoke_common import (ROOT, cli_env, corpus_with_vocab, identical,
                           loader_digest, published_digests, smoke_mb)


def main():
    target_mb = smoke_mb("LDDL_TPU_BACKEND_SMOKE_MB", "1")
    tmp = tempfile.mkdtemp(prefix="lddl_backend_smoke_")
    try:
        corpus, _, vocab, _ = corpus_with_vocab(tmp, target_mb, 300_000)

        report = {"wall_s": {}, "samples": {}}
        pre_digests = {}
        bal_digests = {}
        loads = {}
        for name in ("local", "mock"):
            pre = os.path.join(tmp, "pre_" + name)
            bal = os.path.join(tmp, "bal_" + name)
            env = cli_env()
            # The flag, not the environment variable, is under test: it
            # must set the environment of the CLI's own workers.
            env.pop("LDDL_TPU_STORAGE_BACKEND", None)
            t0 = time.perf_counter()
            for cmd in (
                [sys.executable, "-m",
                 "lddl_tpu_torch.cli.preprocess_bert_pretrain",
                 "--wikipedia", corpus, "--sink", pre,
                 "--vocab-file", vocab, "--masking",
                 "--bin-size", "32", "--num-blocks", "8",
                 "--seed", "7", "--local-workers", "2",
                 "--storage-backend", name],
                [sys.executable, "-m", "lddl_tpu_torch.cli.balance_shards",
                 "--indir", pre, "--outdir", bal, "--num-shards", "4",
                 "--storage-backend", name],
            ):
                rc = subprocess.call(cmd, env=env, cwd=ROOT,
                                     stdout=subprocess.DEVNULL,
                                     stderr=subprocess.STDOUT)
                if rc != 0:
                    print("backend smoke: {} leg failed rc={} ({})".format(
                        name, rc, cmd[2]), file=sys.stderr)
                    return 1
            report["wall_s"][name] = round(time.perf_counter() - t0, 1)
            pre_digests[name] = published_digests(pre)
            bal_digests[name] = published_digests(bal)
            os.environ["LDDL_TPU_STORAGE_BACKEND"] = name
            try:
                n, digest, _ = loader_digest(bal, vocab)
            finally:
                os.environ.pop("LDDL_TPU_STORAGE_BACKEND", None)
            report["samples"][name] = n
            loads[name] = digest
        report["shards"] = sum(1 for p in bal_digests["local"]
                               if ".parquet" in p)
        report["identical"] = (
            identical(pre_digests["local"], pre_digests["mock"])
            and bal_digests["local"] == bal_digests["mock"])
        report["loader_identical"] = (loads["local"] == loads["mock"]
                                      and report["samples"]["local"] > 0)
        print(json.dumps(report, sort_keys=True))
        if not (report["identical"] and report["loader_identical"]):
            print("backend smoke: local and mock backends shipped "
                  "DIFFERENT bytes", file=sys.stderr)
            return 1
        return 0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
