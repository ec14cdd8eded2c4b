"""CI smoke for the async durable sink: serial (``LDDL_TPU_SINK_DEPTH=0``)
against async (depth 2) preprocess of one small corpus, byte identity
gated, the throughput pair reported.

Run from the repository root::

    python -m lddl_tpu_torch.tools.sink_smoke

``lddl_tpu_torch/tools/ci_check.sh`` runs it under
``LDDL_TPU_CI_SMOKE_BENCH=1``. ``LDDL_TPU_SINK_SMOKE_MB`` sizes the
corpus (default 4). It prints one JSON line::

    {"serial_mb_per_s": ..., "async_mb_per_s": ..., "identical": true,
     "sink": {"write_s", "stall_s", "tasks", "units"}, ...}

and exits 1 when the two trees differ in any byte (shards, manifests,
counts). The MB/s pair on a small corpus is informational only.
"""

import json
import os
import shutil
import sys
import tempfile
import time

from .smoke_common import (corpus_with_vocab, identical, smoke_mb,
                           tree_digest)


def main():
    target_mb = smoke_mb("LDDL_TPU_SINK_SMOKE_MB", "4")
    tmp = tempfile.mkdtemp(prefix="lddl_sink_smoke_")
    try:
        from ..preprocess import (BertPretrainConfig, get_tokenizer,
                                  run_bert_preprocess)
        from ..preprocess import sink as sink_mod

        corpus, nbytes, vocab, _ = corpus_with_vocab(tmp, target_mb,
                                                     500_000)
        tokenizer = get_tokenizer(vocab_file=vocab)

        def run(name, depth):
            os.environ["LDDL_TPU_SINK_DEPTH"] = str(depth)
            try:
                out = os.path.join(tmp, name)
                t0 = time.perf_counter()
                run_bert_preprocess(
                    {"wikipedia": corpus}, out, tokenizer,
                    config=BertPretrainConfig(max_seq_length=128,
                                              duplicate_factor=1,
                                              masking=True),
                    num_blocks=8, sample_ratio=1.0, seed=12345,
                    bin_size=32, num_workers=1)
                elapsed = time.perf_counter() - t0
            finally:
                del os.environ["LDDL_TPU_SINK_DEPTH"]
            return nbytes / 1024 / 1024 / elapsed, tree_digest(out)

        # Warm once (native build, tokenizer tables), so the pair compares
        # sink modes, not one-time costs.
        run("warm", 0)
        before = sink_mod.stats_snapshot()
        serial_mb_s, serial_digest = run("serial", 0)
        async_mb_s, async_digest = run("async", 2)
        after = sink_mod.stats_snapshot()
        same = identical(serial_digest, async_digest)
        print(json.dumps({
            "smoke": "async-sink serial-vs-async pair",
            "corpus_mb": round(nbytes / 1024 / 1024, 2),
            "serial_mb_per_s": round(serial_mb_s, 3),
            "async_mb_per_s": round(async_mb_s, 3),
            "identical": same,
            "sink": {k: round(after[k] - before[k], 3)
                     for k in ("write_s", "stall_s", "tasks", "units")},
        }))
        return 0 if same else 1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
