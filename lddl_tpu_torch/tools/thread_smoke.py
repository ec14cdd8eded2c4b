"""CI smoke for the native engine's thread pool: the preprocess of one
small corpus at 1 and at N kernel threads (``LDDL_TPU_NATIVE_THREADS``),
byte identity of shards and manifests gated, plus an informational
tokenize MB/s per thread count.

Run from the repository root::

    python -m lddl_tpu_torch.tools.thread_smoke

``lddl_tpu_torch/tools/ci_check.sh`` runs it under
``LDDL_TPU_CI_SMOKE_BENCH=1``. ``LDDL_TPU_THREAD_SMOKE_MB`` sizes the
corpus (default 2). N is min(4, usable cores), at least 2, so the
partitioned path runs even on one core. It prints one JSON line::

    {"identical": true, "n_threads": ...,
     "tokenize_mb_per_s_by_threads": {"1": ..., "2": ...}, ...}

and exits 1 when the two trees differ: the masking replay is keyed per
sample and the pair streams per document, so no partition may change a
byte. The port has no engine to fall back to, so an engine that does not
build or load fails the smoke.
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
    target_mb = smoke_mb("LDDL_TPU_THREAD_SMOKE_MB", "2")
    tmp = tempfile.mkdtemp(prefix="lddl_thread_smoke_")
    try:
        from ..preprocess import (BertPretrainConfig, get_tokenizer,
                                  run_bert_preprocess)
        from ..preprocess.bert import TokenizerInfo
        from ..utils.cpus import usable_cpu_count

        corpus, nbytes, vocab, sample = corpus_with_vocab(tmp, target_mb,
                                                          500_000)
        tokenizer = get_tokenizer(vocab_file=vocab)

        def run(name, threads):
            os.environ["LDDL_TPU_NATIVE_THREADS"] = str(threads)
            try:
                out = os.path.join(tmp, name)
                run_bert_preprocess(
                    {"wikipedia": corpus}, out, tokenizer,
                    config=BertPretrainConfig(max_seq_length=128,
                                              duplicate_factor=1,
                                              masking=True),
                    num_blocks=8, sample_ratio=1.0, seed=12345,
                    bin_size=32, num_workers=1)
            finally:
                del os.environ["LDDL_TPU_NATIVE_THREADS"]
            return tree_digest(out)

        # At least 2 threads, so the partitioned path runs even where one
        # core is usable (the bytes do not depend on the core count).
        n_threads = max(2, min(4, usable_cpu_count()))
        run("warm", 1)  # the native build and tokenizer tables
        d1 = run("t1", 1)
        dn = run("tn", n_threads)
        same = identical(d1, dn)

        # Informational tokenize MB/s per thread count (a fresh tokenizer
        # for each, so each pays the same memo warm-up).
        rows = {}
        data = [t.encode("utf-8") for t in sample]
        sbytes = float(sum(len(d) for d in data))
        for nt in sorted({1, 2, n_threads}):
            cls, args = TokenizerInfo(tokenizer).native_tokenizer().\
                __reduce__()
            nat = cls(*args)
            nat.set_threads(nt)
            nat.tokenize_docs(data[:8])
            t0 = time.perf_counter()
            reps = 0
            elapsed = 0.0
            while elapsed < 0.5:
                nat.tokenize_docs(data)
                reps += 1
                elapsed = time.perf_counter() - t0
            rows[str(nt)] = round(sbytes * reps / elapsed / 1e6, 2)

        print(json.dumps({
            "smoke": "native-thread identity pair",
            "corpus_mb": round(nbytes / 1024 / 1024, 2),
            "n_threads": n_threads,
            "identical": same,
            "usable_cpus": usable_cpu_count(),
            "tokenize_mb_per_s_by_threads": rows,
        }))
        return 0 if same else 1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
