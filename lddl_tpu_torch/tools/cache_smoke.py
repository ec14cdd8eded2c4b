"""CI smoke for the loader's shard I/O pipeline: one small dataset built
on the mock object store, then streamed through the port's BERT loader
three times, synchronously (``LDDL_TPU_LOADER_PREFETCH_SHARDS=0``
``LDDL_TPU_LOADER_CACHE_BYTES=0``), with prefetch and cache cold, and
warm (a second pass over the same shared cache), with a per-op store
latency (``LDDL_TPU_MOCK_LATENCY_MS``) for the pipeline to hide.

Run from the repository root::

    python -m lddl_tpu_torch.tools.cache_smoke

``lddl_tpu_torch/tools/ci_check.sh`` runs it under
``LDDL_TPU_CI_SMOKE_BENCH=1``. ``LDDL_TPU_CACHE_SMOKE_MB`` sizes the
corpus (default 0.5) and ``LDDL_TPU_CACHE_SMOKE_LATENCY_MS`` the latency
(default 10). It prints one JSON line::

    {"identical": true, "samples": n, "shards": N, "latency_ms": ...,
     "wall_s": {"sync": ..., "prefetch_cold": ..., "prefetch_warm": ...},
     "speedup_cold": ..., "speedup_warm": ...}

and exits 1 when a leg delivers other bytes: prefetch depth and cache
budget only schedule the reads. The speedups are informational.
``build(tmp, target_mb)`` and ``LEGS`` are what the chip smoke reuses to
load the same shards onto the card.
"""

import json
import os
import shutil
import sys
import tempfile

from .smoke_common import corpus_with_vocab, loader_digest, smoke_mb

SHARDS = 8

# The loader legs: the environment each pass runs under (None: unset).
LEGS = (("sync", {"LDDL_TPU_LOADER_PREFETCH_SHARDS": "0",
                  "LDDL_TPU_LOADER_CACHE_BYTES": "0"}),
        ("prefetch_cold", {"LDDL_TPU_LOADER_PREFETCH_SHARDS": None,
                           "LDDL_TPU_LOADER_CACHE_BYTES": None}),
        # Same environment, same process: the shared shard cache the cold
        # pass built is still resident, so this is the warm epoch.
        ("prefetch_warm", {"LDDL_TPU_LOADER_PREFETCH_SHARDS": None,
                           "LDDL_TPU_LOADER_CACHE_BYTES": None}))


class leg_env:
    """Apply one leg's environment for the duration of a ``with``."""

    def __init__(self, env):
        self._env, self._saved = env, {}

    def __enter__(self):
        for key, value in self._env.items():
            self._saved[key] = os.environ.pop(key, None)
            if value is not None:
                os.environ[key] = value

    def __exit__(self, *exc):
        for key, value in self._saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value


def build(tmp, target_mb):
    """The smoke's dataset under ``tmp``: ``make_corpus`` -> the port's
    preprocess (max_seq_length 128, masking, schema v2, SHARDS blocks,
    seed 7, unbinned, one worker a usable core) -> ``balance_shards``
    into SHARDS shards, on whatever store ``LDDL_TPU_STORAGE_BACKEND``
    names. Returns (balanced dir, vocab path)."""
    from ..balance import balance_shards
    from ..preprocess import (BertPretrainConfig, get_tokenizer,
                              run_bert_preprocess)
    from ..utils.cpus import usable_cpu_count

    corpus, _, vocab, _ = corpus_with_vocab(tmp, target_mb, 300_000)
    pre = os.path.join(tmp, "pre")
    bal = os.path.join(tmp, "bal")
    run_bert_preprocess(
        {"wikipedia": corpus}, pre, get_tokenizer(vocab_file=vocab),
        config=BertPretrainConfig(max_seq_length=128, duplicate_factor=1,
                                  masking=True, schema_version=2),
        num_blocks=SHARDS, seed=7, bin_size=None,
        num_workers=usable_cpu_count())
    balance_shards(pre, bal, SHARDS)
    return bal, vocab


def identical(legs):
    """The gate: every leg delivered the same, non-zero number of samples
    with the same batch digest (``legs``: [(samples, digest), ...])."""
    return (bool(legs) and legs[0][0] > 0
            and all(leg[:2] == legs[0][:2] for leg in legs))


def main():
    target_mb = smoke_mb("LDDL_TPU_CACHE_SMOKE_MB", "0.5")
    latency_ms = float(os.environ.get("LDDL_TPU_CACHE_SMOKE_LATENCY_MS",
                                      "10"))
    tmp = tempfile.mkdtemp(prefix="lddl_cache_smoke_")
    # Both knobs are set BEFORE the first touch of the store: the backend
    # instance is made once a process, and reads its latency then.
    os.environ["LDDL_TPU_STORAGE_BACKEND"] = "mock"
    os.environ["LDDL_TPU_MOCK_LATENCY_MS"] = str(latency_ms)
    try:
        bal, vocab = build(tmp, target_mb)
        legs = {}
        for name, env in LEGS:
            with leg_env(env):
                legs[name] = loader_digest(bal, vocab)
        t = {name: leg[2] for name, leg in legs.items()}
        report = {
            "identical": identical([legs[name] for name, _ in LEGS]),
            "samples": legs["sync"][0],
            "shards": SHARDS,
            "latency_ms": latency_ms,
            "wall_s": {name: round(s, 2) for name, s in t.items()},
            "speedup_cold": round(t["sync"] / max(t["prefetch_cold"], 1e-9),
                                  2),
            "speedup_warm": round(t["sync"] / max(t["prefetch_warm"], 1e-9),
                                  2),
        }
        print(json.dumps(report, sort_keys=True))
        if not report["identical"]:
            print("cache smoke: prefetch/cache changed delivered bytes "
                  "({})".format({n: leg[1] for n, leg in legs.items()}),
                  file=sys.stderr)
            return 1
        return 0
    finally:
        os.environ.pop("LDDL_TPU_STORAGE_BACKEND", None)
        os.environ.pop("LDDL_TPU_MOCK_LATENCY_MS", None)
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
