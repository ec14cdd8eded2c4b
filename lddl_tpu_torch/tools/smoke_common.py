"""What the CI identity smokes (``tools/*_smoke.py``) share: the seeded
corpus and its sample-trained vocab, the digests each smoke compares,
the environment of the CLI subprocesses they start, and the identity
gate itself.

Each smoke is the counterpart of the reference's ``benchmarks/`` script
of the same name: the same sizes, seeds, flags and one-line JSON report,
on the port's CLIs (``python -m lddl_tpu_torch.cli.*``).
"""

import hashlib
import os
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def smoke_mb(var, default):
    """The corpus size in MiB a smoke's ``LDDL_TPU_*_SMOKE_MB`` asks
    for."""
    return float(os.environ.get(var, default))


def corpus_with_vocab(tmp, target_mb, sample_limit):
    """``testing.make_corpus`` of ``target_mb`` MiB (seed 0) under
    ``tmp/corpus`` and an 8000-piece WordPiece vocab trained on the
    first documents of its ``0.txt`` (up to ``sample_limit`` bytes).
    Returns (corpus dir, bytes written, vocab path, the sampled
    texts)."""
    from ..preprocess import build_wordpiece_vocab
    from ..testing import make_corpus

    corpus = os.path.join(tmp, "corpus")
    nbytes, _ = make_corpus(corpus, target_mb, seed=0)
    sample = []
    sample_bytes = 0
    with open(os.path.join(corpus, "source", "0.txt"),
              encoding="utf-8") as f:
        for line in f:
            sample.append(line.split(None, 1)[1])
            sample_bytes += len(line)
            if sample_bytes > sample_limit:
                break
    vocab = build_wordpiece_vocab(
        sample, os.path.join(tmp, "vocab.txt"), vocab_size=8000)
    return corpus, nbytes, vocab, sample


def tree_digest(out_dir):
    """One sha256 over every file's name and bytes under ``out_dir``
    (shards, manifests, counts), in sorted order."""
    h = hashlib.sha256()
    for root, dirs, files in sorted(os.walk(out_dir)):
        dirs.sort()
        for name in sorted(files):
            h.update(name.encode())
            with open(os.path.join(root, name), "rb") as f:
                h.update(f.read())
    return h.hexdigest()


def _file_sha(path):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def parquet_digests(out_dir):
    """{name: sha256} of the published parquet shards directly in
    ``out_dir``."""
    return {name: _file_sha(os.path.join(out_dir, name))
            for name in sorted(os.listdir(out_dir))
            if ".parquet" in name and ".tmp." not in name}


def published_digests(out_dir):
    """{relative path: sha256} of every visible file under ``out_dir``:
    the mock store's ``.obj.*`` records, telemetry and publish scratch
    are the store's own state, not what a reader of the data sees."""
    out = {}
    # dirnames are pruned and sorted in place (os.walk honours that) and
    # filenames sorted: the walk's order is fixed.
    for dirpath, dirnames, filenames in os.walk(out_dir):  # lddl: disable=unsorted-iteration
        dirnames[:] = sorted(d for d in dirnames
                             if not d.startswith((".obj.", ".telemetry",
                                                  ".tmp.")))
        for name in sorted(filenames):
            if name.startswith(".") or ".tmp." in name:
                continue
            path = os.path.join(dirpath, name)
            out[os.path.relpath(path, out_dir)] = _file_sha(path)
    return out


def loader_digest(bal_dir, vocab):
    """One pass of the port's BERT loader (batch 8, no workers) over
    ``bal_dir``: (samples, sha256 of every batch's arrays in key order,
    seconds). Identity is held on the decoded arrays a train step would
    take, not on the shard files."""
    from ..loader import get_bert_pretrain_data_loader

    loader = get_bert_pretrain_data_loader(
        bal_dir, vocab_file=vocab, batch_size=8, num_workers=0)
    h = hashlib.sha256()
    n = 0
    t0 = time.perf_counter()
    for batch in loader:
        for key in sorted(batch):
            h.update(key.encode())
            h.update(bytes(memoryview(batch[key]).cast("B")))
        n += int(batch["input_ids"].shape[0])
    return n, h.hexdigest(), time.perf_counter() - t0


def cli_env(**extra):
    """The environment of a CLI subprocess: this one's, with the
    repository root first on ``PYTHONPATH`` so ``python -m
    lddl_tpu_torch...`` resolves from any directory."""
    env = dict(os.environ, **extra)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p])
    return env


def identical(first, second):
    """The smokes' identity gate: both sides produced something and it is
    the same (digests as strings, dicts or tuples)."""
    return bool(first) and first == second
