"""The port's native in-kernel thread pool (LDDL_TPU_NATIVE_THREADS): byte
identity across thread counts, the counterpart of
tests/test_native_threads.py.

The engine partitions document and bucket ranges across worker threads
into per-thread output arenas stitched back into the flat-segment ABI.
The masking replay is keyed per sample and the pair streams per
document, so the partition must not show: a 1-thread and an N-thread run
give identical arrays at every entry point (tokenize_docs, bert_pairs,
the fused instances, the fused masked instances, split_docs,
mask_batch) and identical shards and manifests end to end. At one
thread each entry point is also held to the reference's native engine on
the same input and vocab. Also: the partition's edges (no documents, one
giant document, fewer documents than threads), the thread-count parsing
and clamps, and the busy-time counters.

``python -m lddl_tpu_torch.tools.sanitize_smoke`` runs this file against
an engine built under TSan and UBSan.
"""

import hashlib
import os

import numpy as np
import pytest

from lddl_tpu import native as rnative
from lddl_tpu.preprocess import get_tokenizer as r_get_tokenizer
from lddl_tpu.preprocess.bert import TokenizerInfo as RTokenizerInfo
from lddl_tpu_torch import native
from lddl_tpu_torch.preprocess import build_wordpiece_vocab, get_tokenizer
from lddl_tpu_torch.preprocess.bert import TokenizerInfo
from lddl_tpu_torch.utils import rng as lrng
from lddl_tpu_torch.utils.cpus import usable_cpu_count

from test_torch_native import DOCS  # noqa: E402  (the shared fuzz corpus)

THREAD_COUNTS = sorted({1, 2, 4, usable_cpu_count()})
WIDTHS = THREAD_COUNTS[1:] + [7]
TEXTS = [d for d in DOCS if d.strip()]


@pytest.fixture(scope="module")
def vocab_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("tvocab") / "vocab.txt"
    return build_wordpiece_vocab(DOCS * 3, str(path), vocab_size=400)


@pytest.fixture(scope="module")
def info(vocab_file):
    return TokenizerInfo(get_tokenizer(vocab_file))


@pytest.fixture(scope="module")
def ref_info(vocab_file):
    return RTokenizerInfo(r_get_tokenizer(vocab_file=vocab_file))


@pytest.fixture()
def nat(info):
    """The port's engine, set back to one thread after the test."""
    n = info.native_tokenizer()
    yield n
    n.set_threads(1)


@pytest.fixture()
def ref_nat(ref_info):
    n = ref_info.native_tokenizer()
    n.set_threads(1)
    return n


@pytest.fixture()
def corpus_dir(tmp_path):
    source = tmp_path / "corpus" / "source"
    source.mkdir(parents=True)
    with open(source / "0.txt", "w", encoding="utf-8") as f:
        for i, d in enumerate(TEXTS * 4):
            f.write("doc-{} {}\n".format(i, d.replace("\r", " ")
                                         .replace("\t", " ")
                                         .replace("\x00", "")))
    return str(tmp_path / "corpus")


def _tree_hashes(out_dir):
    """Digest of every output file, shards and dotfile manifests alike, so
    a thread count that changed row order, shard sizes or a manifest is
    caught, not only one that changed ids."""
    digests = {}
    for root, dirs, files in os.walk(out_dir):
        dirs.sort()
        for name in sorted(files):
            path = os.path.join(root, name)
            with open(path, "rb") as f:
                digests[os.path.relpath(path, out_dir)] = hashlib.sha256(
                    f.read()).hexdigest()
    return digests


def _assert_same_arrays(ref, got, label):
    assert len(ref) == len(got)
    for i, (r, g) in enumerate(zip(ref, got)):
        if r is None or g is None:
            assert r is None and g is None
            continue
        np.testing.assert_array_equal(np.asarray(r), np.asarray(g),
                                      err_msg="{}[{}]".format(label, i))


# ---------------------------------------------------------------------------
# Every entry point: 1 thread against N, and 1 thread against the reference
# ---------------------------------------------------------------------------


def test_tokenize_docs_identity_across_threads(nat, ref_nat):
    texts = TEXTS * 6
    nat.set_threads(1)
    one = nat.tokenize_docs(texts)
    _assert_same_arrays(ref_nat.tokenize_docs(texts), one, "tokenize@ref")
    for nt in WIDTHS:
        nat.set_threads(nt)
        _assert_same_arrays(one, nat.tokenize_docs(texts),
                            "tokenize@{}t".format(nt))


def test_bert_pairs_identity_across_threads(nat, info):
    nat.set_threads(1)
    ids, sl, dc = nat.tokenize_docs(TEXTS * 4)
    args = (ids, sl, dc, 48, 0.1, 3, 12345, 7, info.cls_id, info.sep_id)
    one = native.bert_pairs(*args, threads=1)
    _assert_same_arrays(rnative.bert_pairs(*args, threads=1), one,
                        "pairs@ref")
    for nt in WIDTHS:
        _assert_same_arrays(one, native.bert_pairs(*args, threads=nt),
                            "pairs@{}t".format(nt))


def test_fused_instances_identity_across_threads(nat, ref_nat, info):
    texts = TEXTS * 4

    def run(engine):
        return engine.bert_instances(texts, 48, 0.1, 3, 9, 1, info.cls_id,
                                     info.sep_id, want_ab=True)

    nat.set_threads(1)
    one = run(nat)
    _assert_same_arrays(run(ref_nat), one, "fused@ref")
    for nt in WIDTHS:
        nat.set_threads(nt)
        _assert_same_arrays(one, run(nat), "fused@{}t".format(nt))


def test_fused_masked_identity_across_threads(nat, ref_nat, info):
    texts = TEXTS * 4
    key = lrng.sample_key_bytes(7, 0x3A5C, 3)

    def run(engine):
        return engine.bert_instances_masked(
            texts, 48, 0.1, 2, 7, 3, info.cls_id, info.sep_id, key,
            info.mask_id, info.vocab_size, 0.15, 8, 48)

    nat.set_threads(1)
    one = run(nat)
    assert one is not None
    _assert_same_arrays(run(ref_nat), one, "masked@ref")
    for nt in WIDTHS:
        nat.set_threads(nt)
        _assert_same_arrays(one, run(nat), "masked@{}t".format(nt))


def test_split_docs_identity_across_threads():
    texts = TEXTS * 5
    one = native.split_docs(texts, threads=1)
    assert one == rnative.split_docs(texts, threads=1)
    for nt in WIDTHS:
        assert native.split_docs(texts, threads=nt) == one, nt


def test_mask_batch_identity_across_threads():
    g = np.random.default_rng(3)
    ids = g.integers(0, 30522, (40, 128)).astype(np.int32)
    cand = g.random((40, 128)) < 0.6
    ntp = g.integers(0, 20, 40).astype(np.int64)
    key = lrng.sample_key_bytes(7, 0x3A5C, 0)
    args = (key, ids, cand, ntp, 4, 30522)
    one = native.mask_batch(*args, threads=1)
    assert one is not None
    _assert_same_arrays(rnative.mask_batch(*args, threads=1), one,
                        "mask@ref")
    for nt in WIDTHS:
        _assert_same_arrays(one, native.mask_batch(*args, threads=nt),
                            "mask@{}t".format(nt))


# ---------------------------------------------------------------------------
# The partition's edges
# ---------------------------------------------------------------------------


def test_empty_input_at_width(nat, info):
    """No documents and a wide pool: every thread gets an empty slice."""
    nat.set_threads(8)
    ids, sl, dc = nat.tokenize_docs([])
    assert len(ids) == 0 and len(sl) == 0 and len(dc) == 0
    got = nat.bert_instances([], 48, 0.1, 2, 7, 0, info.cls_id,
                             info.sep_id)
    assert all(len(a) == 0 for a in got[:4])
    assert native.split_docs([], threads=8) == []


def test_single_giant_document_many_threads(nat, ref_nat, info):
    """One document and eight threads: the whole range goes to one
    worker, with the 1-thread (and the reference's) bytes."""
    giant = [" ".join(TEXTS) * 40]

    def run(engine):
        return (engine.tokenize_docs(giant),
                engine.bert_instances(giant, 48, 0.1, 2, 5, 2, info.cls_id,
                                      info.sep_id, want_ab=True))

    nat.set_threads(1)
    one_tok, one_inst = run(nat)
    ref_tok, ref_inst = run(ref_nat)
    _assert_same_arrays(ref_tok, one_tok, "giant-tok@ref")
    _assert_same_arrays(ref_inst, one_inst, "giant-inst@ref")
    nat.set_threads(8)
    got_tok, got_inst = run(nat)
    _assert_same_arrays(one_tok, got_tok, "giant-tok")
    _assert_same_arrays(one_inst, got_inst, "giant-inst")


def test_fewer_documents_than_threads(nat):
    """Fewer documents than threads: the trailing threads get empty
    slices."""
    texts = TEXTS[:3]
    nat.set_threads(1)
    one = nat.tokenize_docs(texts)
    nat.set_threads(16)
    _assert_same_arrays(one, nat.tokenize_docs(texts), "short-slice")


# ---------------------------------------------------------------------------
# Thread counts: parsing, clamps, width from the environment, busy time
# ---------------------------------------------------------------------------


def test_resolve_threads_env_parsing(monkeypatch):
    monkeypatch.delenv("LDDL_TPU_NATIVE_THREADS", raising=False)
    assert native.resolve_threads() == 1          # unset: serial
    for value, want in (("", 1), ("garbage", 1), ("4", 4), ("9999", 64)):
        monkeypatch.setenv("LDDL_TPU_NATIVE_THREADS", value)
        assert native.resolve_threads() == want
        assert native.resolve_threads() == rnative.resolve_threads()
    assert native.resolve_threads(2) == 2         # explicit beats env
    assert native.resolve_threads(-3) == 1        # floor
    for auto in ("0", "auto", "AUTO"):
        monkeypatch.setenv("LDDL_TPU_NATIVE_THREADS", auto)
        assert native.resolve_threads() == usable_cpu_count()


def test_set_threads_clamps_in_kernel(nat):
    nat.set_threads(4)
    assert nat.get_threads() == 4
    nat.set_threads(0)
    assert nat.get_threads() == 1
    nat.set_threads(9999)
    assert nat.get_threads() == 64


def test_tokenizer_width_follows_env(nat, monkeypatch):
    """A tokenizer rebuilt from its pickle (a pool worker) takes its
    width from LDDL_TPU_NATIVE_THREADS."""
    monkeypatch.setenv("LDDL_TPU_NATIVE_THREADS", "3")
    cls, args = nat.__reduce__()
    assert cls(*args).get_threads() == 3


def test_thread_busy_ns_accumulates(nat):
    nat.set_threads(2)
    before = nat.thread_busy_ns()
    assert len(before) == 2                # one slot per configured thread
    assert all(v >= 0 for v in before)
    nat.tokenize_docs(TEXTS * 6)
    after = nat.thread_busy_ns()
    assert after[0] > before[0]            # the caller's thread works
    assert all(a >= b for a, b in zip(after, before))  # cumulative
    nat.set_threads(4)
    assert len(nat.thread_busy_ns()) == 4  # follows the width


# ---------------------------------------------------------------------------
# End to end: shards and manifests identical across thread counts
# ---------------------------------------------------------------------------


def _run_pipeline(corpus_dir, out, vocab_file, monkeypatch, threads,
                  **kwargs):
    from lddl_tpu_torch.preprocess import (BertPretrainConfig,
                                           run_bert_preprocess)
    cfg = dict(max_seq_length=48, duplicate_factor=2, masking=True,
               tokenizer_engine="native")
    cfg.update({k: kwargs.pop(k) for k in list(kwargs)
                if k in ("masking", "schema_version")})
    monkeypatch.setenv("LDDL_TPU_NATIVE_THREADS", str(threads))
    try:
        run_bert_preprocess(
            {"wikipedia": corpus_dir}, out, get_tokenizer(vocab_file),
            config=BertPretrainConfig(**cfg),
            num_blocks=3, sample_ratio=1.0, seed=7, **kwargs)
    finally:
        monkeypatch.delenv("LDDL_TPU_NATIVE_THREADS", raising=False)
    return _tree_hashes(out)


@pytest.mark.parametrize("name,kwargs", [
    ("fused_masked_binned", {"bin_size": 16}),
    ("unmasked", {"masking": False}),
    ("packed", {"masking": False, "schema_version": 2,
                "pack_seq_length": 64}),
])
def test_pipeline_identity_across_threads(vocab_file, corpus_dir, tmp_path,
                                          monkeypatch, name, kwargs):
    """The fused-masked binned, unmasked and offline-packed runs write the
    same trees, shards and manifests, at 1 and at 4 kernel threads."""
    one = _run_pipeline(corpus_dir, str(tmp_path / "t1"), vocab_file,
                        monkeypatch, 1, **dict(kwargs))
    four = _run_pipeline(corpus_dir, str(tmp_path / "t4"), vocab_file,
                         monkeypatch, 4, **dict(kwargs))
    assert one == four
    assert any("parquet" in k for k in one)
    assert any(".manifest" in k for k in one)  # manifests are compared


def test_bart_pipeline_identity_across_threads(corpus_dir, tmp_path,
                                               monkeypatch):
    """BART's whole-bucket native split partitions across threads too;
    the trees it writes do not show it."""
    from lddl_tpu_torch.preprocess import (BartPretrainConfig,
                                           run_bart_preprocess)

    def run(out, threads):
        monkeypatch.setenv("LDDL_TPU_NATIVE_THREADS", str(threads))
        try:
            run_bart_preprocess(
                {"wikipedia": corpus_dir}, out,
                config=BartPretrainConfig(target_seq_length=48),
                num_blocks=3, sample_ratio=1.0, seed=11)
        finally:
            monkeypatch.delenv("LDDL_TPU_NATIVE_THREADS", raising=False)
        return _tree_hashes(out)

    one = run(str(tmp_path / "t1"), 1)
    four = run(str(tmp_path / "t4"), 4)
    assert one == four
    assert one
