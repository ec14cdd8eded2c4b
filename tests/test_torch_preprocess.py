"""The port's BERT preprocess (lddl_tpu_torch.preprocess) against
lddl_tpu's, run live in the test on the same corpus, vocab file and seeds:
the same file names, parquet tables equal column by column and the same
.manifest.json bytes (so the same shard bytes' CRCs), for

- unbinned; binned + statically masked (numpy engine); schema v1 and v2;
  whole-word masking; global shuffle off; offline packing; the learned
  splitter; txt output;
- the reference tokenizing with its native engine and with its HF
  engine (BertTokenizerFast on the vocab file);
- the port's "hf" engine against the reference's; a saved tokenizer
  directory whose normalizer keeps accents, where "auto" takes the HF
  engine in both packages (and, before the port honoured such a
  directory, gave other ids); the directories' backends against
  BertTokenizerFast.from_pretrained's; the CLI's --tokenizer <dir>;
- 2 spawned workers, and a worker that dies mid-unit (the pool is
  rebuilt and the unit redone); a 2-rank ThreadGroupCommunicator run;
- a run stopped after some units and resumed, equal to an uninterrupted
  one;

and the "torch" masking engine (device="cpu") structurally equal to
"numpy": the same names, row counts and unmasked columns, and with the
labels put back the same id sequences. Exact equality throughout.
"""

import glob
import os
import sys

import numpy as np
import pyarrow.parquet as pq
import pytest
import torch

import lddl_tpu.preprocess as R
from lddl_tpu_torch import preprocess as T
from lddl_tpu_torch.parallel import ThreadGroupCommunicator

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import _torch_tokenizers as toks  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """48 documents of 2-8 sentences in 4 files (tests/conftest.py's
    tiny_corpus, with capitals, accents, abbreviations and decimals)."""
    root = tmp_path_factory.mktemp("tcorpus")
    (root / "source").mkdir()
    words = ("alpha beta gamma delta epsilon zeta eta theta iota kappa "
             "lambda mu nu xi omicron pi rho sigma tau upsilon Café naïve "
             "Dr. U.S. 3.14 e.g.").split()
    g = np.random.Generator(np.random.Philox(key=[0, 7]))
    docs = []
    for d in range(48):
        sents = []
        for _ in range(int(g.integers(2, 9))):
            picks = [words[int(g.integers(0, len(words)))]
                     for _ in range(int(g.integers(4, 14)))]
            sents.append(" ".join(picks).capitalize()
                         + ".?!"[int(g.integers(0, 3))])
        docs.append("doc-{} {}".format(d, " ".join(sents)))
    for shard in range(4):
        with open(root / "source" / "{}.txt".format(shard), "w") as f:
            f.write("".join(line + "\n" for line in docs[shard::4]))
    texts = [p.read_text() for p in sorted((root / "source").iterdir())]
    vocab = T.build_wordpiece_vocab(texts, str(root / "vocab.txt"),
                                    vocab_size=120)
    return str(root), vocab


def _files(out):
    return sorted(os.listdir(out))


def _assert_same_output(got, want):
    assert _files(got) == _files(want) and _files(got)
    for name in _files(want):
        a, b = os.path.join(got, name), os.path.join(want, name)
        if ".parquet" in name:
            ta, tb = pq.read_table(a), pq.read_table(b)
            assert ta.schema == tb.schema, name
            for col in tb.column_names:
                assert ta.column(col).equals(tb.column(col)), (name, col)
        else:
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), name


def _reference(corpus, out, run_kw, cfg_kw, tokenizer_engine="native"):
    root, vocab = corpus
    R.run_bert_preprocess(
        {"w": root}, out, R.get_tokenizer(vocab_file=vocab),
        config=R.BertPretrainConfig(max_seq_length=64, duplicate_factor=2,
                                    tokenizer_engine=tokenizer_engine,
                                    **cfg_kw),
        num_blocks=6, sample_ratio=0.9, seed=3, **run_kw)
    return out


def _port(corpus, out, run_kw, cfg_kw, **kw):
    root, vocab = corpus
    return T.run_bert_preprocess(
        {"w": root}, out, T.get_tokenizer(vocab),
        config=T.BertPretrainConfig(max_seq_length=64, duplicate_factor=2,
                                    **cfg_kw),
        num_blocks=6, sample_ratio=0.9, seed=3, **run_kw, **kw)


CASES = {
    "unbinned": ({}, {}),
    "binned_masked": ({"bin_size": 16}, {"masking": True}),
    "binned_masked_v1": ({"bin_size": 16},
                         {"masking": True, "schema_version": 1}),
    "unbinned_masked_v1": ({}, {"masking": True, "schema_version": 1}),
    "whole_word": ({"bin_size": 16},
                   {"masking": True, "whole_word_masking": True}),
    "no_global_shuffle": ({"global_shuffle": False, "bin_size": 32},
                          {"masking": True}),
    "packed": ({"pack_seq_length": 64}, {"masking": True}),
    "txt_binned_masked": ({"output_format": "txt", "bin_size": 16},
                          {"masking": True}),
    "txt_unbinned": ({"output_format": "txt"}, {}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_preprocess_matches_reference(corpus, tmp_path, case):
    run_kw, cfg_kw = CASES[case]
    want = _reference(corpus, str(tmp_path / "ref"), run_kw, cfg_kw)
    _port(corpus, str(tmp_path / "port"), run_kw, cfg_kw)
    _assert_same_output(str(tmp_path / "port"), want)


@pytest.mark.parametrize("case", ["unbinned", "binned_masked",
                                  "whole_word"])
def test_preprocess_matches_reference_hf_engine(corpus, tmp_path, case):
    """The reference tokenizing with BertTokenizerFast (its "hf" engine)
    on the same vocab file gives the port's native output too."""
    run_kw, cfg_kw = CASES[case]
    want = _reference(corpus, str(tmp_path / "ref"), run_kw, cfg_kw,
                      tokenizer_engine="hf")
    _port(corpus, str(tmp_path / "port"), run_kw, cfg_kw)
    _assert_same_output(str(tmp_path / "port"), want)


def test_learned_splitter_matches_reference(corpus, tmp_path):
    pytest.importorskip("nltk", reason="training the learned splitter "
                        "needs nltk, as in the reference")
    cfg_kw = {"masking": True, "splitter": "learned"}
    want = _reference(corpus, str(tmp_path / "ref"), {"bin_size": 32},
                      cfg_kw)
    _port(corpus, str(tmp_path / "port"), {"bin_size": 32}, cfg_kw)
    _assert_same_output(str(tmp_path / "port"), want)


def test_two_workers_match_reference(corpus, tmp_path):
    run_kw, cfg_kw = CASES["binned_masked"]
    want = _reference(corpus, str(tmp_path / "ref"), run_kw, cfg_kw)
    _port(corpus, str(tmp_path / "port"), run_kw, cfg_kw, num_workers=2)
    _assert_same_output(str(tmp_path / "port"), want)


class _DiesOnce:
    """A processor whose pool worker dies (hard exit) the first time it
    reaches ``bucket``, as an OOM kill would; a marker file makes the
    retry survive."""

    def __init__(self, inner, marker, bucket):
        self.inner, self.marker, self.bucket = inner, marker, bucket

    def fingerprint(self):
        return self.inner.fingerprint()

    def prepare(self, texts, bucket):
        if bucket == self.bucket and not os.path.exists(self.marker):
            open(self.marker, "w").close()
            os._exit(9)
        return self.inner.prepare(texts, bucket)


def test_dead_worker_is_retried_to_the_same_output(corpus, tmp_path):
    """A pool worker that dies mid-unit breaks the pool; the runner
    rebuilds it and redoes the unfinished units, and the output equals
    the reference's uninterrupted run (no debris left)."""
    from lddl_tpu_torch.preprocess import runner
    run_kw, cfg_kw = CASES["no_global_shuffle"]  # one pool, not two
    want = _reference(corpus, str(tmp_path / "ref"), run_kw, cfg_kw)
    root, vocab = corpus
    out = str(tmp_path / "port")
    cfg = T.BertPretrainConfig(max_seq_length=64, duplicate_factor=2,
                               **cfg_kw)
    proc = runner.BertBucketProcessor(T.get_tokenizer(vocab), cfg, 3, out,
                                      run_kw["bin_size"], "parquet")
    logs = []
    runner.run_sharded_pipeline(
        {"w": root}, out, _DiesOnce(proc, str(tmp_path / "died"), 3),
        num_blocks=6, sample_ratio=0.9, seed=3, global_shuffle=False,
        num_workers=2, log=logs.append)
    assert os.path.exists(str(tmp_path / "died"))
    assert any("worker died; rebuilding pool" in line for line in logs)
    _assert_same_output(out, want)


def test_two_rank_run_equals_one_rank(corpus, tmp_path):
    run_kw, cfg_kw = CASES["binned_masked"]
    want = _reference(corpus, str(tmp_path / "ref"), run_kw, cfg_kw)
    out = str(tmp_path / "port2")
    written = ThreadGroupCommunicator.spawn(
        2, lambda comm: _port(corpus, out, run_kw, cfg_kw, comm=comm))
    # Ranks own disjoint units; together they wrote every shard.
    assert not set(written[0]) & set(written[1])
    assert sorted(os.path.basename(p) for w in written for p in w) == \
        [n for n in _files(want) if ".parquet" in n]
    _assert_same_output(out, want)


def test_resume_after_failed_units_equals_uninterrupted(corpus, tmp_path,
                                                        monkeypatch):
    from lddl_tpu_torch.preprocess import runner
    run_kw, cfg_kw = {"bin_size": 16, "spool_groups": 4}, {"masking": True}
    want = _reference(corpus, str(tmp_path / "ref"), run_kw, cfg_kw)
    out = str(tmp_path / "port")
    prepare = runner.BertBucketProcessor.prepare
    failed = {1, 4}  # buckets of spool groups 1 and 0 (bucket % 4)

    def flaky(self, texts, bucket):
        if bucket in failed:
            raise OSError("disk full while writing bucket {}".format(bucket))
        return prepare(self, texts, bucket)

    monkeypatch.setattr(runner.BertBucketProcessor, "prepare", flaky)
    with pytest.raises(RuntimeError, match="2 unit"):
        _port(corpus, out, run_kw, cfg_kw)
    done = sorted(os.listdir(os.path.join(out, "_done")))
    assert done == ["group-2.json", "group-3.json", "manifest.json"]
    with pytest.raises(ValueError, match="already contains"):
        _port(corpus, out, run_kw, cfg_kw)
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        _port(corpus, out, run_kw, dict(cfg_kw, masked_lm_ratio=0.2),
              resume=True)
    monkeypatch.setattr(runner.BertBucketProcessor, "prepare", prepare)
    _port(corpus, out, run_kw, cfg_kw, resume=True)
    _assert_same_output(out, want)


def _unmasked(table):
    """[CLS] A [SEP] B [SEP] id sequences with each label put back at its
    position, one list per row."""
    rows = []
    for a, b, pos, lab in zip(*(table.column(c).to_pylist() for c in (
            "A_ids", "B_ids", "masked_lm_positions_ids",
            "masked_lm_label_ids"))):
        seq = [None] + a + [None] + b + [None]
        for p, x in zip(pos, lab):
            seq[p] = x
        rows.append(seq)
    return rows


@pytest.mark.parametrize("wwm", [False, True])
def test_torch_engine_structurally_equals_numpy(corpus, tmp_path, wwm):
    """Same pairs, other masks (the reference's tests/test_ops.py:80-110
    criterion, and stronger: the unmasked sequences are equal)."""
    run_kw = {"bin_size": 16}
    outs = {}
    for engine in ("numpy", "torch"):
        outs[engine] = str(tmp_path / engine)
        _port(corpus, outs[engine], run_kw,
              {"masking": True, "whole_word_masking": wwm,
               "engine": engine, "device": "cpu"})
    names = [n for n in _files(outs["numpy"]) if ".parquet" in n]
    assert names == [n for n in _files(outs["torch"]) if ".parquet" in n]
    differs = 0
    for name in names:
        t, n = (pq.read_table(os.path.join(outs[e], name))
                for e in ("torch", "numpy"))
        assert t.num_rows == n.num_rows and t.schema == n.schema
        for col in ("is_random_next", "num_tokens", "bin_id"):
            assert t.column(col).equals(n.column(col)), (name, col)
        assert _unmasked(t) == _unmasked(n), name
        lens = np.asarray(t.column("num_tokens"))
        counts = [len(p) for p in
                  t.column("masked_lm_positions_ids").to_pylist()]
        plan = T.bert.plan_num_to_predict(lens, 0.15, 10)
        assert (np.asarray(counts) <= plan).all()
        if not wwm:
            np.testing.assert_array_equal(counts, plan)
        differs += not t.column("masked_lm_positions_ids").equals(
            n.column("masked_lm_positions_ids"))
    assert differs  # the engines draw different masks
    assert glob.glob(os.path.join(outs["torch"], ".manifest.json"))


# ------------------------- the runner's I/O through the resilient layer
#
# Each case runs on both packages: the ledger read, the spool append and
# the spool read ride ``resilience/io`` (its retries, its fault sites and,
# for the gather, the elastic scheduler's ``accept`` filter).

PKGS = pytest.mark.parametrize("pkg", ["lddl_tpu", "lddl_tpu_torch"],
                               ids=["ref", "port"])


class _Recording:
    """Delegates to a processor, records the buckets it prepares and
    fails those in ``fail`` while ``fail`` is non-empty."""

    def __init__(self, inner, fail=()):
        self.inner, self.fail, self.prepared = inner, set(fail), []

    def fingerprint(self):
        return self.inner.fingerprint()

    def prepare(self, texts, bucket):
        self.prepared.append(bucket)
        if bucket in self.fail:
            raise OSError("disk full while writing bucket {}".format(bucket))
        return self.inner.prepare(texts, bucket)


def _pkg_runner(pkg, corpus, out):
    """(runner module, a BERT processor for ``out``) of one package, with
    run_kw/cfg_kw of CASES["binned_masked"]."""
    import importlib
    runner = importlib.import_module(pkg + ".preprocess.runner")
    pre = importlib.import_module(pkg + ".preprocess")
    _, vocab = corpus
    cfg = pre.BertPretrainConfig(max_seq_length=64, duplicate_factor=2,
                                 masking=True)
    tok = pre.get_tokenizer(vocab_file=vocab)
    return runner, runner.BertBucketProcessor(tok, cfg, 3, out, 16,
                                              "parquet")


def _armed_metrics(pkg, monkeypatch, tmp_path, spec):
    """Telemetry on in a directory of the test's own, the registry reset,
    the fault injector armed with ``spec``; returns the registry."""
    import importlib
    obs = importlib.import_module(pkg + ".observability")
    faults = importlib.import_module(pkg + ".resilience.faults")
    monkeypatch.setenv("LDDL_TPU_METRICS_DIR", str(tmp_path / "metrics"))
    monkeypatch.setenv("LDDL_TPU_RETRY_BASE_DELAY_S", "0.001")
    obs.registry().reset()
    faults.arm(spec)
    return obs.registry(), faults


@PKGS
def test_ledger_read_fault_is_retried_on_resume(corpus, tmp_path,
                                                monkeypatch, pkg):
    """A transient EIO on a resume run's first ledger-record read is
    retried through ``resilience/io`` (counted under
    ``resilience_retry_attempts_total{op="read"}``), so the finished unit
    it names is not redone: only the failed unit's buckets run again."""
    run_kw = {"bin_size": 16, "spool_groups": 4}
    want = _reference(corpus, str(tmp_path / "ref"), run_kw,
                      {"masking": True})
    root, _ = corpus
    out = str(tmp_path / "out")
    runner, inner = _pkg_runner(pkg, corpus, out)
    kw = dict(num_blocks=6, sample_ratio=0.9, seed=3, spool_groups=4)
    first = _Recording(inner, fail={1})  # bucket 1: spool group 1
    with pytest.raises(RuntimeError, match="1 unit"):
        runner.run_sharded_pipeline({"w": root}, out, first, **kw)
    reg, faults = _armed_metrics(pkg, monkeypatch, tmp_path,
                                 "read:eio:nth=1:path=_done" + os.sep
                                 + "group-")
    try:
        again = _Recording(inner)
        runner.run_sharded_pipeline({"w": root}, out, again, resume=True,
                                    **kw)
    finally:
        faults.disarm()
    retries = reg.counter("resilience_retry_attempts_total")
    assert retries.value(op="read") >= 1
    assert reg.counter("resilience_faults_injected_total").value(
        op="read", kind="eio") == 1
    assert sorted(again.prepared) == [1, 5]  # group 1's buckets only
    _assert_same_output(out, want)


@PKGS
def test_spool_append_open_fault_reaches_the_site(corpus, tmp_path,
                                                  monkeypatch, pkg):
    """An ``open`` fault on a scatter spool append fires at the append's
    open (the static serial writer's ``w0-0.txt``) and is retried; the
    run ends with the clean run's bytes."""
    run_kw, cfg_kw = CASES["binned_masked"]
    want = _reference(corpus, str(tmp_path / "ref"), run_kw, cfg_kw)
    root, _ = corpus
    out = str(tmp_path / "out")
    runner, proc = _pkg_runner(pkg, corpus, out)
    reg, faults = _armed_metrics(pkg, monkeypatch, tmp_path,
                                 "open:eio:nth=1:path=w0-0.txt")
    try:
        runner.run_sharded_pipeline({"w": root}, out, proc, num_blocks=6,
                                    sample_ratio=0.9, seed=3)
    finally:
        faults.disarm()
    assert reg.counter("resilience_faults_injected_total").value(
        op="open", kind="eio") == 1
    assert reg.counter("resilience_retry_attempts_total").value(
        op="open") >= 1
    _assert_same_output(out, want)


@PKGS
def test_gather_reads_only_accepted_spool_files(tmp_path, pkg):
    """Under ``accept`` a group's reader takes only the named spool files:
    a stray file beside them (a fenced-off attempt's appends) is never
    read. Without it, every file of the group is read."""
    import importlib
    runner = importlib.import_module(pkg + ".preprocess.runner")
    gdir = tmp_path / "_shuffle" / "group-0"
    gdir.mkdir(parents=True)
    (gdir / "s0.e1.hB.txt").write_bytes(
        b"#B 0 0\n doc one\n doc two\n#B 0 2\n doc three\n")
    (gdir / "s0.e0.hA.txt").write_bytes(b"#B 0 0\n stray\n")
    (gdir / "s1.e0.hA.txt").write_bytes(b"#B 1 2\n doc four\n")

    def texts(accept):
        got = runner._read_group_texts(str(tmp_path), 0, 4, 2,
                                       accept=accept)
        return {b: [bytes(t) for t in spans] for b, spans in got.items()}

    assert texts({"s0.e1.hB.txt", "s1.e0.hA.txt"}) == {
        0: [b"doc one", b"doc two"], 2: [b"doc three", b"doc four"]}
    # Files are read in sorted name order: the stray one first.
    assert texts(None) == {0: [b"stray", b"doc one", b"doc two"],
                           2: [b"doc three", b"doc four"]}


# ---------------------------------------------------------------------------
# Tokenizer directories and the HF engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def keep_accents_dir(corpus, tmp_path_factory):
    _, vocab = corpus
    return toks.keep_accents_dir(str(tmp_path_factory.mktemp("keep")), vocab)


def _corpus_texts(corpus):
    root, _ = corpus
    texts = []
    for name in sorted(os.listdir(os.path.join(root, "source"))):
        with open(os.path.join(root, "source", name), "rb") as f:
            texts.extend(f.read().splitlines())
    return texts


def _as_lists(documents):
    return [[[int(i) for i in s] for s in doc] for doc in documents]


def test_tokenizer_dir_keeps_its_normalizer(corpus, keep_accents_dir):
    """``auto`` on a directory whose normalizer keeps accents: the
    reference routes to its HF engine and keeps "café" whole; the port
    gives the same ids (it used to read only vocab.txt and tokenize
    natively, stripping the accents)."""
    from lddl_tpu.preprocess.bert import (
        documents_from_texts as ref_documents)
    from lddl_tpu_torch.preprocess.bert import (
        documents_from_texts as port_documents)
    texts = _corpus_texts(corpus)
    ref_tok = R.get_tokenizer(pretrained_model_name=keep_accents_dir)
    port_tok = T.get_tokenizer(pretrained_model_name=keep_accents_dir)
    want = _as_lists(ref_documents(texts, ref_tok))
    got = _as_lists(port_documents(texts, port_tok))
    cafe = ref_tok.convert_tokens_to_ids("café")
    assert any(cafe in s for doc in want for s in doc)
    assert got == want


def _run_both(corpus, tmp_path, run_kw, cfg_kw, ref_tok, port_tok):
    root, _ = corpus
    want, got = str(tmp_path / "ref"), str(tmp_path / "port")
    for pkg, tok, out in ((R, ref_tok, want), (T, port_tok, got)):
        pkg.run_bert_preprocess(
            {"w": root}, out, tok,
            config=pkg.BertPretrainConfig(max_seq_length=64,
                                          duplicate_factor=2, **cfg_kw),
            num_blocks=6, sample_ratio=0.9, seed=3, **run_kw)
    _assert_same_output(got, want)


@pytest.mark.parametrize("case", ["unbinned", "binned_masked",
                                  "whole_word"])
def test_hf_engine_matches_reference_hf_engine(corpus, tmp_path, case):
    """The port's "hf" engine (the fast tokenizer built from the vocab
    table) against the reference's "hf" engine on the same vocab file."""
    _, vocab = corpus
    run_kw, cfg_kw = CASES[case]
    cfg_kw = dict(cfg_kw, tokenizer_engine="hf")
    _run_both(corpus, tmp_path, run_kw, cfg_kw,
              R.get_tokenizer(vocab_file=vocab), T.get_tokenizer(vocab))


@pytest.mark.parametrize("case", ["unbinned", "binned_masked"])
def test_auto_on_a_keep_accents_dir_matches_reference(corpus, tmp_path,
                                                      keep_accents_dir,
                                                      case):
    """``auto`` on the directory whose normalizer keeps accents: both
    packages take their HF engine, and write the same shards."""
    run_kw, cfg_kw = CASES[case]
    ref_tok = R.get_tokenizer(pretrained_model_name=keep_accents_dir)
    port_tok = T.get_tokenizer(pretrained_model_name=keep_accents_dir)
    from lddl_tpu_torch.preprocess.bert import TokenizerInfo
    assert TokenizerInfo(port_tok).native_tokenizer() is None
    _run_both(corpus, tmp_path, run_kw, cfg_kw, ref_tok, port_tok)


@pytest.mark.parametrize("kw", [
    {"do_lower_case": True, "strip_accents": False},
    {"do_lower_case": True},
    {"do_lower_case": False},
    {"do_lower_case": True, "tokenize_chinese_chars": False},
], ids=["keep_accents", "default", "cased", "no_chinese"])
def test_tokenizer_dir_backend_equals_reference(corpus, tmp_path, kw):
    """``get_tokenizer`` on a ``save_pretrained`` directory gives the
    backend ``BertTokenizerFast.from_pretrained`` gives (the same
    serialized pipeline, vocab, length, ids and special tokens), with the
    normalizer override applied for either ``do_lower_case``; and the
    native engine is taken exactly where the reference takes it."""
    from lddl_tpu.preprocess.bert import TokenizerInfo as RInfo
    from lddl_tpu_torch.preprocess.bert import TokenizerInfo as PInfo
    _, vocab = corpus
    path = toks.save_tokenizer_dir(str(tmp_path / "tok"), vocab,
                                   accented=True, **kw)
    texts = ["The Café naïve [MASK] 中文 Dr. x\x00y", "NAÏVE\tcafe [mask]"]
    for lower in (True, False):
        ref = R.get_tokenizer(pretrained_model_name=path,
                              do_lower_case=lower)
        port = T.get_tokenizer(pretrained_model_name=path,
                               do_lower_case=lower)
        assert (port.backend_tokenizer.to_str()
                == ref.backend_tokenizer.to_str())
        assert port.get_vocab() == ref.get_vocab()
        assert len(port) == len(ref)
        assert port.do_lower_case == ref.do_lower_case == lower
        assert port.encode_texts(texts) == ref(
            texts, add_special_tokens=False)["input_ids"]
        for tok in ("[CLS]", "[SEP]", "[PAD]", "[MASK]", "[UNK]", "zzz"):
            assert (port.convert_tokens_to_ids(tok)
                    == ref.convert_tokens_to_ids(tok))
        assert ((PInfo(port).native_tokenizer() is None)
                == (RInfo(ref).native_tokenizer() is None))


def test_vocab_only_dir_and_vocab_file_give_the_table(corpus, tmp_path):
    """A vocab file, and a directory holding only ``vocab.txt``, give the
    vocab table (no fast tokenizer); ``hf`` on it builds the backend a
    vocab-file ``BertTokenizerFast`` has."""
    from lddl_tpu_torch.preprocess.bert import TokenizerInfo
    from lddl_tpu_torch.utils.vocab import Vocab
    _, vocab = corpus
    (tmp_path / "d").mkdir()
    with open(vocab, "rb") as f:
        (tmp_path / "d" / "vocab.txt").write_bytes(f.read())
    for tok in (T.get_tokenizer(vocab),
                T.get_tokenizer(pretrained_model_name=str(tmp_path / "d"))):
        assert type(tok) is Vocab
        hf = TokenizerInfo(tok).hf_tokenizer()
        ref = R.get_tokenizer(vocab_file=vocab)
        assert hf.backend_tokenizer.to_str() == \
            ref.backend_tokenizer.to_str()


def test_tokenizer_engine_choices():
    assert T.BertPretrainConfig().tokenizer_engine == "auto"
    for engine in ("auto", "hf", "native"):
        T.BertPretrainConfig(tokenizer_engine=engine)
    with pytest.raises(ValueError, match="auto|hf|native"):
        T.BertPretrainConfig(tokenizer_engine="spacy")


def test_native_engine_refuses_a_foreign_normalizer(corpus,
                                                    keep_accents_dir):
    from lddl_tpu_torch.preprocess.bert import instances_from_texts
    texts = _corpus_texts(corpus)[:4]
    tok = T.get_tokenizer(pretrained_model_name=keep_accents_dir)
    with pytest.raises(RuntimeError, match="native tokenizer engine"):
        instances_from_texts(texts, tok, T.BertPretrainConfig(
            max_seq_length=64, tokenizer_engine="native"), 3, 0)


def test_cli_takes_a_tokenizer_dir(corpus, tmp_path, keep_accents_dir):
    """``--tokenizer <dir>`` with no ``--vocab-file`` (engine ``auto``)
    writes what the reference's CLI writes from the same directory."""
    from lddl_tpu.cli import preprocess_bert_pretrain as ref_cli
    from lddl_tpu_torch.cli import preprocess_bert_pretrain as port_cli
    root, _ = corpus
    args = ["--wikipedia", root, "--tokenizer", keep_accents_dir,
            "--target-seq-length", "64", "--bin-size", "16", "--masking",
            "--duplicate-factor", "1", "--num-blocks", "4",
            "--local-workers", "1"]
    ref_cli.main(ref_cli.attach_args().parse_args(
        args + ["--sink", str(tmp_path / "ref")]))
    port_cli.main(port_cli.attach_args().parse_args(
        args + ["--sink", str(tmp_path / "port")]))
    _assert_same_output(str(tmp_path / "port"), str(tmp_path / "ref"))
    with pytest.raises(SystemExit, match="--vocab-file or --tokenizer"):
        port_cli.main(port_cli.attach_args().parse_args(
            ["--wikipedia", root, "--sink", str(tmp_path / "none")]))
