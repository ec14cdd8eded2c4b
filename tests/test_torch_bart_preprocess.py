"""The port's BART preprocess (lddl_tpu_torch.preprocess.bart and its CLI)
against lddl_tpu's, run live in the test on the same corpus, vocab file
and seeds: every output file byte-equal (``part.*.parquet``, ``.txt``,
``.manifest.json``), for schema v2 (a tokenizer: the reference's
BertTokenizerFast on the vocab file, the port's native WordPiece) and v1
(none), parquet and txt output, the rules and learned splitters, and
the Python splitter forced by ``LDDL_TPU_BART_NATIVE_SPLIT=0``; equal
resume fingerprints; the CLI driven as a subprocess with the reference's
flags, and with ``--elastic`` against the reference's static run; then the port's balancer and BART loader against the reference's
balancer and loader, batch for batch. Exact equality throughout.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import _torch_loader_shards as shards  # noqa: E402
import _torch_tokenizers as toks  # noqa: E402

import lddl_tpu.preprocess as R  # noqa: E402
from lddl_tpu_torch import preprocess as T  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """60 documents of 2-9 sentences in 4 files, with capitals, accents,
    abbreviations and decimals, and a WordPiece vocab of 160 tokens."""
    root = tmp_path_factory.mktemp("bcorpus")
    (root / "source").mkdir()
    words = ("alpha beta gamma delta epsilon zeta eta theta iota kappa "
             "lambda mu nu xi omicron pi rho sigma tau upsilon Café naïve "
             "Dr. U.S. 3.14 e.g.").split()
    g = np.random.Generator(np.random.Philox(key=[0, 11]))
    docs = []
    for d in range(60):
        sents = []
        for _ in range(int(g.integers(2, 10))):
            picks = [words[int(g.integers(0, len(words)))]
                     for _ in range(int(g.integers(3, 15)))]
            sents.append(" ".join(picks).capitalize()
                         + ".?!"[int(g.integers(0, 3))])
        docs.append("doc-{} {}".format(d, " ".join(sents)))
    for shard in range(4):
        with open(root / "source" / "{}.txt".format(shard), "w") as f:
            f.write("".join(line + "\n" for line in docs[shard::4]))
    texts = [p.read_text() for p in sorted((root / "source").iterdir())]
    vocab = T.build_wordpiece_vocab(texts, str(root / "vocab.txt"),
                                    vocab_size=160)
    return str(root), vocab


RUN_KW = dict(num_blocks=6, sample_ratio=0.9, seed=5)


def _run(pkg, corpus, out, tokenized, **kw):
    root, vocab = corpus
    cfg_kw = {k: kw.pop(k) for k in ("target_seq_length", "splitter",
                                     "short_seq_prob") if k in kw}
    cfg_kw.setdefault("target_seq_length", 24)
    tok = pkg.get_tokenizer(vocab_file=vocab) if tokenized else None
    pkg.run_bart_preprocess({"w": root}, out,
                            config=pkg.BartPretrainConfig(**cfg_kw),
                            tokenizer=tok, **RUN_KW, **kw)
    return out


def _assert_same_bytes(got, want):
    names = sorted(os.listdir(want))
    assert sorted(os.listdir(got)) == names and names
    for name in names:
        with open(os.path.join(got, name), "rb") as a, \
                open(os.path.join(want, name), "rb") as b:
            assert a.read() == b.read(), name


CASES = {
    "v2": dict(tokenized=True),
    "v1": dict(tokenized=False),
    "v2_txt": dict(tokenized=True, output_format="txt"),
    "v1_txt": dict(tokenized=False, output_format="txt"),
    "v2_long_chunks": dict(tokenized=True, target_seq_length=96,
                           short_seq_prob=0.3),
    "v2_no_global_shuffle": dict(tokenized=True, global_shuffle=False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_shards_byte_equal_to_reference(corpus, tmp_path, case):
    kw = CASES[case]
    want = _run(R, corpus, str(tmp_path / "ref"), **dict(kw))
    got = _run(T, corpus, str(tmp_path / "port"), **dict(kw))
    _assert_same_bytes(got, want)
    if kw.get("output_format") != "txt":
        import pyarrow.parquet as pq
        names = pq.read_schema(os.path.join(
            got, sorted(n for n in os.listdir(got) if ".parquet" in n)[0]
        )).names
        assert ("sentence_ids" in names) == kw["tokenized"]


@pytest.mark.parametrize("tokenized", [True, False], ids=["v2", "v1"])
def test_python_splitter_forced_is_byte_equal(corpus, tmp_path, monkeypatch,
                                              tokenized):
    """LDDL_TPU_BART_NATIVE_SPLIT=0 forces the Python splitter in both
    packages: the same bytes as each other and as the native split."""
    native = _run(T, corpus, str(tmp_path / "native"), tokenized)
    monkeypatch.setenv("LDDL_TPU_BART_NATIVE_SPLIT", "0")
    want = _run(R, corpus, str(tmp_path / "ref"), tokenized)
    got = _run(T, corpus, str(tmp_path / "port"), tokenized)
    _assert_same_bytes(got, want)
    _assert_same_bytes(got, native)


def test_learned_splitter_is_byte_equal(corpus, tmp_path):
    pytest.importorskip("nltk", reason="training the learned splitter "
                                       "needs nltk")
    want = _run(R, corpus, str(tmp_path / "ref"), True, splitter="learned")
    got = _run(T, corpus, str(tmp_path / "port"), True, splitter="learned")
    _assert_same_bytes(got, want)


@pytest.mark.parametrize("tokenized,fmt", [(True, "parquet"),
                                           (False, "parquet"),
                                           (True, "txt")])
def test_fingerprints_equal(corpus, tokenized, fmt):
    root, vocab = corpus
    fps = []
    for pkg in (R, T):
        from importlib import import_module
        bart = import_module(pkg.__name__ + ".bart")
        tok = pkg.get_tokenizer(vocab_file=vocab) if tokenized else None
        fps.append(bart.BartBucketProcessor(
            pkg.BartPretrainConfig(target_seq_length=40), 5, "/out", fmt,
            tokenizer=tok).fingerprint())
    assert fps[0] == fps[1]


def test_v2_ids_are_what_the_v1_collate_derives(corpus, tmp_path):
    """The stored schema-v2 ids equal the ids the port's BART collate
    derives from the same chunk text (schema v1), chunk for chunk."""
    import pyarrow.parquet as pq
    from lddl_tpu_torch.loader.bart import BartCollate
    root, vocab = corpus
    out = _run(T, corpus, str(tmp_path / "v2"), True)
    collate = BartCollate(T.get_tokenizer(vocab_file=vocab))
    n = 0
    for name in sorted(os.listdir(out)):
        if ".parquet" not in name:
            continue
        t = pq.read_table(os.path.join(out, name)).to_pydict()
        derived = collate._sentence_ids(t["sentences"])
        for ids, lens, sents in zip(t["sentence_ids"], t["sentence_lens"],
                                    derived):
            assert [len(s) for s in sents] == lens
            assert [i for s in sents for i in s] == ids
            n += 1
    assert n > 0


def test_keep_accents_dir_is_byte_equal(corpus, tmp_path):
    """A tokenizer directory whose normalizer keeps accents: both
    packages tokenize the schema-v2 ids with the fast tokenizer (the
    port does not take its native engine there), and the shards, the
    manifests and the resume fingerprints are byte-equal; the v1 collate
    derives the same ids from the chunk text."""
    import pyarrow.parquet as pq
    from lddl_tpu_torch.loader.bart import BartCollate
    from lddl_tpu_torch.preprocess.bart import BartBucketProcessor
    root, vocab = corpus
    path = toks.keep_accents_dir(str(tmp_path / "tok"), vocab)
    outs = {}
    for pkg in (R, T):
        out = str(tmp_path / pkg.__name__)
        pkg.run_bart_preprocess(
            {"w": root}, out,
            config=pkg.BartPretrainConfig(target_seq_length=24),
            tokenizer=pkg.get_tokenizer(pretrained_model_name=path),
            **RUN_KW)
        outs[pkg] = out
    _assert_same_bytes(outs[T], outs[R])
    ids = set()
    for name in os.listdir(outs[T]):
        if ".parquet" in name:
            t = pq.read_table(os.path.join(outs[T], name)).to_pydict()
            ids.update(i for row in t["sentence_ids"] for i in row)
    port_tok = T.get_tokenizer(pretrained_model_name=path)
    assert port_tok.convert_tokens_to_ids("café") in ids
    fps = [_bart_of(pkg).BartBucketProcessor(
        pkg.BartPretrainConfig(target_seq_length=40), 5, "/out", "parquet",
        tokenizer=pkg.get_tokenizer(pretrained_model_name=path)
    ).fingerprint() for pkg in (R, T)]
    assert fps[0] == fps[1]
    assert BartBucketProcessor(
        T.BartPretrainConfig(), 5, "/out", "parquet",
        tokenizer=port_tok).tok_info.native_tokenizer() is None
    collate = BartCollate(port_tok)
    for name in sorted(os.listdir(outs[T])):
        if ".parquet" in name:
            t = pq.read_table(os.path.join(outs[T], name)).to_pydict()
            derived = collate._sentence_ids(t["sentences"])
            for want, sents in zip(t["sentence_ids"], derived):
                assert [int(i) for s in sents for i in s] == want


def _bart_of(pkg):
    from importlib import import_module
    return import_module(pkg.__name__ + ".bart")


def _cli(module, corpus, out, extra=()):
    root, vocab = corpus
    argv = [sys.executable, "-m", module, "--wikipedia", root, "--sink", out,
            "--target-seq-length", "24", "--num-blocks", "6",
            "--sample-ratio", "0.9", "--seed", "5", "--local-workers", "1",
            *extra]
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(argv, cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return out


@pytest.mark.parametrize("tokenized", [True, False], ids=["v2", "v1"])
def test_cli_writes_the_reference_bytes(corpus, tmp_path, tokenized):
    extra = ["--vocab-file", corpus[1]] if tokenized else []
    want = _cli("lddl_tpu.cli.preprocess_bart_pretrain", corpus,
                str(tmp_path / "ref"), extra)
    got = _cli("lddl_tpu_torch.cli.preprocess_bart_pretrain", corpus,
               str(tmp_path / "port"), extra)
    _assert_same_bytes(got, want)


@pytest.mark.parametrize("tokenized", [True, False], ids=["v2", "v1"])
def test_cli_elastic_writes_the_reference_bytes(corpus, tmp_path, tokenized):
    """``--elastic`` (the lease-based work-stealing schedule) writes the
    reference CLI's static bytes, manifest included."""
    extra = ["--vocab-file", corpus[1]] if tokenized else []
    want = _cli("lddl_tpu.cli.preprocess_bart_pretrain", corpus,
                str(tmp_path / "ref"), extra)
    got = _cli("lddl_tpu_torch.cli.preprocess_bart_pretrain", corpus,
               str(tmp_path / "port"),
               extra + ["--elastic", "--lease-ttl", "5",
                        "--elastic-host-id", "h0"])
    _assert_same_bytes(got, want)
    assert not os.path.isdir(os.path.join(got, "_leases"))


@pytest.mark.parametrize("flag,match", [
    ("--fleet-telemetry", "not ported"),
])
def test_cli_refuses_unported_flags_by_name(corpus, tmp_path, flag, match):
    """The flag this CLI once refused by name (``match`` was its
    refusal) is ported: ``--fleet-telemetry`` now runs, arms the
    spool under ``<sink>/.telemetry/`` and leaves the shards equal to
    the reference CLI's."""
    from lddl_tpu_torch.cli.preprocess_bart_pretrain import attach_args, main
    from lddl_tpu_torch.observability import fleet, registry, tracing
    out = str(tmp_path / "out")
    args = attach_args().parse_args(
        ["--wikipedia", corpus[0], "--sink", out, "--target-seq-length",
         "24", "--num-blocks", "6", "--sample-ratio", "0.9", "--seed", "5",
         "--local-workers", "1", flag])
    try:
        main(args)  # no SystemExit naming ``match``
        fleet.heartbeat(closed=True)
        spool = fleet.spool_dir()
        assert spool and spool.startswith(os.path.join(out, ".telemetry"))
        assert any(n.startswith("snapshot-pid") for n in os.listdir(spool))
    finally:
        fleet._reset_for_tests()
        registry().reset()
        tracing._reset_for_tests()
    want = _cli("lddl_tpu.cli.preprocess_bart_pretrain", corpus,
                str(tmp_path / "ref"))
    names = sorted(n for n in os.listdir(want))
    assert sorted(n for n in os.listdir(out) if n != ".telemetry") == names
    for name in names:
        with open(os.path.join(out, name), "rb") as a, \
                open(os.path.join(want, name), "rb") as b:
            assert a.read() == b.read(), name


@pytest.mark.parametrize("tokenized", [True, False], ids=["v2", "v1"])
def test_balanced_batches_equal_to_reference(corpus, tmp_path, tokenized):
    """Port preprocess -> port balancer -> port BART loader gives the
    reference chain's batches (lddl_tpu preprocess, balancer, loader)."""
    from lddl_tpu.balance import balance_shards as r_balance
    from lddl_tpu.loader import get_bart_pretrain_data_loader as r_loader
    from lddl_tpu_torch.balance import balance_shards as t_balance
    from lddl_tpu_torch.loader import get_bart_pretrain_data_loader
    root, vocab = corpus
    r_pre = _run(R, corpus, str(tmp_path / "rpre"), tokenized)
    t_pre = _run(T, corpus, str(tmp_path / "tpre"), tokenized)
    r_balance(r_pre, str(tmp_path / "rbal"), 4)
    t_balance(t_pre, str(tmp_path / "tbal"), 4)
    _assert_same_bytes(str(tmp_path / "tbal"), str(tmp_path / "rbal"))
    for dp_rank in (0, 1):
        kw = dict(dp_rank=dp_rank, num_dp_groups=2, batch_size=4,
                  vocab_file=vocab, shuffle_buffer_size=32,
                  shuffle_buffer_warmup_factor=4, base_seed=11,
                  max_seq_length=64)
        want = list(r_loader(str(tmp_path / "rbal"), log_level=50, **kw))
        got = list(get_bart_pretrain_data_loader(str(tmp_path / "tbal"),
                                                 **kw))
        shards.assert_same_batches(got, want, "dp {}".format(dp_rank))
