"""The port's streaming ingestion (lddl_tpu_torch.ingest, balance.delta and
cli.ingest_watch) against lddl_tpu's, each case running both packages on
the same landing set built live from a seed: the two generation trees
are byte-equal in every file (shards, ``.num_samples.json`` with
``__sizes__``, manifests with the generation gate, journal segments and
cache, carry files), across

- the journal: content hashing and dedup, a torn cache, the journal-read
  fault site, a torn or missing segment, hash-only bytes;
- the delta plan arithmetic (``plan_bin_delta``, ``plan_flush``);
- generation 0's classic layout, rounds that leave prior bytes
  untouched, carry then flush, binned and packed generations, adoption
  of a balanced directory, config drift refused, an explicit file list;
- the crash and filesystem-order matrix (intake and commit crashes, then
  reversed enumeration) on the local and the mock backend, and the
  republish after a staging crash;
- ``ingest_watch --once`` against the reference's CLI;

and the port's loader serving the grown directory as the reference's
loader does; ``ingest_once(elastic=True)`` with a helper host in
``join_pending_generation`` (after a crash, and at once), and
``ingest_watch --elastic`` / ``--join-pending``. Exact equality
throughout.
"""

import importlib
import json
import os
import shutil
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import _torch_loader_shards as shards  # noqa: E402


class Pkg:
    """One package's ingest surface."""

    def __init__(self, name):
        self.name = name

        def imp(m):
            return importlib.import_module(name + "." + m)

        self.ingest = imp("ingest")
        self.journal = imp("ingest.journal")
        self.delta = imp("balance.delta")
        self.faults = imp("resilience.faults")
        self.backend = imp("resilience.backend")
        self.fs = imp("utils.fs")
        self.pre = imp("preprocess")
        self.integrity = imp("resilience.integrity")
        self.loader = imp("loader")
        self.balance = imp("balance")

    def config(self, **kw):
        kw.setdefault("max_seq_length", 32)
        kw.setdefault("masking", False)
        return self.pre.BertPretrainConfig(**kw)

    def tok(self, vocab):
        return self.pre.get_tokenizer(vocab_file=vocab)

    def load(self, root, **kw):
        if self.name == "lddl_tpu":
            kw["log_level"] = 50
        return self.loader.get_bert_pretrain_data_loader(root, **kw)


REF, PORT = Pkg("lddl_tpu"), Pkg("lddl_tpu_torch")
BOTH = pytest.mark.parametrize("pkg", [REF, PORT], ids=["ref", "port"])


@pytest.fixture(autouse=True)
def _disarmed(monkeypatch):
    monkeypatch.setenv("LDDL_TPU_RETRY_BASE_DELAY_S", "0.001")
    PORT.faults.disarm()
    yield
    PORT.faults.disarm()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """60 documents in 3 files (Philox seed 77) and their vocab."""
    root = str(tmp_path_factory.mktemp("icorpus"))
    return shards.build_corpus(root, num_docs=60, num_files=3, seed=77)


def _landing(base, corpus, n_files, name):
    """A landing dir holding the first ``n_files`` corpus files (the
    growing corpus: each round adds one file)."""
    d = os.path.join(base, name, "source")
    os.makedirs(d, exist_ok=True)
    for i in range(n_files):
        shutil.copy(os.path.join(corpus[0], "source", "{}.txt".format(i)),
                    os.path.join(d, "{}.txt".format(i)))
    return os.path.join(base, name)


KW = dict(num_shards=4, seed=7)
KWP = dict(num_shards=4, seed=7, pack_seq_length=64, pack_max_per_row=8)


def _replay(pkg, root, corpus, rounds, cfg=None, **kw):
    """``ingest_once`` after each landing growth; one landing dir per
    target (a landing only grows)."""
    base = os.path.dirname(root)
    name = "landing-" + os.path.basename(root)
    reps = []
    for n_files in rounds:
        reps.append(pkg.ingest.ingest_once(
            root, pkg.tok(corpus[1]),
            landing=_landing(base, corpus, n_files, name),
            config=cfg or pkg.config(), **kw))
    return reps


def _tree(root):
    """{relpath: bytes} of every file under ``root``: the mock store's
    object records (``.obj.*``, named by uploader pid) are skipped, their
    materialized views are compared."""
    out = {}
    for dirpath, dirnames, names in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames if not d.startswith(".obj."))
        for n in sorted(names):
            p = os.path.join(dirpath, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def _assert_same_tree(got, want, with_shards=True):
    a, b = _tree(got), _tree(want)
    assert sorted(a) == sorted(b)
    for rel in b:
        assert a[rel] == b[rel], rel
    assert any(".ingest" in rel for rel in b)
    assert with_shards == any(rel.endswith(".parquet") or ".parquet_" in rel
                              for rel in b)


def _counts_by_bin(pkg, root):
    by_bin = {}
    for p in pkg.fs.get_all_parquets_under(root):
        by_bin.setdefault(pkg.fs.get_bin_id_of_path(p), []).append(
            pkg.fs.get_num_samples_of_parquet(p))
    return by_bin


def _assert_balanced(pkg, root):
    for b, counts in _counts_by_bin(pkg, root).items():
        assert max(counts) - min(counts) <= 1, (b, sorted(counts))


def _shard_bytes(pkg, root):
    out = {}
    for p in pkg.fs.get_all_parquets_under(root):
        with open(p, "rb") as f:
            out[os.path.relpath(p, root)] = f.read()
    return out


# ------------------------------------------------------------------ journal


def test_doc_content_hash_is_the_reference_hash():
    for text in (b"hello world", "héllo wörld", b""):
        got = PORT.journal.doc_content_hash(text)
        assert got == REF.journal.doc_content_hash(text)
    assert PORT.journal.doc_content_hash(b"a") != \
        PORT.journal.doc_content_hash(b"b")
    assert PORT.journal.doc_content_hash(b"x y") == \
        PORT.journal.doc_content_hash("x y")


@BOTH
def test_diff_landing_dedups_by_content(tmp_path, pkg):
    d = tmp_path / "land" / "source"
    d.mkdir(parents=True)
    (d / "a.txt").write_text("d1 same text\nd2 other text\n")
    (d / "b.txt").write_text("d3 same text\n")   # duplicate content
    j = pkg.journal.Journal(str(tmp_path / "root"))
    docs, stats = pkg.journal.diff_landing(j, landing=str(tmp_path / "land"))
    assert stats == {"docs_seen": 3, "docs_new": 2, "dupes_in_scan": 1}
    j.entries[pkg.journal.doc_content_hash(b"other text")] = 0
    docs, _ = pkg.journal.diff_landing(j, landing=str(tmp_path / "land"))
    assert list(docs.values()) == [b"same text"]


def _publish_three(pkg, root):
    j = pkg.journal.Journal(root)
    j.publish_generation(0, ["h2", "h1"], "fp")   # unsorted on purpose
    j.publish_generation(1, ["h3"], "fp", carry={"unbinned": "c.parquet"})
    j.publish_generation(2, ["h4"], "fp", doc_bytes=11)
    return j


def test_journal_bytes_equal_and_hash_only(tmp_path):
    for pkg, sub in ((REF, "ref"), (PORT, "port")):
        _publish_three(pkg, str(tmp_path / sub))
    _assert_same_tree(str(tmp_path / "port"), str(tmp_path / "ref"),
                      with_shards=False)
    seg = PORT.journal.segment_path(str(tmp_path / "port"), 0)
    assert json.load(open(seg))["hashes"] == ["h1", "h2"]


@BOTH
def test_torn_cache_degrades_to_segment_rescan(tmp_path, pkg):
    root = str(tmp_path)
    _publish_three(pkg, root)
    cache = os.path.join(pkg.journal.ingest_root(root), "journal.json")
    with open(cache, "w") as f:
        f.write('{"entries": {"h1"')
    j = pkg.journal.Journal.load(root)
    assert j.entries == {"h1": 0, "h2": 0, "h3": 1, "h4": 2}
    assert j.generation == 2 and j.carry == {}


@BOTH
def test_journal_read_fault_site(tmp_path, pkg):
    root = str(tmp_path)
    j = pkg.journal.Journal(root)
    j.publish_generation(0, ["h1"], "fp")
    # A torn cache that the rescan recovers: poison the cache's entries
    # so a read of it would be visible.
    cache = os.path.join(pkg.journal.ingest_root(root), "journal.json")
    rec = json.load(open(cache))
    rec["entries"]["bogus"] = 0
    with open(cache, "w") as f:
        json.dump(rec, f)
    pkg.faults.arm("journal-read:truncate:nth=1:path=journal.json")
    try:
        j2 = pkg.journal.Journal.load(root)
    finally:
        pkg.faults.disarm()
    assert j2.entries == {"h1": 0}


@BOTH
@pytest.mark.parametrize("damage,match", [
    ("torn", "torn or unparseable"),
    ("missing", r"generation\(s\) \[1\] are missing"),
])
def test_segment_damage_is_fatal(tmp_path, pkg, damage, match):
    root = str(tmp_path)
    _publish_three(pkg, root)
    seg = pkg.journal.segment_path(root, 1)
    if damage == "torn":
        with open(seg, "w") as f:
            f.write('{"generation"')
    else:
        os.remove(seg)
    os.remove(os.path.join(pkg.journal.ingest_root(root), "journal.json"))
    with pytest.raises(ValueError, match=match):
        pkg.journal.Journal.load(root)


@BOTH
def test_out_of_order_publish_refused(tmp_path, pkg):
    j = pkg.journal.Journal(str(tmp_path))
    with pytest.raises(ValueError, match="out of order"):
        j.publish_generation(1, [], "fp")


@BOTH
def test_segment_commit_is_exclusive_on_the_mock_store(tmp_path, monkeypatch,
                                                       pkg):
    """On the mock store the segment commit is a conditional create: a
    repeat of the same content is absorbed, other content refuses."""
    monkeypatch.setenv(pkg.backend.ENV_VAR, "mock")
    path = pkg.journal.segment_path(str(tmp_path), 0)
    rec = {"generation": 0, "hashes": ["a"]}
    pkg.journal.publish_record(path, rec, exclusive=True)
    pkg.journal.publish_record(path, dict(rec), exclusive=True)
    with pytest.raises(ValueError, match="conflicting concurrent commit"):
        pkg.journal.publish_record(path, {"generation": 0, "hashes": ["b"]},
                                   exclusive=True)
    rio = importlib.import_module(pkg.name + ".resilience.io")
    assert rio.read_json(path) == (rec, "ok")
    rio.remove(path)
    assert rio.read_json(path) == (None, "missing")


# ------------------------------------------------------- delta plan math


@BOTH
def test_plan_bin_delta_arithmetic(pkg):
    d = pkg.delta
    assert d.plan_bin_delta([100, 100, 101], 250) == (100, 2, 2, 48)
    assert d.plan_bin_delta([100], 100) == (100, 1, 0, 0)
    assert d.plan_bin_delta([100, 100], 60) == (100, 0, 0, 60)
    assert d.plan_bin_delta([7, 8, 8], 23) == (7, 3, 2, 0)
    with pytest.raises(ValueError, match="not balanced"):
        d.plan_bin_delta([100, 102], 10)
    with pytest.raises(ValueError, match="at least one prior"):
        d.plan_bin_delta([], 10)


@BOTH
def test_plan_flush_picks_the_cheaper_move(pkg):
    d = pkg.delta
    assert d.plan_flush([100] * 10, 100, 2) == ("absorb", 2)
    assert d.plan_flush([101] * 10, 100, 98) == ("pull", 2)
    assert d.plan_flush([100] * 5 + [101] * 5, 100, 5) == ("absorb", 5)
    with pytest.raises(ValueError, match="cannot flush"):
        d.plan_flush([100, 100, 101, 101], 100, 50)


# ------------------------------------------------ incremental generations


def test_gen0_classic_layout_equal_to_reference(corpus, tmp_path):
    reps = {}
    for pkg, sub in ((REF, "ref"), (PORT, "port")):
        reps[sub] = _replay(pkg, str(tmp_path / sub), corpus, (2,), **KW)[0]
    assert reps["port"] == reps["ref"]
    root = str(tmp_path / "port")
    assert not reps["port"]["noop"] and reps["port"]["generation"] == 0
    names = sorted(os.path.basename(p)
                   for p in PORT.fs.get_all_parquets_under(root))
    assert names == ["shard-{}.parquet".format(i) for i in range(4)]
    _assert_balanced(PORT, root)
    meta = PORT.integrity.read_manifest(root)["__meta__"]
    assert meta["generation"] == 0 and meta["generations"]["0"] == names
    assert set(PORT.fs.read_num_samples_cache(root)["__sizes__"]) == \
        set(names)
    _assert_same_tree(root, str(tmp_path / "ref"))


def test_rounds_leave_prior_bytes_untouched(corpus, tmp_path):
    """Three rounds and a rescan: after every round the port's tree equals
    the reference's, prior shards keep their bytes, bins stay within 1,
    and the rescan of an unchanged landing is a no-op."""
    roots = {s: str(tmp_path / s) for s in ("ref", "port")}
    prior = {}
    for n_files in (1, 2, 3):
        reps = {s: _replay(pkg, roots[s], corpus, (n_files,), **KW)[0]
                for pkg, s in ((REF, "ref"), (PORT, "port"))}
        assert reps["port"] == reps["ref"] and not reps["port"]["noop"]
        assert reps["port"]["touched_prior_shards"] == []
        _assert_same_tree(roots["port"], roots["ref"])
        now = _shard_bytes(PORT, roots["port"])
        assert all(now[rel] == b for rel, b in prior.items())
        prior = now
        _assert_balanced(PORT, roots["port"])
    rep = _replay(PORT, roots["port"], corpus, (3,), **KW)[0]
    assert rep["noop"] and rep["generation"] == 2
    gens = {PORT.fs.get_generation_of_path(roots["port"], p)
            for p in PORT.fs.get_all_parquets_under(roots["port"])}
    assert gens == {0, 1, 2}


def test_carry_then_flush_equal_to_reference(corpus, tmp_path):
    roots = {s: str(tmp_path / s) for s in ("ref", "port")}
    for pkg, s in ((REF, "ref"), (PORT, "port")):
        _replay(pkg, roots[s], corpus, (1, 2), **KW)
    _assert_same_tree(roots["port"], roots["ref"])
    j = PORT.journal.Journal.load(roots["port"])
    carried = sum(PORT.fs.get_num_samples_of_parquet(
        os.path.join(PORT.journal.carry_dir(roots["port"]), n))
        for n in j.carry.values())
    assert carried > 0, "the corpus should leave a carryover remainder"
    visible = sum(map(sum, _counts_by_bin(PORT, roots["port"]).values()))
    before = _shard_bytes(PORT, roots["port"])
    reps = {s: _replay(pkg, roots[s], corpus, (2,), flush_tail=True, **KW)[0]
            for pkg, s in ((REF, "ref"), (PORT, "port"))}
    assert reps["port"] == reps["ref"]
    rep = reps["port"]
    assert not rep["noop"] and rep["docs"] == 0 and rep["carry_rows"] == 0
    assert not PORT.journal.Journal.load(roots["port"]).carry
    _assert_balanced(PORT, roots["port"])
    assert sum(map(sum, _counts_by_bin(PORT, roots["port"]).values())) == \
        visible + carried
    after = _shard_bytes(PORT, roots["port"])
    for rel in before:
        if rel not in rep["touched_prior_shards"]:
            assert after[rel] == before[rel], rel
    _assert_same_tree(roots["port"], roots["ref"])


def test_binned_generations_and_their_batches(corpus, tmp_path):
    roots = {s: str(tmp_path / s) for s in ("ref", "port")}
    for pkg, s in ((REF, "ref"), (PORT, "port")):
        _replay(pkg, roots[s], corpus, (2, 3),
                cfg=pkg.config(masking=True), num_shards=2, seed=7,
                bin_size=16)
    _assert_same_tree(roots["port"], roots["ref"])
    _assert_balanced(PORT, roots["port"])
    kw = dict(vocab_file=corpus[1], batch_size=8, base_seed=5)
    shards.assert_same_batches(PORT.load(roots["port"], **kw),
                               REF.load(roots["ref"], **kw), "binned")


def test_packed_generations_equal_to_reference(corpus, tmp_path):
    roots = {s: str(tmp_path / s) for s in ("ref", "port")}
    for pkg, s in ((REF, "ref"), (PORT, "port")):
        _replay(pkg, roots[s], corpus, (1, 2), **KWP)
    _assert_same_tree(roots["port"], roots["ref"])
    meta = PORT.integrity.read_manifest(roots["port"])["__meta__"]
    assert meta["packed"] == {"pack_seq_length": 64, "pack_max_per_row": 8}
    from lddl_tpu_torch.loader.bert import BertPrepackedCollate
    kw = dict(vocab_file=corpus[1], base_seed=5, batch_size=4)
    port = PORT.load(roots["port"], **kw)
    assert isinstance(port._collate_fn, BertPrepackedCollate)
    shards.assert_same_batches(port, REF.load(roots["ref"], **kw), "packed")


def test_adoption_of_a_balanced_directory(corpus, tmp_path):
    """An offline-balanced root (each package's own preprocess and
    balancer) is adopted as generation 0, its bytes untouched; the delta
    appends as generation 1."""
    roots = {}
    for pkg, s in ((REF, "ref"), (PORT, "port")):
        pre, root = str(tmp_path / (s + "_pre")), str(tmp_path / s)
        pkg.pre.run_bert_preprocess(
            {"wikipedia": _landing(str(tmp_path), corpus, 2, s + "_land")},
            pre, pkg.tok(corpus[1]), config=pkg.config(), num_blocks=4,
            sample_ratio=1.0, seed=7)
        pkg.balance.balance_shards(pre, root, 4)
        roots[s] = root
    before = _shard_bytes(PORT, roots["port"])
    reps = {s: _replay(pkg, roots[s], corpus, (3,), **KW)[0]
            for pkg, s in ((REF, "ref"), (PORT, "port"))}
    assert reps["port"] == reps["ref"] and reps["port"]["generation"] == 1
    after = _shard_bytes(PORT, roots["port"])
    assert all(after[rel] == b for rel, b in before.items())
    _assert_balanced(PORT, roots["port"])
    j = PORT.journal.Journal.load(roots["port"])
    assert j.generation == 1 and 0 not in set(j.entries.values())
    _assert_same_tree(roots["port"], roots["ref"])


@BOTH
def test_config_drift_refused(corpus, tmp_path, pkg):
    root = str(tmp_path / "root")
    _replay(pkg, root, corpus, (1,), **KW)
    with pytest.raises(ValueError, match="drift"):
        _replay(pkg, root, corpus, (2,), num_shards=4, seed=8)
    with pytest.raises(ValueError, match="splitter='rules'"):
        _replay(pkg, root, corpus, (2,),
                cfg=pkg.config(splitter="learned"), **KW)


def test_explicit_file_list(corpus, tmp_path):
    files = [os.path.join(corpus[0], "source", "0.txt")]
    for pkg, s in ((REF, "ref"), (PORT, "port")):
        root = str(tmp_path / s)
        rep = pkg.ingest.ingest_once(root, pkg.tok(corpus[1]), files=files,
                                     config=pkg.config(), **KW)
        assert not rep["noop"]
        rep = pkg.ingest.ingest_once(root, pkg.tok(corpus[1]), files=files,
                                     config=pkg.config(), **KW)
        assert rep["noop"]
    _assert_same_tree(str(tmp_path / "port"), str(tmp_path / "ref"))
    with pytest.raises(ValueError, match="exactly one of"):
        PORT.ingest.ingest_once(str(tmp_path / "x"), PORT.tok(corpus[1]),
                                config=PORT.config(), **KW)


# ---------------------------------------------- crash / replay equivalence


def _reversed_fs(monkeypatch):
    real_walk, real_listdir = os.walk, os.listdir

    def reversed_walk(top, **kwargs):
        for dirpath, dirnames, filenames in real_walk(top, **kwargs):
            rd = list(reversed(sorted(dirnames)))
            yield dirpath, rd, list(reversed(sorted(filenames)))
            dirnames[:] = rd   # the consumer's pruning reaches the walk

    monkeypatch.setattr(os, "walk", reversed_walk)
    monkeypatch.setattr(os, "listdir",
                        lambda p=".": list(reversed(sorted(real_listdir(p)))))


@pytest.mark.parametrize("backend", ["local", "mock"])
def test_crash_and_fs_order_matrix(corpus, tmp_path, monkeypatch, backend):
    """The port's root that crashed at a journal commit and at an intake
    publish, resumed, and ran its last round under reversed filesystem
    enumeration is byte-equal to the reference's clean replay, and
    serves the same batches (unbinned and load-time packed)."""
    monkeypatch.setenv(PORT.backend.ENV_VAR, backend)
    clean, dirty = str(tmp_path / "clean"), str(tmp_path / "dirty")
    _replay(REF, clean, corpus, (1, 2, 3), **KW)
    _replay(PORT, dirty, corpus, (1,), **KW)
    PORT.faults.arm("journal-publish:eio:nth=1:path=journal/gen-0001")
    with pytest.raises(OSError):
        _replay(PORT, dirty, corpus, (2,), **KW)
    PORT.faults.disarm()
    assert PORT.journal.Journal.load(dirty).pending_work() is not None
    _replay(PORT, dirty, corpus, (2,), **KW)
    PORT.faults.arm("journal-publish:eio:nth=1:path=intake")
    with pytest.raises(OSError):
        _replay(PORT, dirty, corpus, (3,), **KW)
    PORT.faults.disarm()
    with monkeypatch.context() as m:
        _reversed_fs(m)
        _replay(PORT, dirty, corpus, (3,), **KW)
    _assert_same_tree(dirty, clean)
    for kwargs in (dict(batch_size=16),
                   dict(batch_size=16, pack_seq_length=64, pack_rows=4)):
        kw = dict(vocab_file=corpus[1], base_seed=5, **kwargs)
        shards.assert_same_batches(PORT.load(dirty, **kw),
                                   REF.load(clean, **kw), str(kwargs))


def test_packed_commit_crash_under_reversed_order(corpus, tmp_path,
                                                  monkeypatch):
    clean, dirty = str(tmp_path / "clean"), str(tmp_path / "dirty")
    _replay(REF, clean, corpus, (1, 2), **KWP)
    _replay(PORT, dirty, corpus, (1,), **KWP)
    PORT.faults.arm("journal-publish:eio:nth=1:path=journal/gen-0001")
    with pytest.raises(OSError):
        _replay(PORT, dirty, corpus, (2,), **KWP)
    PORT.faults.disarm()
    with monkeypatch.context() as m:
        _reversed_fs(m)
        _replay(PORT, dirty, corpus, (2,), **KWP)
    _assert_same_tree(dirty, clean)


def test_republish_after_a_staging_crash(corpus, tmp_path):
    """A crash between the balance plan marker and the journal commit
    re-enters at the publish phase (the staged bytes are copied again,
    not recomputed) and ends byte-equal to the reference's clean run."""
    clean, dirty = str(tmp_path / "clean"), str(tmp_path / "dirty")
    _replay(REF, clean, corpus, (2, 3), **KW)
    _replay(PORT, dirty, corpus, (2,), **KW)
    PORT.faults.arm("journal-publish:eio:nth=1:path=journal/gen-0001")
    with pytest.raises(OSError):
        _replay(PORT, dirty, corpus, (3,), **KW)
    PORT.faults.disarm()
    wdir = PORT.journal.work_dir(dirty, 1)
    assert PORT.delta.read_plan(os.path.join(wdir, "balance")) is not None
    _replay(PORT, dirty, corpus, (3,), **KW)
    assert not os.path.isdir(wdir)
    _assert_same_tree(dirty, clean)


def test_elastic_ingest_reaches_the_runner_refusal(corpus, tmp_path):
    """``ingest_once(elastic=True)`` and ``join_pending_generation`` run
    on the port's elastic schedule (the name is kept from when the runner
    refused them). An elastic round dies mid-preprocess after its intake
    record froze the doc set (every deferred publish fails at the
    ``sink-write`` site); a helper host joins the pending generation and
    finishes its preprocess from the journal alone, without committing;
    a second helper finds nothing to do; a helper with drifted config
    refuses; the primary's elastic resume publishes the round. The tree
    is byte-equal to the reference's clean replay."""
    root = str(tmp_path / "root")
    _replay(PORT, root, corpus, (1,), **KW)
    tok = PORT.tok(corpus[1])
    rep = PORT.ingest.join_pending_generation(root, tok,
                                              config=PORT.config())
    assert rep == {"joined": False, "why": "no in-flight generation"}
    PORT.faults.arm("sink-write:eio:p=1.0")
    try:
        with pytest.raises(RuntimeError, match="re-run with resume"):
            _replay(PORT, root, corpus, (2,), elastic=True, lease_ttl=5.0,
                    holder_id="primary", **KW)
    finally:
        PORT.faults.disarm()
    rep = PORT.ingest.join_pending_generation(
        root, tok, config=PORT.config(), lease_ttl=5.0, holder_id="helper")
    assert rep == {"joined": True, "generation": 1}
    assert PORT.journal.Journal.load(root).pending_work() is not None
    rep = PORT.ingest.join_pending_generation(
        root, tok, config=PORT.config(), lease_ttl=5.0, holder_id="helper2")
    assert rep == {"joined": False, "why": "preprocess already finalized"}
    with pytest.raises(ValueError, match="fingerprint"):
        PORT.ingest.join_pending_generation(
            root, tok, config=PORT.config(duplicate_factor=2))
    _replay(PORT, root, corpus, (2,), elastic=True, lease_ttl=5.0,
            holder_id="primary", **KW)
    clean = str(tmp_path / "clean")
    _replay(REF, clean, corpus, (1, 2), **KW)
    _assert_same_tree(root, clean)


def test_elastic_ingest_with_a_joining_host_matches_reference(corpus,
                                                              tmp_path):
    """An elastic ingest round and a helper host polling
    ``join_pending_generation`` run at once (threads standing in for
    hosts); whichever units each claims, the generation tree is
    byte-equal to the reference's static replay."""
    import threading
    import time
    root = str(tmp_path / "root")
    _replay(PORT, root, corpus, (1,), **KW)
    tok = PORT.tok(corpus[1])
    primary_done = threading.Event()
    helper = {}
    # Thread-hosts share one pid, so the helper waits for the primary's
    # plan manifest (hosts in one process would collide on its temp
    # file; processes do not).
    manifest = os.path.join(PORT.journal.work_dir(root, 1), "pre", "_done",
                            "manifest.json")

    def help_out():
        while not primary_done.is_set():
            if not os.path.exists(manifest):
                time.sleep(0.005)
                continue
            rep = PORT.ingest.join_pending_generation(
                root, tok, config=PORT.config(), lease_ttl=5.0,
                holder_id="helper")
            if rep["joined"]:
                helper["rep"] = rep
                return
            time.sleep(0.01)

    t = threading.Thread(target=help_out)
    t.start()
    try:
        reps = _replay(PORT, root, corpus, (3,), elastic=True,
                       lease_ttl=5.0, holder_id="primary", **KW)
    finally:
        primary_done.set()
        t.join()
    assert reps[0]["generation"] == 1 and not reps[0]["noop"]
    clean = str(tmp_path / "clean")
    _replay(REF, clean, corpus, (1, 3), **KW)
    _assert_same_tree(root, clean)


# ------------------------------------------- generation-aware loading


def test_census_recounts_only_untrusted_entries(corpus, tmp_path,
                                                monkeypatch):
    root = str(tmp_path / "root")
    _replay(PORT, root, corpus, (2, 3), **KW)
    cache = PORT.fs.read_num_samples_cache(root)
    victim = sorted(n for n in cache if n.endswith(".parquet"))[0]
    cache["__sizes__"][victim] += 1
    with open(os.path.join(root, ".num_samples.json"), "w") as f:
        json.dump(cache, f)
    import lddl_tpu_torch.loader.datasets as datasets_mod
    calls = []
    real = datasets_mod.get_num_samples_of_parquet
    monkeypatch.setattr(datasets_mod, "get_num_samples_of_parquet",
                        lambda p: calls.append(p) or real(p))
    PORT.load(root, vocab_file=corpus[1], batch_size=8, base_seed=5)
    assert [os.path.basename(p) for p in calls] == [victim]


@BOTH
def test_sized_cache_is_trusted_per_entry(tmp_path, pkg):
    d = str(tmp_path)
    for name, payload in (("shard-0.parquet", b"aaaa"),
                          ("shard-1.parquet", b"bbbbbb")):
        with open(os.path.join(d, name), "wb") as f:
            f.write(payload)
    pkg.fs.write_num_samples_cache(
        d, {"shard-0.parquet": 10, "shard-1.parquet": 11}, with_sizes=True)
    cache = pkg.fs.read_num_samples_cache(d)
    assert cache["__sizes__"] == {"shard-0.parquet": 4, "shard-1.parquet": 6}
    with open(os.path.join(d, "shard-1.parquet"), "wb") as f:
        f.write(b"ccccccccc")
    with open(os.path.join(d, "shard-2.parquet"), "wb") as f:
        f.write(b"dd")
    trusted, untrusted = pkg.fs.trusted_num_samples_entries(d, cache)
    assert trusted == {"shard-0.parquet": 10}
    assert untrusted == {"shard-1.parquet", "shard-2.parquet"}
    legacy = {"shard-0.parquet": 5}
    assert pkg.fs.num_samples_cache_is_stale(d, legacy)
    assert pkg.fs.trusted_num_samples_entries(d, legacy)[0] == {}
    assert pkg.fs.generation_dir_name(3) == "gen-0003"
    with pytest.raises(ValueError, match="generation 0"):
        pkg.fs.generation_dir_name(0)


# ---------------------------------------------------------------- CLI


def test_ingest_watch_once_equal_to_reference(corpus, tmp_path, capsys):
    from lddl_tpu.cli import ingest_watch as ref_cli
    from lddl_tpu_torch.cli import ingest_watch as port_cli
    for cli, s in ((ref_cli, "ref"), (port_cli, "port")):
        argv = ["--landing", _landing(str(tmp_path), corpus, 2, s + "_land"),
                "--sink", str(tmp_path / s), "--vocab-file", corpus[1],
                "--target-seq-length", "32", "--num-shards", "4",
                "--seed", "7", "--tokenizer-engine", "native", "--once"]
        cli.main(cli.attach_args().parse_args(argv))
        assert "'generation': 0" in capsys.readouterr().out
        cli.main(cli.attach_args().parse_args(argv))
        assert "'noop': True" in capsys.readouterr().out
    _assert_same_tree(str(tmp_path / "port"), str(tmp_path / "ref"))


def test_ingest_watch_elastic_and_join_pending(corpus, tmp_path, capsys):
    """``ingest_watch --elastic --once`` writes the reference CLI's static
    tree; ``--join-pending --once`` with nothing in flight reports so and
    exits."""
    from lddl_tpu.cli import ingest_watch as ref_cli
    from lddl_tpu_torch.cli import ingest_watch as port_cli
    base = ["--vocab-file", corpus[1], "--target-seq-length", "32",
            "--num-shards", "4", "--seed", "7", "--once"]
    for cli, s, extra in ((ref_cli, "ref", []),
                          (port_cli, "port", ["--elastic", "--lease-ttl",
                                              "5", "--elastic-host-id",
                                              "h0"])):
        argv = ["--landing", _landing(str(tmp_path), corpus, 2, s + "_land"),
                "--sink", str(tmp_path / s)] + base + extra
        cli.main(cli.attach_args().parse_args(argv))
        assert "'generation': 0" in capsys.readouterr().out
    _assert_same_tree(str(tmp_path / "port"), str(tmp_path / "ref"))
    argv = ["--landing", str(tmp_path / "port_land"), "--sink",
            str(tmp_path / "port"), "--join-pending",
            "--elastic-host-id", "h1"] + base
    port_cli.main(port_cli.attach_args().parse_args(argv))
    assert "no in-flight generation" in capsys.readouterr().out


@pytest.mark.parametrize("flags,match", [
    (["--fleet-telemetry"], "not ported"),
    (["--autoscale", "--once"], "requires the watch loop"),
    (["--autoscale"], "needs --elastic"),
    (["--autoscale", "--elastic"], "needs --fleet-telemetry"),
    (["--autoscale", "--elastic", "--fleet-telemetry"], "not ported"),
])
def test_ingest_watch_refuses_unported_flags(corpus, tmp_path, flags, match):
    """The reference's own checks still refuse ``--autoscale`` without
    the watch loop, ``--elastic`` or ``--fleet-telemetry``. The flags the
    port once refused by name (``match`` "not ported") are ported: they
    now run one watch round, fleet-armed, and leave a spool."""
    from lddl_tpu_torch.cli import ingest_watch as cli
    from lddl_tpu_torch.observability import fleet, registry, tracing
    argv = ["--landing", _landing(str(tmp_path), corpus, 1, "land"),
            "--sink", str(tmp_path / "root"), "--vocab-file", corpus[1],
            "--target-seq-length", "32", *flags]
    if match != "not ported":
        with pytest.raises((SystemExit, NotImplementedError), match=match):
            cli.main(cli.attach_args().parse_args(argv))
        assert not PORT.fs.get_all_parquets_under(str(tmp_path / "root")) \
            if os.path.isdir(str(tmp_path / "root")) else True
        return
    try:
        cli.main(cli.attach_args().parse_args(
            argv + ["--max-rounds", "1", "--interval", "0.1"]))
        fleet.heartbeat(closed=True)
        report = fleet.aggregate(str(tmp_path / "root"))
    finally:
        fleet._reset_for_tests()
        registry().reset()
        tracing._reset_for_tests()
    assert PORT.fs.get_all_parquets_under(str(tmp_path / "root"))
    (host,) = report["hosts"].values()
    assert host["event_counts"].get("generation.committed") == 1
    assert report["health"]["ok"], report["health"]["verdicts"]


FLAG_KEYS = ("elastic", "lease_ttl", "elastic_host_id", "scatter_units",
             "storage_backend", "fleet_telemetry")


@pytest.mark.parametrize("cli,argv", [
    ("preprocess_bert_pretrain", ["--wikipedia", "c", "--sink", "s",
                                  "--vocab-file", "v"]),
    ("preprocess_bart_pretrain", ["--wikipedia", "c", "--sink", "s"]),
    ("balance_shards", ["--indir", "i", "--outdir", "o",
                        "--num-shards", "2"]),
    ("ingest_watch", ["--landing", "l", "--sink", "s"]),
])
@pytest.mark.parametrize("extra", [
    [],
    ["--elastic", "--lease-ttl", "7.5", "--elastic-host-id", "h1",
     "--scatter-units", "3", "--storage-backend", "mock",
     "--fleet-telemetry"],
])
def test_storage_elastic_fleet_flags_parse_as_the_reference(cli, argv,
                                                            extra):
    if cli == "balance_shards":
        extra = [a for a in extra if a in ("--storage-backend", "mock",
                                           "--fleet-telemetry")]
    got, want = (vars(importlib.import_module(
        pkg + ".cli." + cli).attach_args().parse_args(argv + extra))
        for pkg in ("lddl_tpu_torch", "lddl_tpu"))
    keys = [k for k in FLAG_KEYS if k in want]
    assert keys and {k: got[k] for k in keys} == {k: want[k] for k in keys}


@pytest.mark.parametrize("cli", ["preprocess_bert_pretrain",
                                 "balance_shards"])
def test_bert_and_balance_clis_refuse_fleet_telemetry(corpus, tmp_path, cli):
    """Both CLIs once refused ``--fleet-telemetry`` by name; it is ported:
    the run goes through, arms the spool under its output dir, and the
    stage's top-level span and counters land in it."""
    from lddl_tpu_torch.observability import fleet, registry, tracing
    mod = importlib.import_module("lddl_tpu_torch.cli." + cli)
    pre = str(tmp_path / "i")
    if cli == "balance_shards":
        PORT.pre.run_bert_preprocess(
            {"w": corpus[0]}, pre, PORT.tok(corpus[1]),
            config=PORT.config(), num_blocks=3, seed=3)
        args = ["--indir", pre, "--outdir", str(tmp_path / "o"),
                "--num-shards", "2"]
        span, counter = "balance.run", "balance_samples_moved_total"
    else:
        args = ["--wikipedia", corpus[0], "--sink", str(tmp_path / "o"),
                "--vocab-file", corpus[1], "--local-workers", "1"]
        span, counter = "preprocess.run", "preprocess_docs_total"
    try:
        mod.main(mod.attach_args().parse_args(args + ["--fleet-telemetry"]))
        fleet.heartbeat(closed=True)
        spool = fleet.spool_dir()
        report = fleet.aggregate(str(tmp_path / "o"))
    finally:
        fleet._reset_for_tests()
        registry().reset()
        tracing._reset_for_tests()
    assert spool.startswith(os.path.join(str(tmp_path / "o"), ".telemetry"))
    assert PORT.fs.get_all_parquets_under(str(tmp_path / "o"))
    (host,) = report["hosts"].values()
    assert host["closed"] and report["health"]["ok"]
    names = set()
    for name in os.listdir(spool):
        if name.startswith("trace-"):
            with open(os.path.join(spool, name)) as f:
                names.update(json.loads(line)["name"] for line in f)
    assert span in names
    snaps = [n for n in os.listdir(spool) if n.startswith("snapshot-pid")]
    with open(os.path.join(spool, snaps[0])) as f:
        assert counter in json.load(f)["metrics"]


@pytest.mark.parametrize("engine", ["auto", "hf", "native"])
def test_ingest_watch_passes_the_tokenizer_on(engine):
    """``--tokenizer <dir>`` and ``--tokenizer-engine auto|hf|native``
    reach a ``--join-pending`` helper's argv as the reference's do (the
    engine stays in the journal fingerprint through the config)."""
    from lddl_tpu.cli import ingest_watch as ref_cli
    from lddl_tpu_torch.cli import ingest_watch as port_cli
    argv = ["--landing", "/land", "--sink", "/sink", "--tokenizer", "/tok",
            "--tokenizer-engine", engine, "--elastic", "--masking"]
    want = ref_cli._helper_argv(ref_cli.attach_args().parse_args(argv))
    got = port_cli._helper_argv(port_cli.attach_args().parse_args(argv))
    assert got[1:] == [("lddl_tpu_torch.cli.ingest_watch"
                        if a == "lddl_tpu.cli.ingest_watch" else a)
                       for a in want[1:]]
    assert got[got.index("--tokenizer-engine") + 1] == engine
    assert got[got.index("--tokenizer") + 1] == "/tok"
    assert port_cli.attach_args().parse_args(
        ["--landing", "l", "--sink", "s"]).tokenizer_engine == "auto"
