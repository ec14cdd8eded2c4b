"""The reference's runtime switches in the port, each held against
lddl_tpu under the same environment on the same seeded corpus:

- ``LDDL_TPU_SINK_DEPTH``: shards and manifests byte-equal to the
  reference's at depth 0 and 2 and to each other; at 0 no writer thread
  runs and the closures run inline, with the reference's sink stats;
- ``LDDL_TPU_NATIVE_FUSED=0``, ``LDDL_TPU_NATIVE_FUSED_MASK=0``,
  ``LDDL_TPU_NATIVE_MASK=0``: the reference's bytes, the rung each names
  is the one that ran, and a native engine that does not build still
  raises under each (no switch moves to another rung or engine);
- ``LDDL_TPU_MANIFEST=size`` and ``=0``: the reference's manifest bytes
  (or none); a size manifest catches a truncated shard and misses a
  same-length byte flip; the loader loads without a manifest;
- ``LDDL_TPU_MOCK_PART_BYTES`` and ``LDDL_TPU_MOCK_LATENCY_MS``: the
  reference's part count and its sleeps on get, put, list and delete,
  none on head (``time.sleep`` recorded, not the wall timed), and its
  fallbacks for bad values;
- ``LDDL_TPU_PIN_CORES=1``: ``_pin_worker_core``'s slots equal the
  reference's on a fake affinity set, from ``_pool_init`` too, and a
  failure leaves affinity alone;
- ``LDDL_TPU_NATIVE_MARCH``: the reference's ``compile_flags``, a library
  of its own beside the normal one, and the flag on g++'s command line.
"""

import hashlib
import os
import time

import numpy as np
import pytest
import torch

import lddl_tpu.preprocess as R
from lddl_tpu.native import build as rbuild
from lddl_tpu.preprocess import runner as rrunner
from lddl_tpu.resilience import backend as rbackend
from lddl_tpu.resilience import integrity as rintegrity
from lddl_tpu_torch import native as tnative
from lddl_tpu_torch import preprocess as T
from lddl_tpu_torch.native import build as tbuild
from lddl_tpu_torch.preprocess import runner as trunner
from lddl_tpu_torch.preprocess import sink as tsink
from lddl_tpu_torch.resilience import backend as tbackend
from lddl_tpu_torch.resilience import integrity as tintegrity

SWITCHES = ("LDDL_TPU_SINK_DEPTH", "LDDL_TPU_NATIVE_FUSED",
            "LDDL_TPU_NATIVE_FUSED_MASK", "LDDL_TPU_NATIVE_MASK",
            "LDDL_TPU_MANIFEST", "LDDL_TPU_MOCK_PART_BYTES",
            "LDDL_TPU_MOCK_LATENCY_MS", "LDDL_TPU_PIN_CORES",
            "LDDL_TPU_NATIVE_MARCH", "LDDL_TPU_STORAGE_BACKEND")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for key in SWITCHES:
        monkeypatch.delenv(key, raising=False)
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """48 documents of 2-8 sentences in 4 files and their vocab."""
    root = tmp_path_factory.mktemp("swcorpus")
    (root / "source").mkdir()
    words = ("alpha beta gamma delta epsilon zeta eta theta iota kappa "
             "lambda mu nu xi omicron pi rho sigma tau upsilon Café naïve "
             "Dr. U.S. 3.14 e.g.").split()
    g = np.random.Generator(np.random.Philox(key=[0, 11]))
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


def _tree(out):
    """{name: sha256} of every file a run left in ``out``."""
    got = {}
    for name in sorted(os.listdir(out)):
        with open(os.path.join(out, name), "rb") as f:
            got[name] = hashlib.sha256(f.read()).hexdigest()
    return got


def _run(pkg, corpus, out, **cfg):
    """The binned, statically masked, schema-v2 preprocess of ``corpus``
    by ``pkg`` (R or T) in this process; returns the output's digests."""
    root, vocab = corpus
    tok = (R.get_tokenizer(vocab_file=vocab) if pkg is R
           else T.get_tokenizer(vocab))
    extra = {"tokenizer_engine": "native"} if pkg is R else {}
    pkg.run_bert_preprocess(
        {"w": root}, str(out), tok,
        config=pkg.BertPretrainConfig(max_seq_length=64, duplicate_factor=2,
                                      masking=True, **extra, **cfg),
        num_blocks=6, sample_ratio=0.9, seed=3, bin_size=16)
    return _tree(str(out))


@pytest.fixture(scope="module")
def port_default(corpus, tmp_path_factory):
    """The port's output with every switch at its default."""
    saved = {k: os.environ.pop(k) for k in SWITCHES if k in os.environ}
    try:
        return _run(T, corpus, tmp_path_factory.mktemp("swdefault"))
    finally:
        os.environ.update(saved)


# -- LDDL_TPU_SINK_DEPTH -------------------------------------------------


@pytest.mark.parametrize("depth", ["0", "2"])
def test_sink_depth_matches_reference(corpus, port_default, tmp_path,
                                      monkeypatch, depth):
    monkeypatch.setenv("LDDL_TPU_SINK_DEPTH", depth)
    assert tsink.sink_depth() == int(depth)
    writer = tsink.ShardWriter()
    try:
        assert writer.depth == int(depth)
        assert (writer._thread is None) == (depth == "0")
    finally:
        writer.close()
    want = _run(R, corpus, tmp_path / "ref")
    got = _run(T, corpus, tmp_path / "port")
    assert got == want == port_default
    assert ".manifest.json" in got


@pytest.mark.parametrize("value", ["0", "1", "2", "5", "-3", "x", ""])
def test_sink_depth_parses_as_reference(monkeypatch, value):
    from lddl_tpu.preprocess import sink as rsink
    monkeypatch.setenv("LDDL_TPU_SINK_DEPTH", value)
    assert tsink.sink_depth() == rsink.sink_depth()


def _writer_trace(sink_mod, unit_failure=False):
    """Run three closures of two units (the second failing when asked)
    through a depth-0 writer: (threads the closures ran on, completed
    tuples as (unit, written, error type), stats deltas)."""
    import threading
    before = sink_mod.stats_snapshot()
    threads, done = [], []
    w = sink_mod.ShardWriter(depth=0)

    def task(unit, n, fail=False):
        def fn():
            threads.append(threading.get_ident())
            if fail:
                raise OSError("injected")
            return {"{}-{}".format(unit, n): n}
        return fn

    w.submit("a", task("a", 1))
    w.submit("a", task("a", 2))
    w.end_unit("a")
    done += w.completed()
    w.submit("b", task("b", 1, fail=unit_failure))
    w.submit("b", task("b", 2))
    w.end_unit("b")
    done += w.drain()
    w.close()
    after = sink_mod.stats_snapshot()
    return (threads, [(u, written, type(e).__name__ if e else None)
                      for u, written, e in done],
            {k: after[k] - before[k] for k in ("tasks", "units",
                                               "failed_units", "stall_s")})


@pytest.mark.parametrize("fail", [False, True])
def test_depth_zero_writer_runs_inline_like_reference(fail):
    """At depth 0 both writers run every closure on the caller's thread,
    complete units at ``end_unit`` in order, skip a failed unit's other
    closures and count the same tasks, units and failures, with no
    stall."""
    import threading
    from lddl_tpu.preprocess import sink as rsink
    got = _writer_trace(tsink, fail)
    want = _writer_trace(rsink, fail)
    assert set(got[0]) == set(want[0]) == {threading.get_ident()}
    assert got[1:] == want[1:]
    assert got[2]["stall_s"] == 0


# -- the native rungs ------------------------------------------------------

RUNGS = {
    # switch: (rung that must run, rungs that must not)
    "LDDL_TPU_NATIVE_FUSED": ("staged", {"fused", "fused_masked"}),
    "LDDL_TPU_NATIVE_FUSED_MASK": ("fused", {"staged", "fused_masked",
                                             "numpy_mask"}),
    "LDDL_TPU_NATIVE_MASK": ("numpy_mask", {"fused_masked",
                                            "native_mask"}),
}


def _spy_rungs(monkeypatch):
    """Count the port's calls of each rung's entry point."""
    from lddl_tpu_torch.ops import masking as tmasking
    seen = {}

    def wrap(owner, name, rung, result_rung=None):
        real = getattr(owner, name)

        def spy(*a, **kw):
            out = real(*a, **kw)
            seen[rung] = seen.get(rung, 0) + 1
            if result_rung is not None and out is not None:
                seen[result_rung] = seen.get(result_rung, 0) + 1
            return out
        monkeypatch.setattr(owner, name, spy)

    wrap(tnative.NativeTokenizer, "bert_instances_masked", "fused_masked")
    wrap(tnative.NativeTokenizer, "bert_instances", "fused")
    wrap(tnative, "bert_pairs", "staged")
    wrap(tnative, "mask_batch", "mask_batch_called", "native_mask")
    wrap(tmasking, "mask_batch_numpy", "numpy_mask")
    return seen


@pytest.mark.parametrize("switch", sorted(RUNGS))
def test_native_rung_matches_reference(corpus, port_default, tmp_path,
                                       monkeypatch, switch):
    monkeypatch.setenv(switch, "0")
    want = _run(R, corpus, tmp_path / "ref")
    seen = _spy_rungs(monkeypatch)
    got = _run(T, corpus, tmp_path / "port")
    assert got == want == port_default
    rung, absent = RUNGS[switch]
    assert seen.get(rung), seen
    assert not absent & set(seen), seen


def test_default_rung_is_fused_masked(corpus, tmp_path, monkeypatch):
    seen = _spy_rungs(monkeypatch)
    _run(T, corpus, tmp_path / "port")
    assert set(seen) == {"fused_masked"}, seen


@pytest.mark.parametrize("switch", [None] + sorted(RUNGS))
def test_failed_native_build_raises_under_every_switch(corpus, tmp_path,
                                                       monkeypatch, switch):
    """No switch turns a failed build into another rung or engine."""
    if switch is not None:
        monkeypatch.setenv(switch, "0")

    def broken():
        raise RuntimeError("building the native engine failed (g++ exit 1)")

    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tbuild, "ensure_built", broken)
    with pytest.raises(RuntimeError, match="g\\+\\+ exit 1"):
        _run(T, corpus, tmp_path / "port")


def test_switch_readers_match_reference(monkeypatch):
    from lddl_tpu import native as rnative
    for fused in (None, "0", "1"):
        for fused_mask in (None, "0", "1"):
            for mask in (None, "0", "1"):
                for key, value in (("LDDL_TPU_NATIVE_FUSED", fused),
                                   ("LDDL_TPU_NATIVE_FUSED_MASK",
                                    fused_mask),
                                   ("LDDL_TPU_NATIVE_MASK", mask)):
                    if value is None:
                        monkeypatch.delenv(key, raising=False)
                    else:
                        monkeypatch.setenv(key, value)
                assert tnative.fused_enabled() == rnative.fused_enabled()
                assert (tnative.fused_mask_enabled()
                        == rnative.fused_mask_enabled())
                ids = np.array([[2, 9, 10, 11, 3]], dtype=np.int32)
                cand = np.array([[0, 1, 1, 1, 0]], dtype=np.uint8)
                num = np.array([2], dtype=np.int64)
                key = bytes(range(16))
                got = tnative.mask_batch(key, ids, cand, num, 4, 120)
                want = rnative.mask_batch(key, ids, cand, num, 4, 120)
                assert (got is None) == (want is None) == (mask == "0")
                if got is not None:
                    for a, b in zip(got, want):
                        np.testing.assert_array_equal(a, b)


# -- LDDL_TPU_MANIFEST -----------------------------------------------------


def test_size_manifest_matches_reference(corpus, tmp_path, monkeypatch):
    monkeypatch.setenv("LDDL_TPU_MANIFEST", "size")
    want = _run(R, corpus, tmp_path / "ref")
    got = _run(T, corpus, tmp_path / "port")
    assert got == want
    manifest = tintegrity.read_manifest(str(tmp_path / "port"))
    shards = {k: v for k, v in manifest.items() if k != "__meta__"}
    assert shards and all(set(v) == {"bytes"} for v in shards.values())
    assert "__meta__" not in manifest
    assert rintegrity.read_manifest(str(tmp_path / "ref")) == manifest

    # Lengths only, even with CRC checks asked for: a truncated shard is
    # caught, a same-length flip is not (the documented trade).
    names = sorted(shards)
    cut = os.path.join(str(tmp_path / "port"), names[0])
    flip = os.path.join(str(tmp_path / "port"), names[1])
    with open(cut, "rb") as f:
        data = f.read()
    with open(cut, "wb") as f:
        f.write(data[:-7])
    with open(flip, "r+b") as f:
        f.seek(len(data) // 3)
        b = f.read(1)
        f.seek(len(data) // 3)
        f.write(bytes([b[0] ^ 0xFF]))
    paths = [os.path.join(str(tmp_path / "port"), n) for n in names]
    good, excluded = tintegrity.verify_shards(paths, on_corrupt="quarantine",
                                              check_crc=True)
    assert [p for p, _ in excluded] == [cut]
    assert "size mismatch" in excluded[0][1]
    assert flip in good
    rgood, rexcluded = rintegrity.verify_shards(
        paths, on_corrupt="quarantine", check_crc=True)
    assert (rgood, [p for p, _ in rexcluded]) == (good, [cut])


@pytest.mark.parametrize("value", ["full", "1", "other"])
def test_full_manifest_values_match_reference(corpus, tmp_path, monkeypatch,
                                              value):
    monkeypatch.setenv("LDDL_TPU_MANIFEST", value)
    assert tintegrity.manifest_mode() == "full"
    want = _run(R, corpus, tmp_path / "ref")
    got = _run(T, corpus, tmp_path / "port")
    assert got == want
    manifest = tintegrity.read_manifest(str(tmp_path / "port"))
    assert all("crc32" in v for k, v in manifest.items() if k != "__meta__")


def test_no_manifest_and_the_loader_still_loads(corpus, tmp_path,
                                                monkeypatch):
    from lddl_tpu_torch.balance import balance_shards
    from lddl_tpu_torch.loader import get_bert_pretrain_data_loader
    monkeypatch.setenv("LDDL_TPU_MANIFEST", "0")
    want = _run(R, corpus, tmp_path / "ref")
    got = _run(T, corpus, tmp_path / "port")
    assert got == want and ".manifest.json" not in got
    assert tintegrity.build_manifest(str(tmp_path / "port")) is None
    bal = str(tmp_path / "bal")
    balance_shards(str(tmp_path / "port"), bal, 1)
    assert ".manifest.json" not in os.listdir(bal)
    loader = get_bert_pretrain_data_loader(
        bal, vocab_file=corpus[1], batch_size=4, num_workers=0)
    n = sum(int(b["input_ids"].shape[0]) for b in loader)
    assert n > 0


# -- the mock store's knobs -------------------------------------------------


@pytest.mark.parametrize("part, latency", [
    ("100", "5"), ("1", "0"), (None, None), ("0", "-2"), ("x", "y"),
    ("4096", "0.5")])
def test_mock_knobs_parse_as_reference(monkeypatch, part, latency):
    for key, value in (("LDDL_TPU_MOCK_PART_BYTES", part),
                       ("LDDL_TPU_MOCK_LATENCY_MS", latency)):
        if value is not None:
            monkeypatch.setenv(key, value)
    got, want = tbackend.MockObjectStore(), rbackend.MockObjectStore()
    assert got._part_bytes == want._part_bytes
    assert got._latency_s == want._latency_s


def _store_trace(backend_mod, root):
    """Every store op once on a fresh mock store, ``time.sleep``
    recorded: (sleeps of each op, parts of a 1001-byte upload)."""
    slept = []
    real_sleep = time.sleep
    time.sleep = slept.append
    try:
        per_op = _store_ops(backend_mod, root, slept)
    finally:
        time.sleep = real_sleep
    store = backend_mod.MockObjectStore()
    path = os.path.join(root, "obj.bin")
    src = os.path.join(root, "src.bin")
    with open(src, "wb") as f:
        f.write(b"y" * 1001)
    store.put_file(src, path)
    odir = store._obj_dir(path)
    parts = store._read_meta(odir, store._current_gen(odir))["parts"]
    return per_op, len(parts)


def _store_ops(backend_mod, root, slept):
    store = backend_mod.MockObjectStore()
    path = os.path.join(root, "obj.bin")
    per_op = {}
    ops = [("put", lambda: store.put_atomic(path, b"x" * 1000)),
           ("head", lambda: store.head(path)),
           ("get", lambda: store.get(path)),
           ("range_get", lambda: store.get(path, start=10, length=20)),
           ("get_versioned", lambda: store.get_versioned(path)),
           ("list", lambda: store.list(root)),
           ("delete", lambda: store.delete(path))]
    for name, op in ops:
        n = len(slept)
        op()
        per_op[name] = slept[n:]
    return per_op


def test_mock_latency_and_parts_match_reference(tmp_path, monkeypatch):
    for key, value in (("LDDL_TPU_MOCK_PART_BYTES", "100"),
                       ("LDDL_TPU_MOCK_LATENCY_MS", "7")):
        monkeypatch.setenv(key, value)
    os.makedirs(tmp_path / "t")
    os.makedirs(tmp_path / "r")
    got = _store_trace(tbackend, str(tmp_path / "t"))
    want = _store_trace(rbackend, str(tmp_path / "r"))
    assert got == want
    per_op, parts = got
    assert parts == 11
    assert per_op["head"] == []
    for name in ("put", "get", "range_get", "get_versioned", "list",
                 "delete"):
        assert per_op[name] == [0.007], (name, per_op)


# -- LDDL_TPU_PIN_CORES ----------------------------------------------------


def _pins(runner_mod, root, monkeypatch, n, cores, threads, fail=False):
    """``_pin_worker_core`` called ``n`` times (as ``n`` pool workers) on
    a fake affinity set: the affinity each was given."""
    pinned = []

    def setaffinity(pid, mask):
        if fail:
            raise OSError("EPERM")
        pinned.append(sorted(mask))

    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: set(cores))
    monkeypatch.setattr(os, "sched_setaffinity", setaffinity)
    monkeypatch.setenv("LDDL_TPU_NATIVE_THREADS", str(threads))
    for _ in range(n):
        runner_mod._pin_worker_core({"out_dir": root})
    return pinned


@pytest.mark.parametrize("cores, threads", [
    (range(8), 2), (range(8), 3), ([0, 2, 4, 6, 9, 11], 4), (range(2), 1),
    (range(1), 1), (range(16), 64)])
def test_pin_slots_match_reference(tmp_path, monkeypatch, cores, threads):
    monkeypatch.setenv("LDDL_TPU_PIN_CORES", "1")
    os.makedirs(tmp_path / "t")
    os.makedirs(tmp_path / "r")
    got = _pins(trunner, str(tmp_path / "t"), monkeypatch, 5, cores,
                threads)
    want = _pins(rrunner, str(tmp_path / "r"), monkeypatch, 5, cores,
                 threads)
    assert got == want
    if len(cores) >= 2:
        assert len(got) == 5


def test_pinning_is_off_by_default_and_best_effort(tmp_path, monkeypatch):
    assert _pins(trunner, str(tmp_path), monkeypatch, 2, range(8), 2) == []
    monkeypatch.setenv("LDDL_TPU_PIN_CORES", "1")
    assert _pins(trunner, str(tmp_path), monkeypatch, 2, range(8), 2,
                 fail=True) == []
    assert _pins(trunner, str(tmp_path / "missing"), monkeypatch, 1,
                 range(8), 2) == []
    # _pool_init pins: the first worker takes the first slot.
    pinned = []
    monkeypatch.setattr(os, "sched_setaffinity",
                        lambda pid, mask: pinned.append(sorted(mask)))
    os.makedirs(tmp_path / "pool")
    trunner._pool_init(object(), {"out_dir": str(tmp_path / "pool")})
    assert pinned == [[0, 1]]


# -- LDDL_TPU_NATIVE_MARCH -------------------------------------------------


@pytest.mark.parametrize("march", [None, "native", "x86-64-v2",
                                   "x86-64-v3"])
@pytest.mark.parametrize("modes", [(), ("ubsan",)])
def test_march_flags_match_reference(monkeypatch, march, modes):
    monkeypatch.delenv("LDDL_TPU_NATIVE_SANITIZE", raising=False)
    if march is not None:
        monkeypatch.setenv("LDDL_TPU_NATIVE_MARCH", march)
    flags = tbuild.compile_flags(modes)
    assert flags == rbuild.compile_flags(modes)
    assert "-march={}".format(march or "native") in flags


def test_march_builds_its_own_library(monkeypatch, tmp_path):
    """Another -march is another library beside the normal one, and its
    flag reaches g++."""
    monkeypatch.delenv("LDDL_TPU_NATIVE_SANITIZE", raising=False)
    normal = tbuild.lib_path()
    monkeypatch.setenv("LDDL_TPU_NATIVE_MARCH", "x86-64-v2")
    pinned = tbuild.lib_path()
    assert pinned != normal
    assert os.path.dirname(pinned) == os.path.dirname(normal)
    assert os.path.basename(pinned).startswith("lddl_native-")
    monkeypatch.setenv("LDDL_TPU_NATIVE_MARCH", "native")
    assert tbuild.lib_path() == normal

    monkeypatch.setenv("LDDL_TPU_NATIVE_MARCH", "x86-64-v2")
    monkeypatch.setattr(tbuild, "BUILD_DIR", str(tmp_path))
    calls = []

    class Done:
        returncode = 0
        stderr = ""

    def fake_run(cmd, **kw):
        calls.append(cmd)
        with open(cmd[cmd.index("-o") + 1], "wb") as f:
            f.write(b"lib")
        return Done()

    monkeypatch.setattr(tbuild.subprocess, "run", fake_run)
    path = tbuild.ensure_built()
    assert path == tbuild.lib_path() and os.path.exists(path)
    assert calls and "-march=x86-64-v2" in calls[0]
    assert "-march=native" not in calls[0]
