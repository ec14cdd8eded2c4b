"""The port's elastic work-stealing preprocess (lddl_tpu_torch.preprocess.
steal, resilience.leases and the runner's elastic hooks) against a live
static run of lddl_tpu on the same plan: in every case the port's shards
and ``.manifest.json`` are byte-equal to the reference's single-host
static output (schema v2 and v1), and no scheduling state (``_leases``,
``_done``, ``_shuffle``) is left behind. Covered:

- one and two elastic hosts (threads standing in for hosts: the protocol
  is pure filesystem), both returning the global census;
- a dead host's wreckage (expired leases, a missing scatter record with
  partial appends, a torn shard, temp debris) reclaimed by a joiner;
- a lease stolen mid-unit: the late result is fenced off and the unit
  redone; a failed unit resumed; a mismatched plan and a multi-rank
  communicator refused;
- an empty unit record read as done; a stale retired ledger at finalize;
  a pool worker SIGKILLed mid-unit;
- the adaptive scatter plan (crash with half the records gone, resumed),
  fixed ``scatter_units``, adaptive and fixed refusing each other's
  directory; the legacy coordination pin; the no-global-shuffle mode;
  the mock object store;
- real host processes: three hosts with one SIGKILLed (with its process
  group) while it holds a gather lease, and a host whose renewal stalls
  past its TTL (the ``lease-renew:stall`` fault) so its late publish is
  fenced.

Corpus and vocab come from ``tests/golden_spool.py``'s ``build_corpus`` and
``build_vocab``; its pinned hashes are not used.
"""

import glob
import json
import os
import signal
import subprocess
import sys
import threading
import time

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import golden_spool as gs  # noqa: E402

from lddl_tpu_torch import observability as obs  # noqa: E402
from lddl_tpu_torch.preprocess import steal  # noqa: E402
from lddl_tpu_torch.preprocess.runner import (  # noqa: E402
    BertBucketProcessor, run_sharded_pipeline)
from lddl_tpu_torch.resilience import leases  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_ENV = ("LDDL_TPU_METRICS_DIR", "LDDL_TPU_FLEET_DIR", "LDDL_TPU_FLEET_HOLDER",
        "LDDL_TPU_FLEET_INTERVAL_S", "LDDL_TPU_FLEET_TTL_S",
        "LDDL_TPU_FAULTS", "LDDL_TPU_COORD_LEGACY",
        "LDDL_TPU_STORAGE_BACKEND")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    """Telemetry, fleet spools, faults, the legacy pin and the backend
    off unless a test sets them (a test of another file that ran before
    on this worker may have left any of them set)."""
    for name in _ENV:
        monkeypatch.delenv(name, raising=False)
    from lddl_tpu_torch.resilience import faults
    faults.disarm()
    yield
    faults.disarm()


@pytest.fixture(scope="module")
def fixture_dirs(tmp_path_factory):
    td = tmp_path_factory.mktemp("telastic")
    corpus = gs.build_corpus(str(td / "corpus"))
    vocab = gs.build_vocab(str(td))
    return str(td), corpus, vocab


_RUN_KW = dict(num_blocks=12, sample_ratio=0.9, seed=4242,
               global_shuffle=True, progress_interval=0.0)


def _config(pkg, schema, **kw):
    import importlib
    pre = importlib.import_module(pkg + ".preprocess")
    kw.setdefault("max_seq_length", 32)
    kw.setdefault("masking", True)
    return pre, pre.BertPretrainConfig(schema_version=schema, **kw)


def _ref_processor(vocab, out, schema, bin_size=8, **kw):
    from lddl_tpu.preprocess.runner import BertBucketProcessor as RefProc
    pre, cfg = _config("lddl_tpu", schema, **kw.pop("cfg", {}))
    return RefProc(pre.get_tokenizer(vocab_file=vocab), cfg, 4242, out,
                   bin_size, "parquet", **kw)


def _processor(vocab, out, schema=2, bin_size=8, **kw):
    pre, cfg = _config("lddl_tpu_torch", schema, **kw.pop("cfg", {}))
    return BertBucketProcessor(pre.get_tokenizer(vocab), cfg, 4242, out,
                               bin_size, "parquet", **kw)


def _static_reference(corpus, out, proc, **kw):
    from lddl_tpu.preprocess.runner import \
        run_sharded_pipeline as ref_pipeline
    ref_pipeline({"wikipedia": corpus}, out, proc, **dict(_RUN_KW, **kw))
    return out


@pytest.fixture(scope="module")
def reference(fixture_dirs, tmp_path_factory):
    """{schema: dir} of live static lddl_tpu runs of the plan (binned,
    statically masked), built once."""
    td, corpus, vocab = fixture_dirs
    outs = {}
    for schema in (1, 2):
        out = str(tmp_path_factory.mktemp("ref_v{}".format(schema)) / "out")
        outs[schema] = _static_reference(corpus, out,
                                         _ref_processor(vocab, out, schema))
    return outs


def _tree(out):
    """{name: bytes} of the shards and the manifest of an output dir."""
    names = sorted(os.path.basename(p)
                   for p in glob.glob(os.path.join(out, "part.*")))
    names.append(".manifest.json")
    tree = {}
    for n in names:
        with open(os.path.join(out, n), "rb") as f:
            tree[n] = f.read()
    return tree


def _assert_reference_bytes(out, want):
    got, ref = _tree(out), _tree(want)
    assert sorted(got) == sorted(ref) and len(got) > 1
    assert [n for n in got if got[n] != ref[n]] == []
    left = [d for d in ("_leases", "_done", "_shuffle")
            if os.path.isdir(os.path.join(out, d))]
    assert not left, left
    assert not glob.glob(os.path.join(out, "*.tmp.*"))


def _run_elastic(corpus, out, proc, holder, ttl=5.0, **kw):
    return run_sharded_pipeline({"wikipedia": corpus}, out, proc,
                                elastic=True, lease_ttl=ttl,
                                holder_id=holder, **dict(_RUN_KW, **kw))


class _Wrap:
    """Delegates ``fingerprint``/``prepare`` to a processor; subclasses
    hook ``prepare``. Picklable (spawn pools)."""

    def __init__(self, inner):
        self.inner = inner

    def fingerprint(self):
        return self.inner.fingerprint()

    def prepare(self, texts, bucket):
        return self.inner.prepare(texts, bucket)


class _FailUnless(_Wrap):
    """Fails every bucket while ``flag`` does not exist."""

    def __init__(self, inner, flag):
        super().__init__(inner)
        self.flag = flag

    def prepare(self, texts, bucket):
        if not os.path.exists(self.flag):
            raise RuntimeError("host dies before finishing any bucket")
        return self.inner.prepare(texts, bucket)


# ------------------------------------------------------------ byte identity


@pytest.mark.parametrize("schema", [2, 1], ids=["v2", "v1"])
def test_single_elastic_host_matches_reference(fixture_dirs, reference,
                                               tmp_path, schema):
    td, corpus, vocab = fixture_dirs
    out = str(tmp_path / "out")
    written = _run_elastic(corpus, out, _processor(vocab, out, schema),
                           "solo")
    _assert_reference_bytes(out, reference[schema])
    assert written and sum(written.values()) > 0


@pytest.mark.parametrize("schema", [2, 1], ids=["v2", "v1"])
def test_two_elastic_hosts_split_work(fixture_dirs, reference, tmp_path,
                                      schema):
    """Two concurrent hosts divide the units through leases, write the
    reference's bytes, and both return the same global census."""
    td, corpus, vocab = fixture_dirs
    out = str(tmp_path / "out")
    procs = {h: _processor(vocab, out, schema) for h in ("hostA", "hostB")}
    results, errors, logs = {}, {}, []

    def host(hid, delay):
        time.sleep(delay)
        try:
            results[hid] = _run_elastic(corpus, out, procs[hid], hid,
                                        log=logs.append)
        except Exception as e:  # noqa: BLE001 - surfaced by the assert
            errors[hid] = e

    threads = [threading.Thread(target=host, args=("hostA", 0.0)),
               threading.Thread(target=host, args=("hostB", 0.1))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    _assert_reference_bytes(out, reference[schema])
    assert results["hostA"] == results["hostB"]
    assert sum(1 for line in logs if "elastic summary" in line) == 2


def test_host_whose_listing_sees_the_ledger_dir_appear_joins(
        fixture_dirs, reference, tmp_path, monkeypatch):
    """A host that passed the start guard's wait before another host made
    its ``_done`` dir, and whose dirty-directory listing then sees it,
    joins that run (waiting for its manifest) instead of refusing the
    directory as stale: hosts started together hit that window."""
    td, corpus, vocab = fixture_dirs
    out = str(tmp_path / "out")
    os.makedirs(out)
    results, errors = {}, {}

    def host(hid):
        try:
            results[hid] = _run_elastic(corpus, out, _processor(vocab, out),
                                        hid)
        except Exception as e:  # noqa: BLE001 - surfaced by the assert
            errors[hid] = e

    other = threading.Thread(target=host, args=("hostA",))
    main = threading.current_thread()
    real_listdir = os.listdir

    def listdir(path="."):
        # hostB's first listing of ``out`` (the guard's stale check):
        # start hostA there and return once its ledger dir exists.
        if path == out and threading.current_thread() is main \
                and not other.is_alive() and other.ident is None:
            other.start()
            deadline = time.monotonic() + 60
            while not os.path.isdir(os.path.join(out, "_done")):
                assert time.monotonic() < deadline
                time.sleep(0.005)
        return real_listdir(path)

    monkeypatch.setattr(os, "listdir", listdir)
    host("hostB")
    other.join()
    assert not errors, errors
    _assert_reference_bytes(out, reference[2])
    assert results["hostA"] == results["hostB"]


def test_elastic_on_mock_store(fixture_dirs, reference, tmp_path,
                               monkeypatch):
    """Two hosts on the mock object store (CAS leases, multipart
    publishes) write the reference's bytes."""
    monkeypatch.setenv("LDDL_TPU_STORAGE_BACKEND", "mock")
    td, corpus, vocab = fixture_dirs
    out = str(tmp_path / "out")
    procs = {h: _processor(vocab, out) for h in ("hostA", "hostB")}
    errors = {}

    def host(hid, delay):
        time.sleep(delay)
        try:
            _run_elastic(corpus, out, procs[hid], hid)
        except Exception as e:  # noqa: BLE001
            errors[hid] = e

    threads = [threading.Thread(target=host, args=(h, d))
               for h, d in (("hostA", 0.0), ("hostB", 0.1))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    got, ref = _tree(out), _tree(reference[2])
    assert got == ref
    assert not os.path.isdir(os.path.join(out, "_leases"))


def test_elastic_no_global_shuffle(fixture_dirs, tmp_path):
    """Elastic block mode (no scatter phase): blocks are the units."""
    td, corpus, vocab = fixture_dirs
    static = _static_reference(
        corpus, str(tmp_path / "static"),
        _ref_processor(vocab, str(tmp_path / "static"), 2),
        global_shuffle=False)
    out = str(tmp_path / "out")
    _run_elastic(corpus, out, _processor(vocab, out), "solo",
                 global_shuffle=False)
    _assert_reference_bytes(out, static)


# ------------------------------------------------ reclaim, fence, resume


def test_dead_host_units_are_reclaimed(fixture_dirs, reference, tmp_path):
    """A dead host left expired leases, a missing scatter record with
    partial spool appends, a torn shard and temp debris; a survivor that
    joins the directory steals every unit, sweeps the wreckage and writes
    the reference's bytes."""
    td, corpus, vocab = fixture_dirs
    out = str(tmp_path / "out")
    flag = str(tmp_path / "alive")
    with pytest.raises(RuntimeError, match="re-run with resume"):
        _run_elastic(corpus, out, _FailUnless(_processor(vocab, out), flag),
                     "deadhost", ttl=0.3)
    assert os.path.exists(os.path.join(out, "_done", "manifest.json"))
    root = leases.lease_root(out)
    dead = "deadhost2"
    assert leases.try_acquire(root, "group-2", dead, ttl_s=0.01)
    os.remove(os.path.join(out, "_done", "scatter-p0.json"))
    assert leases.try_acquire(root, "scatter-p0", dead, ttl_s=0.01)
    gdir = os.path.join(out, "_shuffle", "group-2")
    os.makedirs(gdir, exist_ok=True)
    with open(os.path.join(gdir, steal.spool_name("p0", 0, dead)), "w") as f:
        f.write("#B 0 2\n torn partial append from a dead host\n")
    with open(os.path.join(out, "part.2.parquet_1"), "wb") as f:
        f.write(b"torn parquet bytes")
    with open(os.path.join(out, "part.2.parquet_1.tmp.999"), "wb") as f:
        f.write(b"tmp debris")
    time.sleep(0.05)  # both planted leases have expired
    with open(flag, "w") as f:
        f.write("alive\n")
    _run_elastic(corpus, out, _FailUnless(_processor(vocab, out), flag),
                 "survivor")
    _assert_reference_bytes(out, reference[2])


class _StealOnce(_Wrap):
    """Overwrites its unit's lease at a bumped epoch with an expired
    deadline the first time it prepares a bucket, as a thief would after
    the TTL: the holder's publish is fenced and the unit redone."""

    def __init__(self, inner, root, ngroups, state):
        super().__init__(inner)
        self.root, self.ngroups, self.state = root, ngroups, state

    def prepare(self, texts, bucket):
        self.state["calls"] += 1
        if not self.state["stolen"]:
            self.state["stolen"] = True
            unit = "group-{}".format(bucket % self.ngroups)
            cur = leases.read_lease(self.root, unit)
            assert cur is not None
            leases._publish(leases.lease_path(self.root, unit),
                            leases._record(unit, "thief", cur["epoch"] + 1,
                                           0.0), "thief")
        return self.inner.prepare(texts, bucket)


def test_fence_rejects_stolen_unit_and_unit_is_redone(fixture_dirs,
                                                      reference, tmp_path,
                                                      monkeypatch):
    td, corpus, vocab = fixture_dirs
    out = str(tmp_path / "out")
    state = {"stolen": False, "calls": 0}
    monkeypatch.setenv("LDDL_TPU_METRICS_DIR", str(tmp_path / "metrics"))
    obs.registry().reset()
    proc = _StealOnce(_processor(vocab, out), leases.lease_root(out), 12,
                      state)
    written = _run_elastic(corpus, out, proc, "victim")
    assert state["stolen"] and state["calls"] >= 13
    _assert_reference_bytes(out, reference[2])
    assert written and sum(written.values()) > 0
    reg = obs.registry()
    assert reg.counter("lease_fence_rejects_total").total() >= 1
    assert reg.counter("lease_steals_total").total() >= 1


class _FailBucket(_Wrap):
    """Fails ``bucket`` while ``flag`` does not exist; appends every
    prepared bucket id to ``log_path``; returns an empty result for
    ``drop`` (a zero-sample unit journals ``{}``)."""

    def __init__(self, inner, bucket, flag, log_path=None, drop=None):
        super().__init__(inner)
        self.bucket, self.flag = bucket, flag
        self.log_path, self.drop = log_path, drop

    def prepare(self, texts, bucket):
        if self.log_path:
            with open(self.log_path, "a") as f:
                f.write("{}\n".format(bucket))
        if bucket == self.bucket and not os.path.exists(self.flag):
            raise RuntimeError("injected failure for bucket {}".format(
                bucket))
        if bucket == self.drop:
            return lambda: {}
        return self.inner.prepare(texts, bucket)


def test_elastic_failed_unit_resume(fixture_dirs, reference, tmp_path):
    """A unit failing on every host fails the run with the resume
    message, its record absent; a later elastic resume completes with
    the reference's bytes."""
    td, corpus, vocab = fixture_dirs
    out = str(tmp_path / "out")
    flag = str(tmp_path / "fixed")
    proc = _FailBucket(_processor(vocab, out), 3, flag)
    with pytest.raises(RuntimeError, match="re-run with resume"):
        _run_elastic(corpus, out, proc, "hostA", ttl=0.5)
    done = os.listdir(os.path.join(out, "_done"))
    assert any(n.startswith("group-") for n in done)
    assert "group-3.json" not in done
    with open(flag, "w") as f:
        f.write("ok\n")
    _run_elastic(corpus, out, proc, "hostA", resume=True)
    _assert_reference_bytes(out, reference[2])


def test_empty_unit_record_reads_as_done(fixture_dirs, tmp_path):
    """A unit whose buckets produce no sample journals ``{}``, which
    reads as DONE: a resume does not redo it, and the bytes equal a
    static reference run that drops the same bucket."""
    from lddl_tpu.preprocess.runner import run_sharded_pipeline as ref_run
    td, corpus, vocab = fixture_dirs
    static = str(tmp_path / "static")

    class RefDrop:
        def __init__(self, inner):
            self.inner = inner

        def fingerprint(self):
            return self.inner.fingerprint()

        def prepare(self, texts, bucket):
            if bucket == 5:
                return lambda: {}
            return self.inner.prepare(texts, bucket)

    ref_run({"wikipedia": corpus}, static,
            RefDrop(_ref_processor(vocab, static, 2)), **_RUN_KW)
    out = str(tmp_path / "out")
    flag = str(tmp_path / "fixed")
    run1, again = str(tmp_path / "run1.log"), str(tmp_path / "again.log")
    with pytest.raises(RuntimeError, match="re-run with resume"):
        _run_elastic(corpus, out, _FailBucket(_processor(vocab, out), 7,
                                              flag, run1, drop=5),
                     "hostA", ttl=0.5)
    assert os.path.exists(os.path.join(out, "_done", "group-5.json"))
    with open(flag, "w") as f:
        f.write("ok\n")
    _run_elastic(corpus, out, _FailBucket(_processor(vocab, out), 7, flag,
                                          again, drop=5),
                 "hostA", resume=True)
    with open(again) as f:
        redone = {int(x) for x in f.read().split()}
    assert 5 not in redone and 7 in redone
    _assert_reference_bytes(out, static)


def test_elastic_refuses_mismatched_plan_and_multirank(fixture_dirs,
                                                       tmp_path):
    """A host joining with another plan refuses as a mismatched resume
    does; elastic and static layouts refuse each other's directory; an
    elastic run refuses a multi-rank communicator."""
    from lddl_tpu_torch.parallel import ThreadGroupCommunicator
    td, corpus, vocab = fixture_dirs
    out = str(tmp_path / "out")
    proc = _processor(vocab, out)
    flag = str(tmp_path / "never")
    with pytest.raises(RuntimeError, match="re-run with resume"):
        _run_elastic(corpus, out, _FailUnless(proc, flag), "hostA", ttl=0.5)
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        _run_elastic(corpus, out, proc, "hostB", num_blocks=24)
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        run_sharded_pipeline({"wikipedia": corpus}, out, proc, resume=True,
                             **_RUN_KW)
    shared = ThreadGroupCommunicator._Shared(2)
    comm = ThreadGroupCommunicator(0, 2, shared)
    with pytest.raises(ValueError, match="elastic"):
        run_sharded_pipeline({"wikipedia": corpus}, str(tmp_path / "o2"),
                             proc, elastic=True, comm=comm, **_RUN_KW)


def test_finalize_with_stale_retired_ledger_dir(fixture_dirs, reference,
                                                tmp_path):
    """A finalizer that died between its ledger rename and rmtree left
    ``_done.retired.<holder>``; a later run with the same holder still
    retires the live ledger."""
    td, corpus, vocab = fixture_dirs
    out = str(tmp_path / "out")
    stale = os.path.join(out, "_done.retired.hostA")
    os.makedirs(stale)
    with open(os.path.join(stale, "group-0.json"), "w") as f:
        f.write("{}")
    _run_elastic(corpus, out, _processor(vocab, out), "hostA")
    _assert_reference_bytes(out, reference[2])
    assert not any(n.startswith("_done.retired") for n in os.listdir(out))


class _KillWorkerOnce(_Wrap):
    """SIGKILLs its own pool worker for one bucket on the first attempt
    (the flag file marks the kill as spent)."""

    def __init__(self, inner, bucket, flag):
        super().__init__(inner)
        self.bucket, self.flag = bucket, flag

    def prepare(self, texts, bucket):
        if bucket == self.bucket and not os.path.exists(self.flag):
            with open(self.flag, "w") as f:
                f.write("killed\n")
            os.kill(os.getpid(), signal.SIGKILL)
        return self.inner.prepare(texts, bucket)


def test_elastic_pool_worker_death_is_reclaimed(fixture_dirs, reference,
                                                tmp_path):
    """A claim loop over a spawn pool of 2 with a worker SIGKILLed
    mid-unit: in-flight leases released, the pool rebuilt, the unit
    redone, the reference's bytes."""
    td, corpus, vocab = fixture_dirs
    out = str(tmp_path / "out")
    flag = str(tmp_path / "killed")
    logs = []
    _run_elastic(corpus, out, _KillWorkerOnce(_processor(vocab, out), 5,
                                              flag),
                 "poolhost", num_workers=2, log=logs.append)
    assert os.path.exists(flag)
    assert any("pool worker died" in line for line in logs)
    _assert_reference_bytes(out, reference[2])


# ----------------------------------------------- scatter plans, legacy pin


def test_adaptive_plan_crash_resume(fixture_dirs, reference, tmp_path):
    """The journaled adaptive plan survives a crash that lost a probe
    record and a main record; the resume re-adopts the SAME plan, redoes
    the two units and writes the reference's bytes."""
    td, corpus, vocab = fixture_dirs
    out = str(tmp_path / "out")
    flag = str(tmp_path / "alive")
    with pytest.raises(RuntimeError, match="re-run with resume"):
        _run_elastic(corpus, out, _FailUnless(_processor(vocab, out), flag),
                     "deadhost", ttl=0.3)
    plan_path = os.path.join(out, "_done", "scatter-plan.json")
    with open(plan_path) as f:
        plan = json.load(f)
    assert plan["main"] and all(len(r) == 2 for r in plan["main"])
    done = set(os.listdir(os.path.join(out, "_done")))
    assert {"scatter-p0.json", "scatter-0.json"} <= done
    os.remove(os.path.join(out, "_done", "scatter-p0.json"))
    os.remove(os.path.join(out, "_done", "scatter-0.json"))
    with open(flag, "w") as f:
        f.write("alive\n")
    logs = []
    _run_elastic(corpus, out, _FailUnless(_processor(vocab, out), flag),
                 "survivor", log=logs.append)
    assert not any("adaptive plan journaled" in line for line in logs)
    _assert_reference_bytes(out, reference[2])


def test_adaptive_and_fixed_modes_refuse_cross_resume(fixture_dirs,
                                                      tmp_path):
    td, corpus, vocab = fixture_dirs
    flag = str(tmp_path / "never")
    for first, second, name in (({}, {"scatter_units": 4}, "out"),
                                ({"scatter_units": 4}, {}, "out2")):
        out = str(tmp_path / name)
        proc = _processor(vocab, out)
        with pytest.raises(RuntimeError, match="re-run with resume"):
            _run_elastic(corpus, out, _FailUnless(proc, flag), "hostA",
                         ttl=0.5, **first)
        with pytest.raises(ValueError, match="fingerprint mismatch"):
            _run_elastic(corpus, out, proc, "hostB", **second)


@pytest.mark.parametrize("schema", [2, 1], ids=["v2", "v1"])
def test_fixed_scatter_units_match_reference(fixture_dirs, reference,
                                             tmp_path, schema):
    td, corpus, vocab = fixture_dirs
    out = str(tmp_path / "out")
    _run_elastic(corpus, out, _processor(vocab, out, schema), "fixedhost",
                 scatter_units=4)
    _assert_reference_bytes(out, reference[schema])


def test_legacy_coordination_byte_identity(fixture_dirs, reference,
                                           tmp_path, monkeypatch):
    """LDDL_TPU_COORD_LEGACY=1 (per-lease renewals, unsnapshotted claim
    scans, barrier gather) writes the reference's bytes, binned v2 and
    packed v2, as the batched default does."""
    td, corpus, vocab = fixture_dirs
    monkeypatch.setenv("LDDL_TPU_COORD_LEGACY", "1")
    out = str(tmp_path / "legacy")
    _run_elastic(corpus, out, _processor(vocab, out), "legacyhost",
                 scatter_units=4)
    _assert_reference_bytes(out, reference[2])
    packed = dict(bin_size=None, pack_seq_length=64, pack_max_per_row=4,
                  cfg={"masking": False})
    static = str(tmp_path / "static_packed")
    _static_reference(corpus, static, _ref_processor(vocab, static, 2,
                                                     **dict(packed)))
    legacy_packed = str(tmp_path / "legacy_packed")
    _run_elastic(corpus, legacy_packed,
                 _processor(vocab, legacy_packed, **dict(packed)),
                 "legacyhost", scatter_units=4)
    _assert_reference_bytes(legacy_packed, static)
    monkeypatch.delenv("LDDL_TPU_COORD_LEGACY")
    new_packed = str(tmp_path / "new_packed")
    _run_elastic(corpus, new_packed,
                 _processor(vocab, new_packed, **dict(packed)), "newhost")
    _assert_reference_bytes(new_packed, static)


# ------------------------------------------------------ real host processes

# One elastic host process: serial (num_workers=1), the port's BERT
# preprocess at the fixtures' plan. argv: corpus vocab out holder ttl.
_HOST = """
import sys
from lddl_tpu_torch.preprocess import (BertPretrainConfig, get_tokenizer,
                                       run_bert_preprocess)
corpus, vocab, out, holder, ttl = sys.argv[1:6]
run_bert_preprocess(
    {"wikipedia": corpus}, out, get_tokenizer(vocab),
    config=BertPretrainConfig(max_seq_length=32, masking=True),
    num_blocks=12, sample_ratio=0.9, seed=4242, bin_size=8,
    global_shuffle=True, elastic=True, lease_ttl=float(ttl),
    holder_id=holder, log=print, progress_interval=0.0)
"""


def _spawn_host(corpus, vocab, out, holder, ttl, faults=None,
                metrics=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    for name in _ENV:
        env.pop(name, None)
    if faults:
        env["LDDL_TPU_FAULTS"] = faults
    if metrics:
        env["LDDL_TPU_METRICS_DIR"] = metrics
    return subprocess.Popen(
        [sys.executable, "-c", _HOST, corpus, vocab, out, holder, str(ttl)],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, start_new_session=True)


def _counter(metrics, name):
    """A counter summed over the processes that exported into
    ``metrics`` (the last snapshot of each)."""
    total = 0
    for path in sorted(glob.glob(os.path.join(metrics, "metrics-*.jsonl"))):
        with open(path) as f:
            lines = [ln for ln in f.read().splitlines() if ln.strip()]
        snap = json.loads(lines[-1])["metrics"].get(name) if lines else None
        if snap:
            total += sum(snap["values"].values())
    return total


def _held_gather_units(out, holder):
    names = []
    for path in glob.glob(os.path.join(out, "_leases", "group-*.json")):
        rec = leases.read_lease(os.path.dirname(path),
                                os.path.basename(path)[:-len(".json")])
        if rec and rec.get("holder") == holder:
            names.append(os.path.basename(path))
    return names


def test_three_host_processes_one_sigkilled(fixture_dirs, reference,
                                            tmp_path):
    """Three host processes on one directory; h0's first deferred publish
    stalls (``sink-write:stall``) while it holds a gather lease, and its
    whole process group is SIGKILLed there. The two survivors steal its
    unit after the 1.5 s TTL, exit 0, and the shards and manifest are the
    reference's."""
    td, corpus, vocab = fixture_dirs
    out = str(tmp_path / "out")
    metrics = str(tmp_path / "metrics")
    t0 = time.monotonic()
    h0 = _spawn_host(corpus, vocab, out, "h0", 1.5,
                     faults="sink-write:stall:nth=1:delay=120")
    survivors = {}
    try:
        deadline = time.monotonic() + 60
        while not _held_gather_units(out, "h0"):
            assert h0.poll() is None, h0.communicate()[0]
            assert time.monotonic() < deadline, "h0 never held a gather unit"
            time.sleep(0.05)
        survivors = {h: _spawn_host(corpus, vocab, out, h, 1.5,
                                    metrics=metrics) for h in ("h1", "h2")}
        os.killpg(h0.pid, signal.SIGKILL)
        h0.communicate()
        assert h0.returncode == -signal.SIGKILL
        outs = {h: p.communicate(timeout=120)[0]
                for h, p in survivors.items()}
    finally:
        for p in [h0] + list(survivors.values()):
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.communicate()
    for h, p in survivors.items():
        assert p.returncode == 0, outs[h]
    _assert_reference_bytes(out, reference[2])
    assert _counter(metrics, "lease_steals_total") >= 1
    assert time.monotonic() - t0 < 60


def test_stalled_renewal_is_fenced_across_processes(fixture_dirs, reference,
                                                    tmp_path):
    """h0's first lease renewal stalls far past its 1.5 s TTL while one
    of its spool appends is slowed by 15 s (time enough for h1 to start
    on a loaded machine), so its unit outlives the lease: h1 steals and
    redoes it, and h0's late publish is fenced (counted, never
    journaled); both exit 0 with the reference's bytes."""
    td, corpus, vocab = fixture_dirs
    out = str(tmp_path / "out")
    mdirs = {h: str(tmp_path / ("m_" + h)) for h in ("h0", "h1")}
    procs = {
        "h0": _spawn_host(corpus, vocab, out, "h0", 1.5,
                          faults=("lease-renew:stall:nth=1:delay=30,"
                                  "open:slow:nth=2:path=_shuffle:delay=15"),
                          metrics=mdirs["h0"]),
        "h1": _spawn_host(corpus, vocab, out, "h1", 1.5,
                          metrics=mdirs["h1"]),
    }
    try:
        outs = {h: p.communicate(timeout=120)[0] for h, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.communicate()
    for h, p in procs.items():
        assert p.returncode == 0, outs[h]
    _assert_reference_bytes(out, reference[2])
    assert _counter(mdirs["h0"], "lease_fence_rejects_total") >= 1
    assert _counter(mdirs["h1"], "lease_steals_total") >= 1
    done = sum(_counter(m, "elastic_units_completed_total")
               for m in mdirs.values())
    assert done == 24, done


def test_bert_cli_elastic_hosts_match_reference(fixture_dirs, reference,
                                                tmp_path):
    """Two ``preprocess_bert_pretrain --elastic`` processes on one sink
    write the reference's static bytes; ``--elastic`` with
    ``--multihost`` is refused."""
    from lddl_tpu_torch.cli import preprocess_bert_pretrain as cli
    td, corpus, vocab = fixture_dirs
    out = str(tmp_path / "out")
    argv = ["--wikipedia", corpus, "--sink", out, "--vocab-file", vocab,
            "--target-seq-length", "32", "--bin-size", "8", "--masking",
            "--num-blocks", "12", "--sample-ratio", "0.9", "--seed", "4242",
            "--local-workers", "1", "--elastic", "--lease-ttl", "5"]
    with pytest.raises(SystemExit, match="mutually exclusive"):
        cli.main(cli.attach_args().parse_args(argv + ["--multihost"]))
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    for name in _ENV:
        env.pop(name, None)
    procs = {h: subprocess.Popen(
        [sys.executable, "-m", "lddl_tpu_torch.cli.preprocess_bert_pretrain"]
        + argv + ["--elastic-host-id", h], env=env, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True) for h in ("hA", "hB")}
    try:
        outs = {h: p.communicate(timeout=300)[0] for h, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.communicate()
    for h, p in procs.items():
        assert p.returncode == 0, outs[h]
        assert "elastic summary: holder={}".format(h) in outs[h]
    _assert_reference_bytes(out, reference[2])
