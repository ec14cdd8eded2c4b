"""The port's loader runtime (lddl_tpu_torch.loader) against lddl_tpu's, on
shards built live in the test: schema-v1 shards written by the port's own
preprocess CLI; process workers (spawned, persistent, supervised) against
thread workers; a worker killed once and replayed; a worker that dies
twice; generations of a streaming-ingestion directory picked up at the
epoch boundary; ``emit_loss_mask`` and ``tokenizer_name``. Every batch is
compared byte for byte with the reference loader's on the same shards,
seed and epoch. The spawn pools are small (1-2 workers) and every wait has
a timeout.
"""

import os
import shutil
import sys
import warnings

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import _torch_loader_shards as shards  # noqa: E402

from lddl_tpu_torch.loader.dataloader import DataLoader  # noqa: E402
from lddl_tpu_torch.resilience import faults  # noqa: E402


# Telemetry and fleet variables a test of another file that ran before in
# this process may have left set.
_TELEMETRY_ENVS = ("LDDL_TPU_METRICS_DIR", "LDDL_TPU_METRICS_RANK",
                   "LDDL_TPU_FLEET_DIR", "LDDL_TPU_FLEET_HOLDER",
                   "LDDL_TPU_FLEET_TTL_S", "LDDL_TPU_FLEET_INTERVAL_S")


def _scrub_telemetry_env():
    # Plain os.environ.pop, not monkeypatch.delenv: delenv puts a leaked
    # value back at teardown, re-arming telemetry for the tests after.
    for name in _TELEMETRY_ENVS:
        os.environ.pop(name, None)


@pytest.fixture(autouse=True)
def _disarm_and_fast_death(monkeypatch):
    faults.disarm()
    # Telemetry off unless a test arms it.
    _scrub_telemetry_env()
    monkeypatch.setattr(DataLoader, "_POLL_TIMEOUT_S", 0.5)
    yield
    faults.disarm()
    _scrub_telemetry_env()


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """Reference-built balanced shards: 'dyn' unbinned (dynamic masking,
    4 shards) and 'bin' binned by 32 tokens (static masking, 2 shards a
    bin)."""
    root = str(tmp_path_factory.mktemp("runtime"))
    corpus, vocab = shards.build_corpus(root)
    return {
        "vocab": vocab, "corpus": corpus,
        "dyn": shards.ref_shards(corpus, vocab, os.path.join(root, "dyn"),
                                 4),
        "bin": shards.ref_shards(corpus, vocab, os.path.join(root, "bin"),
                                 2, bin_size=32, masking=True),
    }


def _kw(built, **extra):
    kw = dict(vocab_file=built["vocab"], batch_size=4, base_seed=7,
              shuffle_buffer_size=16, shuffle_buffer_warmup_factor=2)
    kw.update(extra)
    return kw


# ------------------------------------------------ schema-v1 shards (repair)


def _port_cli_v1(corpus, vocab, out, binned, masking):
    """Schema-v1 shards from the port's own preprocess CLI, balanced by
    the port's balancer."""
    from lddl_tpu_torch.balance import balance_shards
    from lddl_tpu_torch.cli import preprocess_bert_pretrain as cli
    argv = ["--wikipedia", corpus, "--sink", out + "_pre", "--vocab-file",
            vocab, "--target-seq-length", "64", "--duplicate-factor", "2",
            "--sample-ratio", "1.0", "--seed", "3", "--num-blocks", "4",
            "--schema-version", "1", "--local-workers", "1",
            "--masking" if masking else "--no-masking"]
    if binned:
        argv += ["--bin-size", "32"]
    cli.main(cli.attach_args().parse_args(argv))
    balance_shards(out + "_pre", out, 2)
    return out


@pytest.mark.parametrize("binned", [False, True], ids=["unbinned", "binned"])
@pytest.mark.parametrize("masking", [False, True], ids=["dynamic", "static"])
def test_schema_v1_shards_from_port_cli_byte_equal(built, tmp_path, binned,
                                                   masking):
    import pyarrow.parquet as pq
    path = _port_cli_v1(built["corpus"], built["vocab"],
                        str(tmp_path / "v1"), binned, masking)
    first = sorted(n for n in os.listdir(path) if ".parquet" in n)[0]
    names = pq.read_schema(os.path.join(path, first)).names
    assert "A" in names and "A_ids" not in names   # text-only shards
    assert ("masked_lm_positions" in names) == masking
    for epoch_loader in (dict(), dict(num_workers=2)):
        ref = shards.ref_loader(path, **_kw(built, **epoch_loader))
        port = shards.port_loader(path, **_kw(built, **epoch_loader))
        for epoch in range(2):
            shards.assert_same_batches(port, ref, "epoch {}".format(epoch))


# ----------------------------------------------- process vs thread workers


@pytest.mark.parametrize("kind", ["dyn", "bin"])
def test_process_workers_match_reference(built, kind):
    """worker_mode='process' gives lddl_tpu's batches, in its order, over
    two epochs of one persistent pool."""
    ref = shards.ref_loader(built[kind], **_kw(built, num_workers=2))
    port = shards.port_loader(built[kind], **_kw(
        built, num_workers=2, worker_mode="process"))
    try:
        for epoch in range(2):
            shards.assert_same_batches(port, ref, "epoch {}".format(epoch))
        assert port.attribution_snapshot() is None   # telemetry off
    finally:
        port.shutdown_workers()


def test_process_mode_falls_back_on_single_core(built, monkeypatch):
    monkeypatch.delenv("LDDL_TPU_FORCE_PROCESS_WORKERS", raising=False)
    monkeypatch.setattr(os, "cpu_count", lambda: 1)
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: {0},
                        raising=False)
    with pytest.warns(UserWarning, match="falling back to thread"):
        port = shards.port_loader(built["dyn"], **_kw(
            built, num_workers=2, worker_mode="process"))
    assert port._worker_mode == "thread"
    shards.assert_same_batches(port, shards.ref_loader(
        built["dyn"], **_kw(built, num_workers=2)))
    monkeypatch.setattr(os, "cpu_count", lambda: 8)
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: set(range(8)),
                        raising=False)
    assert DataLoader._check_process_mode(None) == "process"


def test_process_worker_failure_surfaces(built, tmp_path):
    loader = shards.port_loader(built["dyn"], **_kw(
        built, num_workers=1, worker_mode="process"))
    from lddl_tpu_torch.utils.types import File
    loader.dataset._files[0] = File(str(tmp_path / "missing.parquet"),
                                    loader.dataset._files[0].num_samples)
    with pytest.raises(RuntimeError, match="loader worker 0 failed"):
        list(loader)
    assert loader._procs is None   # the failed epoch tore the pool down


def test_process_workers_persist_across_epochs(built):
    l1 = shards.port_loader(built["dyn"], **_kw(
        built, num_workers=2, worker_mode="process"))
    l2 = shards.port_loader(built["dyn"], **_kw(
        built, num_workers=2, worker_mode="process"))
    try:
        e0 = [b["input_ids"] for b in l1]
        pids = [p.pid for p in l1._procs]
        e1 = [b["input_ids"] for b in l1]
        assert [p.pid for p in l1._procs] == pids   # reused
        assert not all(a.shape == b.shape and (a == b).all()
                       for a, b in zip(e0, e1))
        f0 = [b["input_ids"] for b in l2]
        shards.assert_same_batches([{"x": a} for a in f0],
                                   [{"x": a} for a in e0])
        assert l1.queue_batches == len(e0) + len(e1)
        assert l1.queue_bytes > 0
    finally:
        l1.shutdown_workers()
        l2.shutdown_workers()
    assert l1._procs is None


def test_abandoned_iterator_does_not_leak_its_epoch(built):
    loader = shards.port_loader(built["dyn"], **_kw(
        built, num_workers=2, worker_mode="process"))
    try:
        it = iter(loader)
        next(it)                                   # epoch 0, abandoned
        e1 = list(loader)                          # epoch 1, clean
        assert sum(len(b["input_ids"]) for b in e1) == len(loader.dataset)
        del it
        import gc
        gc.collect()
        e2 = list(loader)                          # the pool still works
        assert sum(len(b["input_ids"]) for b in e2) == len(loader.dataset)
    finally:
        loader.shutdown_workers()


def test_process_workers_import_no_torch(built):
    """The spawned workers of a process-mode loader never load torch (or
    JAX): their mapped libraries hold no libtorch."""
    loader = shards.port_loader(built["dyn"], **_kw(
        built, num_workers=2, worker_mode="process"))
    try:
        it = iter(loader)
        next(it)
        for p in loader._procs:
            with open("/proc/{}/maps".format(p.pid)) as f:
                maps = f.read()
            assert "libtorch" not in maps and "jaxlib" not in maps
        it.close()
    finally:
        loader.shutdown_workers()


# ---------------------------------------------------- worker supervision


def test_killed_worker_restarts_once_with_reference_batches(built, tmp_path):
    ref = list(shards.ref_loader(built["dyn"], **_kw(built, num_workers=2)))
    flag = str(tmp_path / "killed.flag")
    faults.arm("worker:kill:nth=2:path=w1:flag={}".format(flag))
    loader = shards.port_loader(built["dyn"], **_kw(
        built, num_workers=2, worker_mode="process"))
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            got = list(loader)
    finally:
        faults.disarm()
        loader.shutdown_workers()
    assert os.path.exists(flag)   # the kill happened
    restarts = [w for w in caught if "worker 1 died" in str(w.message)]
    assert len(restarts) == 1
    shards.assert_same_batches(got, ref)


@pytest.mark.parametrize("max_restarts,match", [
    (1, "died again after a restart"),   # the restarted worker dies too
    (0, "died again after a restart"),   # no restart: the first death
], ids=["die-twice", "sigkill-no-restart"])
def test_dying_worker_raises_named_error(built, monkeypatch, max_restarts,
                                         match):
    """A worker that keeps dying (no once-latch on the kill) raises a
    named error instead of looping, and a SIGKILL never hangs the
    consumer."""
    monkeypatch.setattr(DataLoader, "_MAX_WORKER_RESTARTS", max_restarts)
    faults.arm("worker:kill:nth=1:path=w0")
    loader = shards.port_loader(built["dyn"], **_kw(
        built, num_workers=1, worker_mode="process"))
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with pytest.raises(RuntimeError, match=match):
                list(loader)
    finally:
        faults.disarm()
        loader.shutdown_workers()


# --------------------------------------------------- generation following


@pytest.fixture(scope="module", params=["lddl_tpu", "lddl_tpu_torch"])
def ingest_env(request, tmp_path_factory):
    """An ingest over a growing landing directory (one corpus file a
    round), produced by lddl_tpu's ingest or by the port's own."""
    import importlib
    pre = importlib.import_module(request.param + ".preprocess")
    root = str(tmp_path_factory.mktemp("ingest"))
    corpus, vocab = shards.build_corpus(os.path.join(root, "corpus"),
                                        num_docs=60, num_files=3)
    return {"root": root, "corpus": corpus, "vocab": vocab,
            "producer": importlib.import_module(request.param + ".ingest"),
            "tok": pre.get_tokenizer(vocab_file=vocab),
            "cfg": pre.BertPretrainConfig(max_seq_length=32, masking=False)}


def _ingest_rounds(env, target, rounds):
    ingest_once = env["producer"].ingest_once
    landing = target + "_landing"   # one landing per target: it only grows
    src = os.path.join(landing, "source")
    os.makedirs(src, exist_ok=True)
    for n_files in rounds:
        for i in range(n_files):
            shutil.copy(os.path.join(env["corpus"], "source",
                                     "{}.txt".format(i)),
                        os.path.join(src, "{}.txt".format(i)))
        ingest_once(target, env["tok"], landing=landing, config=env["cfg"],
                    num_shards=4, seed=7, num_blocks=4)


@pytest.mark.parametrize("worker_mode", ["thread", "process"])
def test_generation_picked_up_at_epoch_boundary(ingest_env, tmp_path,
                                                worker_mode):
    root = str(tmp_path / "data")
    _ingest_rounds(ingest_env, root, (1,))
    kw = dict(vocab_file=ingest_env["vocab"], batch_size=8, base_seed=5,
              follow_generations=True)
    ref = shards.ref_loader(root, **kw)
    port = shards.port_loader(root, worker_mode=worker_mode, **kw)
    try:
        n_gen0 = len(port.dataset)
        it_ref, it_port = iter(ref), iter(port)
        e0 = [next(it_port)]
        shards.assert_same_batches(e0, [next(it_ref)])
        # A generation published mid-epoch waits for the boundary.
        _ingest_rounds(ingest_env, root, (2,))
        e0 += list(it_port)
        shards.assert_same_batches(e0[1:], list(it_ref), "epoch 0")
        assert sum(len(b["input_ids"]) for b in e0) == n_gen0
        procs0 = list(port._procs or [])
        e1_port, e1_ref = list(port), list(ref)
        shards.assert_same_batches(e1_port, e1_ref, "epoch 1")
        assert sum(len(b["input_ids"]) for b in e1_port) > n_gen0
        if worker_mode == "process":
            # The pool was respawned with the refreshed dataset.
            assert port._procs and all(p not in procs0 for p in port._procs)
        # A fresh loader started at epoch 1 reproduces the grown epoch.
        fresh = shards.port_loader(root, start_epoch=1, **kw)
        shards.assert_same_batches(list(fresh), e1_ref, "fresh epoch 1")
    finally:
        port.shutdown_workers()


def test_mid_publish_generation_is_gated(ingest_env, tmp_path):
    import json
    from lddl_tpu_torch.utils.fs import get_generation_of_path
    root = str(tmp_path / "data")
    _ingest_rounds(ingest_env, root, (1, 2))
    path = os.path.join(root, ".manifest.json")
    with open(path) as f:
        manifest = json.load(f)
    manifest["__meta__"]["generation"] = 0
    with open(path, "w") as f:
        json.dump(manifest, f)
    kw = dict(vocab_file=ingest_env["vocab"], batch_size=8, base_seed=5,
              follow_generations=True)
    port = shards.port_loader(root, **kw)
    assert all(get_generation_of_path(root, f.path) == 0
               for f in port.dataset._files)
    shards.assert_same_batches(port, shards.ref_loader(root, **kw))


# ----------------------------------------------- loader arguments


@pytest.mark.parametrize("kind", ["dyn", "bin"])
def test_emit_loss_mask_matches_reference(built, kind):
    ref = shards.ref_loader(built[kind], **_kw(built, emit_loss_mask=True))
    port = shards.port_loader(built[kind], **_kw(built, emit_loss_mask=True))
    got = list(port)
    shards.assert_same_batches(got, ref)
    for b in got:
        np.testing.assert_array_equal(b["loss_mask"],
                                      (b["labels"] != -1).astype(np.int32))


def test_tokenizer_name_is_a_local_vocab_directory(built, tmp_path):
    """``tokenizer_name`` names a directory with ``vocab.txt``, as the
    reference's from_pretrained reads it; a name that is no directory is
    refused (the port downloads nothing)."""
    d = tmp_path / "tok"
    d.mkdir()
    shutil.copy(built["vocab"], str(d / "vocab.txt"))
    kw = _kw(built)
    kw.pop("vocab_file")
    ref = shards.ref_loader(built["bin"], tokenizer_name=str(d), **kw)
    port = shards.port_loader(built["bin"], tokenizer_name=str(d), **kw)
    shards.assert_same_batches(port, ref)
    with pytest.raises(ValueError, match="not a local directory"):
        shards.port_loader(built["bin"], tokenizer_name="bert-base-uncased",
                           **kw)


def test_log_dir_writes_the_rank_log(built, tmp_path):
    import pyarrow.parquet as pq
    d = str(tmp_path / "unbalanced")
    os.makedirs(d)
    names = sorted(n for n in os.listdir(built["dyn"]) if ".parquet" in n)
    for n in names:   # drop one row of one shard: counts stay within 1
        t = pq.read_table(os.path.join(built["dyn"], n))
        pq.write_table(t.slice(0, t.num_rows - (n == names[0])),
                       os.path.join(d, n))
    logs = str(tmp_path / "logs")
    shards.port_loader(d, **_kw(built, log_dir=logs))
    text = open(os.path.join(logs, "rank-rank0-worker0.log")).read()
    assert "dropping" in text and "equalize" in text
