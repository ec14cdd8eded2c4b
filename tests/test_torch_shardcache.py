"""The port's loader shard I/O (lddl_tpu_torch.loader.shardcache) and
storage backend: the generation-keyed shard cache never serves a stale
generation, eviction keeps the budget under concurrent gets, read-ahead on
or off (and the local or the mock object store) deliver the same tables in
the same order, a torn read surfaces through the threads, an early exit
leaks no thread; and at the loader level, thread and process workers give
lddl_tpu's batches with the pipeline on and off."""

import hashlib
import os
import sys
import threading

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import _torch_loader_shards as shards  # noqa: E402

from lddl_tpu_torch import observability as obs  # noqa: E402
from lddl_tpu_torch.loader import shardcache  # noqa: E402
from lddl_tpu_torch.resilience import backend as storage  # noqa: E402
from lddl_tpu_torch.resilience import faults  # noqa: E402
from lddl_tpu_torch.resilience import io as rio  # noqa: E402
from lddl_tpu_torch.utils.types import File  # noqa: E402


@pytest.fixture(autouse=True)
def _always_disarm():
    faults.disarm()
    yield
    faults.disarm()


@pytest.fixture
def mock_bk(monkeypatch):
    monkeypatch.setenv(storage.ENV_VAR, "mock")
    return storage.get_backend()


def _metrics(monkeypatch, tmp_path):
    monkeypatch.setenv("LDDL_TPU_METRICS_DIR", str(tmp_path / "metrics"))
    obs.registry().reset()
    return obs.registry()


def _parquet_bytes(values):
    import pyarrow as pa
    import pyarrow.parquet as pq
    sink = pa.BufferOutputStream()
    pq.write_table(pa.table({"A": [str(v) for v in values]}), sink)
    return sink.getvalue().to_pybytes()


def _write_shards(root, n_shards, rows=8):
    import pyarrow as pa
    import pyarrow.parquet as pq
    files = []
    for i in range(n_shards):
        p = os.path.join(str(root), "shard-{}.parquet".format(i))
        pq.write_table(pa.table({"A": ["s{}r{}".format(i, r)
                                       for r in range(rows)]}), p)
        files.append(File(p, rows))
    return files


def _column(table):
    return table.column("A").to_pylist()


def _pipeline_env(monkeypatch, depth, cache_bytes):
    monkeypatch.setenv("LDDL_TPU_LOADER_PREFETCH_SHARDS", str(depth))
    monkeypatch.setenv("LDDL_TPU_LOADER_CACHE_BYTES", str(cache_bytes))


def _tables_digest(files):
    h = hashlib.sha256()
    order = []
    for f, table in shardcache.shard_tables(files):
        order.append(f.path)
        h.update(repr(_column(table)).encode())
    return order, h.hexdigest()


def test_cache_generation_advance_never_serves_stale(mock_bk, tmp_path,
                                                     monkeypatch):
    reg = _metrics(monkeypatch, tmp_path)
    p = str(tmp_path / "obj.parquet")
    v1 = _parquet_bytes(["old-1", "old-2"])
    v2 = _parquet_bytes(["new-1", "new-2", "new-3"])
    mock_bk.put_atomic(p, v1)
    cache = shardcache.ShardCache(1 << 20)
    assert cache.get(p) == v1          # miss
    assert cache.get(p) == v1          # hit
    mock_bk.put_atomic(p, v2)          # a new generation
    assert cache.get(p) == v2          # the version probe misses
    assert cache.get(p) == v2
    assert reg.counter("loader_shard_cache_hits_total").value() == 2
    assert reg.counter("loader_shard_cache_misses_total").value() == 2


def test_cache_eviction_respects_budget_under_concurrent_gets(
        tmp_path, monkeypatch):
    monkeypatch.delenv(storage.ENV_VAR, raising=False)
    _metrics(monkeypatch, tmp_path)
    payloads = {}
    for i in range(8):
        p = str(tmp_path / "s{}.parquet".format(i))
        payloads[p] = _parquet_bytes(["x{}y{}".format(i, r)
                                      for r in range(20)])
        with open(p, "wb") as f:
            f.write(payloads[p])
    one = len(next(iter(payloads.values())))
    budget = int(one * 3.5)            # room for 3 shards, never 4
    cache = shardcache.ShardCache(budget)
    errors = []

    def worker(order):
        try:
            for p in order:
                assert cache.get(p) == payloads[p]
                assert cache.cached_bytes() <= budget
        except BaseException as e:  # noqa: BLE001 - surfaced below
            errors.append(e)

    paths = sorted(payloads)
    threads = [threading.Thread(target=worker, args=(paths[k:] + paths[:k],))
               for k in range(4)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    assert cache.cached_bytes() <= budget and len(cache) <= 3
    assert obs.registry().counter(
        "loader_shard_cache_evictions_total").value() > 0
    small = shardcache.ShardCache(10)   # over budget: served, not cached
    assert small.get(paths[0]) == payloads[paths[0]]
    assert small.cached_bytes() == 0


@pytest.mark.parametrize("backend", ["local", "mock"])
@pytest.mark.parametrize("depth,cache_bytes", [(0, 0), (0, 1 << 20),
                                               (3, 0), (3, 1 << 20)])
def test_shard_tables_identity(tmp_path, monkeypatch, backend, depth,
                               cache_bytes):
    """Depth and budget are scheduling knobs: the same tables in the same
    order as the plain synchronous read, cold and warm."""
    files = _write_shards(tmp_path, 6)
    monkeypatch.delenv(storage.ENV_VAR, raising=False)
    _pipeline_env(monkeypatch, 0, 0)
    sync = _tables_digest(files)
    monkeypatch.setenv(storage.ENV_VAR, backend)
    _pipeline_env(monkeypatch, depth, cache_bytes)
    assert _tables_digest(files) == sync
    assert _tables_digest(files) == sync


def test_shard_tables_generation_pickup_through_cache(mock_bk, tmp_path,
                                                      monkeypatch):
    p = str(tmp_path / "gen.parquet")
    mock_bk.put_atomic(p, _parquet_bytes(["gen1-a", "gen1-b"]))
    _pipeline_env(monkeypatch, 2, 3 << 20)
    [(_, t1)] = list(shardcache.shard_tables([File(p, 2)]))
    assert _column(t1) == ["gen1-a", "gen1-b"]
    mock_bk.put_atomic(p, _parquet_bytes(["gen2-a"]))
    [(_, t2)] = list(shardcache.shard_tables([File(p, 1)]))
    assert _column(t2) == ["gen2-a"]


def test_sync_killswitch_is_plain_read_table(tmp_path, monkeypatch):
    monkeypatch.delenv(storage.ENV_VAR, raising=False)
    _pipeline_env(monkeypatch, 0, 0)
    files = _write_shards(tmp_path, 2)
    calls = []
    real = rio.read_table

    def recording(path, *a, **kw):
        calls.append(path)
        return real(path, *a, **kw)

    monkeypatch.setattr(rio, "read_table", recording)
    before = set(threading.enumerate())
    out = list(shardcache.shard_tables(files))
    assert calls == [f.path for f in files]
    assert set(threading.enumerate()) - before == set()
    assert [_column(t) for _, t in out] == [
        ["s0r{}".format(r) for r in range(8)],
        ["s1r{}".format(r) for r in range(8)]]


@pytest.mark.parametrize("depth", [0, 2])
def test_truncate_fault_surfaces_through_pipeline(tmp_path, monkeypatch,
                                                  depth):
    monkeypatch.delenv(storage.ENV_VAR, raising=False)
    _pipeline_env(monkeypatch, depth, 0)
    files = _write_shards(tmp_path, 3)
    faults.arm("read:truncate:nth=1")
    with pytest.raises(ValueError, match="injected truncated parquet"):
        list(shardcache.shard_tables(files))


def _attempts_to_heal(path, attempts, clauses):
    """The attempt at which the retry layer's read of ``path`` gets
    through (an ``open`` then a ``read`` fault point an attempt, the
    ``read`` only once the ``open`` passed), or None when every one of
    ``attempts`` draws a fault; ``clauses`` maps op -> (seed, p)."""
    calls = {"open": 0, "read": 0}
    for attempt in range(1, attempts + 1):
        for op in ("open", "read"):
            calls[op] += 1
            seed, p = clauses[op]
            if faults.draw(seed, op, path, calls[op]) < p:
                break
        else:
            return attempt
    return None


def test_transient_eio_heals_through_pipeline(tmp_path, monkeypatch):
    """The draws are a function of (seed, op, path, call), so with paths
    relative to a fixed directory the same reads fault in every run; the
    premise (no shard draws a fault in all 5 attempts) is checked before
    the digest."""
    monkeypatch.delenv(storage.ENV_VAR, raising=False)
    monkeypatch.setenv("LDDL_TPU_RETRY_BASE_DELAY_S", "0.001")
    monkeypatch.chdir(tmp_path)
    files = _write_shards(".", 4)
    heal = [_attempts_to_heal(f.path, 5, {"read": (5, 0.3),
                                          "open": (6, 0.2)})
            for f in files]
    assert None not in heal, heal
    assert max(heal) > 1, heal   # some read does fault and heal
    _pipeline_env(monkeypatch, 0, 0)
    clean = _tables_digest(files)
    _pipeline_env(monkeypatch, 2, 0)
    faults.arm("read:eio:p=0.3:seed=5,open:eio:p=0.2:seed=6")
    assert _tables_digest(files) == clean


_DRAW_SPEC = "read:eio:p=0.4:seed=11,open:eio:p=0.25:seed=3"
_DRAW_CALLS = 12   # calls of each op on each of the paths below
_DRAW_PATHS = ("a/shard-0.parquet", "a/shard-1.parquet", "b/shard-0.parquet")


def _faulted_calls(path, calls=_DRAW_CALLS):
    """Which of ``calls`` open and read fault points on ``path`` fault,
    under the armed spec: [(op, n)]."""
    hit = []
    for n in range(1, calls + 1):
        for op in ("open", "read"):
            try:
                faults.fault_point(op, path)
            except OSError:
                hit.append((op, n))
    return hit


def test_fault_draws_ignore_process_and_thread_order():
    """A p= clause's draws are a function of (seed, op, path, call): the
    same faults in this process with the paths taken in turn, in two
    threads that interleave in opposite orders, and in another process."""
    import json
    import subprocess
    faults.arm(_DRAW_SPEC)
    serial = {p: _faulted_calls(p) for p in _DRAW_PATHS}
    assert all(serial.values()) and any(
        len(v) < 2 * _DRAW_CALLS for v in serial.values())
    for order in (_DRAW_PATHS, _DRAW_PATHS[::-1]):
        faults.arm(_DRAW_SPEC)   # resets the call counters
        got, turn = {}, threading.Condition()
        state = {"next": 0}

        def run(path, slot):
            # One call of each op at a time, the threads taking turns in
            # ``order``: every path's calls interleave with the others'.
            hit = []
            for n in range(1, _DRAW_CALLS + 1):
                with turn:
                    turn.wait_for(lambda: state["next"] % len(order) == slot)
                    for op in ("open", "read"):
                        try:
                            faults.fault_point(op, path)
                        except OSError:
                            hit.append((op, n))
                    state["next"] += 1
                    turn.notify_all()
            got[path] = hit

        threads = [threading.Thread(target=run, args=(p, i))
                   for i, p in enumerate(order)]
        for t in threads[::-1]:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert got == serial, order
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); "
            "import test_torch_shardcache as t; "
            "t.faults.arm(t._DRAW_SPEC); "
            "print(json.dumps({p: t._faulted_calls(p) "
            "for p in t._DRAW_PATHS}))")
    here = os.path.dirname(os.path.abspath(__file__))
    out = subprocess.run([sys.executable, "-c", code, here], check=True,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=os.path.dirname(
                             here))).stdout
    other = {p: [tuple(h) for h in v]
             for p, v in json.loads(out.strip().splitlines()[-1]).items()}
    assert other == serial


def test_early_consumer_exit_leaks_no_threads(tmp_path, monkeypatch):
    monkeypatch.delenv(storage.ENV_VAR, raising=False)
    _pipeline_env(monkeypatch, 2, 0)
    files = _write_shards(tmp_path, 6)
    before = set(threading.enumerate())
    gen = shardcache.shard_tables(files)
    next(gen)
    gen.close()   # the shuffle buffer met its quota mid-epoch
    assert set(threading.enumerate()) - before == set()


def test_io_thread_count_and_pool_budget(monkeypatch):
    from lddl_tpu_torch.utils.cpus import (loader_io_threads,
                                           pool_cpu_budget,
                                           usable_cpu_count)
    from lddl_tpu.loader import shardcache as ref
    for depth in (0, 1, 2, 64):
        assert shardcache.io_thread_count(depth) == ref.io_thread_count(
            depth)
    monkeypatch.setenv("LDDL_TPU_LOADER_PREFETCH_SHARDS", "0")
    assert loader_io_threads() == 0
    monkeypatch.setenv("LDDL_TPU_LOADER_PREFETCH_SHARDS", "8")
    assert loader_io_threads() == shardcache.MAX_FETCH_THREADS + 1
    assert pool_cpu_budget(reserve=usable_cpu_count() + 10) == 1


@pytest.fixture(scope="module")
def small_pipeline(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("shardcache_pipeline"))
    corpus, vocab = shards.build_corpus(root, num_docs=40, num_files=2)
    return {"bal": shards.ref_shards(corpus, vocab,
                                     os.path.join(root, "bal"), 4,
                                     masking=True),
            "vocab": vocab}


@pytest.mark.parametrize("worker_mode", ["thread", "process"])
def test_loader_identity_pipeline_on_off(small_pipeline, monkeypatch,
                                         worker_mode):
    """Pipeline off, on, and on over the mock store: lddl_tpu's batches
    (read with its pipeline off) each time."""
    monkeypatch.delenv(storage.ENV_VAR, raising=False)
    kw = dict(vocab_file=small_pipeline["vocab"], batch_size=8,
              num_workers=2)
    _pipeline_env(monkeypatch, 0, 0)
    want = shards.digest(shards.ref_loader(small_pipeline["bal"], **kw))
    assert want[0] > 0
    for backend, depth, budget in (("local", 0, 0), ("local", 4, 4 << 20),
                                   ("mock", 4, 4 << 20)):
        monkeypatch.setenv(storage.ENV_VAR, backend)
        _pipeline_env(monkeypatch, depth, budget)
        port = shards.port_loader(small_pipeline["bal"],
                                  worker_mode=worker_mode, **kw)
        try:
            assert shards.digest(port) == want, (backend, depth, budget)
        finally:
            port.shutdown_workers()
