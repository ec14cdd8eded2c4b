"""Loader shard I/O: read-ahead fetch, a generation-keyed shard cache and
decode-ahead, over the storage backend.

Counterpart of ``lddl_tpu/loader/shardcache.py``. A worker's shard order
is fixed before its epoch starts (seeded world shuffle, dp-group stride,
worker stride; see ``datasets.ParquetDataset``), so read-ahead is exact,
never speculative:

1. Prefetch: a few fetcher threads walk the worker's shard list up to K
   shards ahead of the consumer, reading shard bytes through
   ``resilience.io.read_shard_bytes``. Fetch indices are claimed from a
   shared counter but delivered strictly in file order, so the batches
   do not depend on thread scheduling; K bounds the shards in flight and
   so the memory.
2. Shard cache: a process-wide read-through LRU over shard bytes keyed
   ``(path, version)`` (the mock store's commit generation, or the
   ``(size, mtime_ns)`` stat pair on POSIX). Every lookup probes the
   live version first (``object_head``), so once a new generation is
   published a stale entry can never be served.
3. Decode-ahead: one thread turns fetched bytes into Arrow tables
   through a queue of depth 1, so the parquet decode of shard N+1
   overlaps the consumption of shard N.

Shards are consumed in the synchronous path's order from the same bytes,
so the sample stream is identical with the pipeline on or off.

Env knobs, resolved once per stream before any thread starts::

    LDDL_TPU_LOADER_PREFETCH_SHARDS  read-ahead depth K (default 4; 0 reads
                                     shards synchronously)
    LDDL_TPU_LOADER_CACHE_BYTES      shard-cache budget in bytes (default
                                     256 MiB; 0 disables the cache)

With both at 0 on the local backend the read is a plain
``resilience.io.read_table`` per shard. Telemetry (inert on batch bytes):
``loader_shard_cache_{hits,misses,evictions}_total``,
``loader_shard_cache_bytes``, ``loader_prefetch_shard_wait_seconds_total``
and the ``shard_fetch``/``shard_read`` attribution stages.
"""

import collections
import os
import queue
import threading
import time

from .. import observability as obs
from ..resilience import io as rio

DEFAULT_PREFETCH_SHARDS = 4
DEFAULT_CACHE_BYTES = 256 << 20
# Concurrent backend fetches per stream: enough to overlap a few round
# trips, few enough that many streams do not swamp the host
# (``utils.cpus.loader_io_threads`` counts them).
MAX_FETCH_THREADS = 4

WAIT_METRIC = "loader_prefetch_shard_wait_seconds_total"


def _env_int(name, default):
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def pipeline_config():
    """(prefetch_depth, cache_budget_bytes) from the environment."""
    depth = max(0, _env_int("LDDL_TPU_LOADER_PREFETCH_SHARDS",
                            DEFAULT_PREFETCH_SHARDS))
    budget = max(0, _env_int("LDDL_TPU_LOADER_CACHE_BYTES",
                             DEFAULT_CACHE_BYTES))
    return depth, budget


def io_thread_count(depth=None):
    """Threads ONE loader stream adds at ``depth`` (default: the env
    knob): the fetchers plus the decode-ahead thread; 0 when the pipeline
    is off."""
    if depth is None:
        depth = pipeline_config()[0]
    if depth <= 0:
        return 0
    return min(depth, MAX_FETCH_THREADS) + 1


class ShardCache:
    """Process-wide read-through LRU over shard bytes, keyed
    ``(path, version)``. ``get`` probes the live version first, so a
    republished object always misses and refetches. Fetches run outside
    the lock; insertion evicts down to the budget, and a shard larger
    than the budget is served but never cached."""

    def __init__(self, budget_bytes):
        self._lock = threading.Lock()
        self._entries = collections.OrderedDict()
        self._bytes = 0
        self._budget = int(budget_bytes)

    @property
    def budget_bytes(self):
        return self._budget

    def cached_bytes(self):
        with self._lock:
            return self._bytes

    def __len__(self):
        with self._lock:
            return len(self._entries)

    def get(self, path):
        """The current version of ``path``'s bytes."""
        _, version = rio.object_head(path)
        key = (path, version)
        with self._lock:
            data = self._entries.get(key)
            if data is not None:
                self._entries.move_to_end(key)
        if data is not None:
            obs.inc("loader_shard_cache_hits_total")
            return data
        data, fetched_version = rio.read_shard_bytes(path)
        self._insert(path, fetched_version, data)
        obs.inc("loader_shard_cache_misses_total")
        return data

    def _insert(self, path, version, data):
        evicted = 0
        with self._lock:
            key = (path, version)
            if key not in self._entries and len(data) <= self._budget:
                self._entries[key] = data
                self._bytes += len(data)
                while self._bytes > self._budget and self._entries:
                    _, old = self._entries.popitem(last=False)
                    self._bytes -= len(old)
                    evicted += 1
            size = self._bytes
        if evicted:
            obs.inc("loader_shard_cache_evictions_total", evicted)
        obs.set_gauge("loader_shard_cache_bytes", size)


# The process-wide cache, shared by every stream of the process and
# rebuilt when the budget knob changes.
_cache = None
_cache_lock = threading.Lock()


def shared_cache(budget_bytes):
    global _cache
    with _cache_lock:
        if _cache is None or _cache.budget_bytes != budget_bytes:
            _cache = ShardCache(budget_bytes)
        return _cache


class _ShardStream:
    """Ordered depth-K shard fetch and decode-ahead for one worker's file
    list: up to MAX_FETCH_THREADS reads at once, handed to the one decode
    thread strictly in file order, which feeds the consumer through a
    queue of depth 1."""

    def __init__(self, files, depth, cache):
        self._files = list(files)
        self._depth = max(1, int(depth))
        self._cache = cache
        self._stop = threading.Event()
        # One permit per fetched-but-undelivered shard: bounds the bytes
        # held to ``depth`` shards.
        self._slots = threading.Semaphore(self._depth)
        self._cond = threading.Condition()
        self._next_index = 0
        self._results = {}
        self._obs_on = obs.enabled()
        if self._obs_on:
            from ..observability import attribution
            self._stage = attribution.stage_counter()
            self._wait_counter = obs.registry().counter(
                WAIT_METRIC, help="consumer seconds blocked waiting for a "
                                  "prefetched shard")
        nthreads = min(self._depth, MAX_FETCH_THREADS,
                       max(1, len(self._files)))
        self._fetchers = [
            threading.Thread(target=self._fetch_loop, daemon=True,
                             name="lddl-shard-fetch-{}".format(i))
            for i in range(nthreads)]
        self._tables = queue.Queue(maxsize=1)
        self._decoder = threading.Thread(target=self._decode_loop,
                                         daemon=True,
                                         name="lddl-shard-decode")

    def _fetch_one(self, path):
        if self._cache is not None:
            return self._cache.get(path)
        return rio.read_shard_bytes(path)[0]

    def _fetch_loop(self):
        pc = time.perf_counter
        while not self._stop.is_set():
            # Bounded acquire: an abandoned stream never parks a thread.
            if not self._slots.acquire(timeout=0.1):
                continue
            with self._cond:
                i = self._next_index
                if i >= len(self._files):
                    self._slots.release()
                    return
                self._next_index += 1
            try:
                t0 = pc()
                out = ("ok", self._fetch_one(self._files[i].path))
                if self._obs_on:
                    self._stage.inc(pc() - t0, stage="shard_fetch")
            except BaseException as e:  # noqa: BLE001 - forwarded below
                out = ("error", e)
            with self._cond:
                self._results[i] = out
                self._cond.notify_all()

    def _take_fetched(self, i):
        """Block for index ``i``, release its slot, re-raise its error."""
        with self._cond:
            while i not in self._results:
                self._cond.wait(timeout=0.1)
                if self._stop.is_set() and i not in self._results:
                    raise RuntimeError("shard pipeline stopped")
            out = self._results.pop(i)
        self._slots.release()
        if out[0] == "error":
            raise out[1]
        return out[1]

    def _put(self, item):
        while not self._stop.is_set():
            try:
                self._tables.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _decode_loop(self):
        import pyarrow as pa
        import pyarrow.parquet as pq
        try:
            for i, f in enumerate(self._files):
                data = self._take_fetched(i)
                table = pq.read_table(pa.BufferReader(data))
                if not self._put(("table", f, table)):
                    return
            self._put(("end", None, None))
        except BaseException as e:  # noqa: BLE001 - forwarded to consumer
            self._put(("error", None, e))

    def __iter__(self):
        # pyarrow.parquet is first imported here, on the consumer's thread,
        # never first on the decode thread: a first import and read there,
        # in a freshly spawned worker process, crashed it (SIGSEGV inside
        # read_table) in about one spawn in ten.
        import pyarrow.parquet  # noqa: F401
        pc = time.perf_counter
        for t in self._fetchers:
            t.start()
        self._decoder.start()
        try:
            while True:
                t0 = pc()
                kind, f, payload = self._tables.get()
                if self._obs_on:
                    # What is left of shard_read once fetch and decode run
                    # ahead: the consumer's blocking wait.
                    dt = pc() - t0
                    self._stage.inc(dt, stage="shard_read")
                    self._wait_counter.inc(dt)
                if kind == "error":
                    raise payload
                if kind == "end":
                    return
                yield f, payload
        finally:
            self._stop.set()
            self._decoder.join(timeout=5)
            for t in self._fetchers:
                t.join(timeout=5)


def _sync_tables(files, cache, logger):
    """The pipeline-off path: a plain ``read_table`` per shard on the
    local backend without a cache, else the versioned backend read."""
    obs_on = obs.enabled()
    pc = time.perf_counter
    if obs_on:
        from ..observability import attribution
        stage = attribution.stage_counter()
    use_backend = cache is not None or rio.backend_if_nonlocal() is not None
    if use_backend:
        import pyarrow as pa
        import pyarrow.parquet as pq
    for f in files:
        if logger is not None:
            logger.to("worker").info("Reading {}".format(f.path))
        t0 = pc()
        if use_backend:
            data = (cache.get(f.path) if cache is not None
                    else rio.read_shard_bytes(f.path)[0])
            table = pq.read_table(pa.BufferReader(data))
        else:
            table = rio.read_table(f.path)
        if obs_on:
            stage.inc(pc() - t0, stage="shard_read")
        yield f, table


def shard_tables(files, logger=None):
    """``(file, pyarrow.Table)`` over ``files`` in order, through the
    shard I/O pipeline: the loader's one way of reading shards
    (``ShuffleBuffer`` consumes it)."""
    depth, budget = pipeline_config()
    cache = shared_cache(budget) if budget > 0 else None
    if depth <= 0 or not files:
        yield from _sync_tables(files, cache, logger)
        return
    stream = iter(_ShardStream(files, depth, cache))
    try:
        for f, table in stream:
            if logger is not None:
                logger.to("worker").info("Reading {}".format(f.path))
            yield f, table
    finally:
        # An early exit (the shuffle buffer met its quota) stops and joins
        # the threads now, not at garbage collection.
        stream.close()
