"""Batch iteration: the DataLoader (worker threads or worker processes),
the synchronized Binned wrapper, and the host-to-device prefetcher.

Counterpart of ``lddl_tpu/loader/dataloader.py``. Batch order is a pure
function of (base_seed, epoch): worker w collates its own stream and the
loader serves worker batches round-robin; ``Binned`` draws each
iteration's bin from the world stream, weighted by remaining samples.

- ``worker_mode="thread"`` (default): numpy decode and collate release
  the GIL for much of their work, and threads share the batch memory with
  the consumer (no copy).
- ``worker_mode="process"``: persistent spawned workers, started once and
  given one command per epoch; each rebuilds its stream from the
  dataset's pure definition (``worker_stream(epoch, w)``). Batches cross
  the process boundary as qserde frames, read from each worker's queue by
  a pump thread. A worker that dies is restarted once and its stream
  replayed; a second death raises. Both modes give the same batches in
  the same order.

The workers import no torch: this module imports torch only where a
tensor is made (``prefetch_to_device``), and the collates produce numpy.

Telemetry (``LDDL_TPU_METRICS_DIR``): per-batch latency and padding
counters, and the attribution stages of ``observability.attribution``.
"""

import queue
import threading
import time

from .. import observability as obs
from ..resilience import faults
from ..utils import rng as lrng
from ..utils.logging import DatasetLogger


class _EpochObserver:
    """Per-batch telemetry with the registry handles resolved once per
    epoch; the padding-efficiency gauge (real tokens / padded slots) is
    set at the end of the epoch. Read-only on the batch."""

    __slots__ = ("_latency", "_batches", "_samples", "_real", "_padded",
                 "_gauge")

    def __init__(self):
        reg = obs.registry()
        self._latency = reg.histogram("loader_batch_latency_seconds")
        self._batches = reg.counter("loader_batches_total")
        self._samples = reg.counter("loader_samples_total")
        self._real = reg.counter("loader_real_tokens_total")
        self._padded = reg.counter("loader_padded_slots_total")
        self._gauge = reg.gauge("loader_padding_efficiency")

    def batch(self, batch, dt_s):
        self._latency.observe(dt_s)
        self._batches.inc()
        if isinstance(batch, dict) and "attention_mask" in batch:
            mask = batch["attention_mask"]
            self._samples.inc(len(mask))
            self._real.inc(int(mask.sum()))
            self._padded.inc(int(mask.size))
        elif isinstance(batch, (list, tuple)):
            self._samples.inc(len(batch))

    def finish(self):
        padded = self._padded.total()
        if padded:
            self._gauge.set(self._real.total() / padded)


def _timed_collate(collate):
    """``collate`` wrapped with the ``collate`` attribution stage (only
    when telemetry is on); the batch is untouched."""
    from ..observability import attribution
    stage = attribution.stage_counter()

    def timed(batch, _c=collate, _s=stage, _pc=time.perf_counter):
        t0 = _pc()
        out = _c(batch)
        _s.inc(_pc() - t0, stage="collate")
        return out

    return timed


def _stream_one_epoch(dataset, worker_idx, epoch, batch_size, collate_fn,
                      rng_spec, out_q):
    """Stream one epoch's collated batches into the queue. Each batch is
    serialized here (qserde), not by the queue's feeder thread, so a
    pickling error is forwarded as an error instead of a dropped batch."""
    from . import qserde
    try:
        if rng_spec is not None:
            g = lrng.sample_rng(*rng_spec)
            collate = lambda b: collate_fn(b, g=g)  # noqa: E731
        else:
            collate = collate_fn or (lambda b: b)
        if obs.enabled():
            # Spawned workers inherit LDDL_TPU_METRICS_DIR: their stage
            # seconds land in their own registry and per-pid export.
            collate = _timed_collate(collate)

        def put_batch(b):
            # A "worker:kill" fault SIGKILLs this worker here, before the
            # batch is sent (supervision restarts it and replays).
            faults.fault_point("worker", "w{}".format(worker_idx))
            out_q.put(("batch", qserde.encode(collate(b))))

        batch = []
        for sample in dataset.worker_stream(epoch, worker_idx):
            batch.append(sample)
            if len(batch) == batch_size:
                put_batch(batch)
                batch = []
        if batch:
            put_batch(batch)
        out_q.put(("end", None))
    except BaseException:  # noqa: BLE001 - forwarded to the consumer
        import traceback
        out_q.put(("error", traceback.format_exc()))


def _persistent_worker_main(dataset, worker_idx, batch_size, collate_fn,
                            cmd_q, out_q):
    """A persistent process worker: serve ("epoch", n, rng_spec) commands
    until ("stop",). Its pickled dataset never advances; every stream is
    ``dataset.worker_stream(epoch, w)``."""
    while True:
        cmd = cmd_q.get()
        if cmd[0] == "stop":
            return
        _, epoch, rng_spec = cmd
        _stream_one_epoch(dataset, worker_idx, epoch, batch_size,
                          collate_fn, rng_spec, out_q)


class DataLoader:
    """Iterates a ParquetDataset in batches.

    Epoch advance happens on ``__iter__``. Worker w collates its own
    stream; the loader serves worker batches round-robin."""

    # Domain tag of the per-worker collate RNG streams (dynamic masking).
    _COLLATE_RNG_TAG = 0xC011
    # A dead process worker is restarted at most this many times per
    # epoch; the next death raises a named error.
    _MAX_WORKER_RESTARTS = 1
    # How long a queue get waits before it checks the worker is alive.
    _POLL_TIMEOUT_S = 5.0

    def __init__(self, dataset, batch_size, collate_fn=None, prefetch=2,
                 worker_mode="thread"):
        if batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        if worker_mode not in ("thread", "process"):
            raise ValueError("worker_mode must be thread|process")
        # A loader process armed only through the env (LDDL_TPU_FLEET_DIR,
        # the equivalent of --fleet-telemetry) never calls configure() or
        # record(), so nothing would start the heartbeat or point the
        # metrics dir at the spool, and every obs.enabled() gate below
        # would read False. Kick the fleet once here, before any gate.
        try:
            from ..observability import fleet
            fleet.ensure_started()
        except Exception:  # noqa: BLE001 - telemetry must stay inert
            pass
        if worker_mode == "process":
            worker_mode = self._check_process_mode(dataset)
        self.dataset = dataset
        self.batch_size = batch_size
        self._user_collate = collate_fn  # None = raw samples (picklable)
        self._collate_fn = collate_fn or (lambda samples: samples)
        self._prefetch = max(1, prefetch)
        self._worker_mode = worker_mode
        self._procs = self._cmd_qs = self._out_qs = None
        self._local_qs = self._pump_stops = None
        self._finalizer = None
        self._pool_gen = 0
        self._epoch_active = False
        # Workers hold a pickled dataset: a new files_version (a
        # generation picked up at a boundary) respawns the pool.
        self._seen_files_version = getattr(dataset, "files_version", 0)
        # Process mode's cumulative IPC: framed bytes and batches received
        # (0 in thread mode).
        self.queue_bytes = 0
        self.queue_batches = 0

    @staticmethod
    def _check_process_mode(dataset):
        """Process workers pay off only with spare cores: with a budget of
        fewer than 2 cores (usable cores minus the shard-I/O threads of a
        stream), fall back to threads with a warning.
        ``LDDL_TPU_FORCE_PROCESS_WORKERS`` keeps process mode regardless
        (tests and measurements of the mode itself)."""
        import os
        if os.environ.get("LDDL_TPU_FORCE_PROCESS_WORKERS"):
            return "process"
        from ..utils.cpus import loader_io_threads, pool_cpu_budget
        io_threads = loader_io_threads()
        budget = pool_cpu_budget(reserve=io_threads)
        if budget < 2:
            import warnings
            warnings.warn(
                "worker_mode='process' with a {}-CPU budget (usable cores "
                "minus {} shard-I/O thread(s) per stream): falling back to "
                "thread mode, as process workers without spare cores pay "
                "spawn, pickle and queue costs for no parallelism".format(
                    budget, io_threads), stacklevel=4)
            return "thread"
        return "process"

    @property
    def num_batches_per_worker(self):
        num_files_per_worker = (self.dataset.num_files_per_group
                                // self.dataset.num_workers)
        samples_per_worker = (self.dataset.num_samples_per_file
                              * num_files_per_worker)
        return (samples_per_worker - 1) // self.batch_size + 1

    def __len__(self):
        """Batches per epoch, counting each worker's final partial batch."""
        return self.num_batches_per_worker * self.dataset.num_workers

    def _bind_collate(self, worker_idx):
        """Bind a per-(epoch, dp group, worker) RNG stream into the collate
        when it asks for one (dynamic masking)."""
        if not getattr(self._collate_fn, "needs_rng", False):
            return self._collate_fn
        ds = self.dataset
        g = lrng.sample_rng(ds.base_seed, self._COLLATE_RNG_TAG, ds.epoch,
                            ds.dp_rank, worker_idx)
        return lambda batch: self._collate_fn(batch, g=g)

    # ------------------------------------------------------- thread mode

    def _worker_loop(self, stream, out_q, stop, collate):
        def put(item):
            # Gives up once the consumer abandons the epoch, so a worker
            # never stays blocked on a full queue.
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        if obs.enabled():
            collate = _timed_collate(collate)
        try:
            batch = []
            for sample in stream:
                batch.append(sample)
                if len(batch) == self.batch_size:
                    if not put(("batch", collate(batch))):
                        return
                    batch = []
            if batch and not put(("batch", collate(batch))):
                return
            put(("end", None))
        except BaseException as e:  # noqa: BLE001 - forwarded to consumer
            put(("error", e))

    def _iter_thread(self):
        streams = self.dataset.start_epoch()
        stop = threading.Event()
        queues = [queue.Queue(maxsize=self._prefetch) for _ in streams]
        threads = [
            threading.Thread(target=self._worker_loop,
                             args=(s, q, stop, self._bind_collate(w)),
                             daemon=True)
            for w, (s, q) in enumerate(zip(streams, queues))
        ]
        for t in threads:
            t.start()
        live = list(range(len(queues)))
        try:
            while live:
                for w in list(live):
                    kind, payload = queues[w].get()
                    if kind == "error":
                        raise payload
                    if kind == "end":
                        live.remove(w)
                        continue
                    yield payload
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=5)

    # ------------------------------------------------------ process mode

    def _spawn_worker(self, ctx, w):
        return ctx.Process(
            target=_persistent_worker_main,
            args=(self.dataset, w, self.batch_size, self._user_collate,
                  self._cmd_qs[w], self._out_qs[w]),
            daemon=True)

    def _ensure_worker_pool(self):
        """Spawn the persistent pool once; respawn it after a failed or
        abandoned epoch tore it down, or when a worker died while idle."""
        if self._procs is not None:
            if all(p.is_alive() for p in self._procs):
                return
            self.shutdown_workers()
        import multiprocessing
        import weakref
        # Spawn, never fork: the consumer holds threads and, on the card,
        # a CUDA context.
        ctx = multiprocessing.get_context("spawn")
        n = self.dataset.num_workers
        self._cmd_qs = [ctx.Queue() for _ in range(n)]
        self._out_qs = [ctx.Queue(maxsize=self._prefetch) for _ in range(n)]
        procs = [self._spawn_worker(ctx, w) for w in range(n)]
        try:
            for p in procs:
                p.start()
        except BaseException:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            raise
        self._procs = procs
        self._local_qs = [None] * n
        self._pump_stops = [None] * n
        for w in range(n):
            self._start_pump(w)
        self._pool_gen += 1
        # Daemon workers die with the interpreter anyway; the finalizer
        # releases them as soon as the loader is dropped.
        self._finalizer = weakref.finalize(
            self, DataLoader._shutdown_procs, procs)

    @staticmethod
    def _shutdown_procs(procs, grace_s=0):
        """Join ``procs`` for ``grace_s`` seconds in all, terminate the
        rest (a worker exports its telemetry on SIGTERM) and give them 5 s
        in all, then kill what is left."""
        def join_all(seconds):
            deadline = time.monotonic() + seconds
            for p in procs:
                if p.pid is not None:
                    p.join(timeout=max(0.0, deadline - time.monotonic()))

        join_all(grace_s)
        for p in procs:
            if p.is_alive():
                p.terminate()
        join_all(5)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=1)

    def shutdown_workers(self):
        """Stop the persistent process workers (no-op in thread mode): a
        ("stop",) command, a grace period of 2 s, then terminate."""
        self._shutdown_pool(grace_s=2)

    def _shutdown_pool(self, grace_s):
        if self._procs is None:
            return
        for q in self._cmd_qs:
            try:
                q.put(("stop",))
            except Exception:  # noqa: BLE001 - queue may be broken
                pass
        self._shutdown_procs(self._procs, grace_s=grace_s)
        for stop in self._pump_stops:
            if stop is not None:
                stop.set()
        if self._finalizer is not None:
            self._finalizer.detach()
        self._procs = self._cmd_qs = self._out_qs = None
        self._local_qs = self._pump_stops = None
        self._finalizer = None

    @staticmethod
    def _pump_worker_queue(mp_q, local_q, stop):
        """Forward a worker's output from its multiprocessing queue to an
        in-process queue, from a sacrificial daemon thread: a frame torn
        by a SIGKILL mid-put blocks its reader forever, so the consumer
        never reads the pipe itself. The local queue holds one item, so
        the worker's queue bound still applies."""
        while not stop.is_set():
            try:
                item = mp_q.get(timeout=0.5)
            except queue.Empty:
                continue
            except Exception:  # noqa: BLE001 - torn pipe or unpickling
                item = ("pump_torn", None)
            while not stop.is_set():
                try:
                    local_q.put(item, timeout=0.5)
                    break
                except queue.Full:
                    continue
            if item[0] == "pump_torn":
                return

    def _start_pump(self, w):
        stop = threading.Event()
        local_q = queue.Queue(maxsize=1)
        threading.Thread(target=self._pump_worker_queue,
                         args=(self._out_qs[w], local_q, stop),
                         daemon=True).start()
        self._local_qs[w] = local_q
        self._pump_stops[w] = stop

    def _restart_worker(self, w):
        """Replace dead worker ``w`` with a fresh spawn on fresh queues and
        a fresh pump (its old queue may hold a torn frame, its old pump be
        wedged on it); the pool lists change in place."""
        import multiprocessing
        ctx = multiprocessing.get_context("spawn")
        self._pump_stops[w].set()
        for q in (self._cmd_qs[w], self._out_qs[w]):
            try:
                q.close()
                q.cancel_join_thread()
            except Exception:  # noqa: BLE001 - queue may already be broken
                pass
        self._cmd_qs[w] = ctx.Queue()
        self._out_qs[w] = ctx.Queue(maxsize=self._prefetch)
        p = self._spawn_worker(ctx, w)
        p.start()
        old = self._procs[w]
        self._procs[w] = p
        self._start_pump(w)
        old.join(timeout=1)

    def _handle_worker_death(self, w, epoch, rng_spec, restarts, served,
                             skip):
        """Restart a dead worker once and replay its pure stream: the
        first ``served[w]`` batches are discarded unopened, so the batches
        the consumer sees do not change. A second death raises."""
        import warnings
        code = self._procs[w].exitcode
        restarts[w] += 1
        obs.inc("loader_worker_deaths_total", worker=w)
        if restarts[w] > self._MAX_WORKER_RESTARTS:
            obs.event("loader.worker_failed", worker=w, exit_code=code)
            raise RuntimeError(
                "loader worker {} died again after a restart (last exit "
                "code {}); failing fast — a worker that keeps dying needs "
                "a human, not another retry".format(w, code))
        obs.inc("loader_worker_restarts_total", worker=w)
        obs.event("loader.worker_restart", worker=w, exit_code=code,
                  replayed_batches=served[w])
        warnings.warn(
            "loader worker {} died (exit code {}); restarting it once and "
            "replaying its deterministic stream (discarding {} already-"
            "served batch(es))".format(w, code, served[w]), stacklevel=3)
        self._restart_worker(w)
        self._cmd_qs[w].put(("epoch", epoch, rng_spec))
        skip[w] = served[w]

    def _next_from(self, w, epoch, rng_spec, restarts, served, skip):
        """Worker ``w``'s next (kind, payload), with liveness checks
        against the pumped queue, restarts and the discard of replayed
        batches."""
        while True:
            try:
                kind, payload = self._local_qs[w].get(
                    timeout=self._POLL_TIMEOUT_S)
            except queue.Empty:
                if self._procs[w].is_alive():
                    continue
                self._handle_worker_death(w, epoch, rng_spec, restarts,
                                          served, skip)
                continue
            if kind == "pump_torn":
                # A SIGKILL mid-put tore the pipe; only a dead worker
                # excuses that.
                if self._procs[w].is_alive():
                    raise RuntimeError(
                        "loader worker {} output queue broke while the "
                        "worker is alive".format(w))
                self._handle_worker_death(w, epoch, rng_spec, restarts,
                                          served, skip)
                continue
            if kind == "batch" and skip[w] > 0:
                skip[w] -= 1   # a replayed batch: dropped unopened
                continue
            return kind, payload

    def _iter_process(self):
        from . import qserde
        ds = self.dataset
        epoch = ds.advance_epoch()
        version = getattr(ds, "files_version", 0)
        if version != self._seen_files_version:
            # A new generation at this boundary: the workers' pickled
            # datasets are stale.
            self._seen_files_version = version
            self.shutdown_workers()
        rng = getattr(self._collate_fn, "needs_rng", False)
        if self._epoch_active:
            # An earlier epoch's iterator is still mid-stream on the
            # queues: its leftovers would pass for this epoch's batches.
            # Its workers read no command mid-stream: no grace.
            self._shutdown_pool(grace_s=0)
            self._epoch_active = False
        self._ensure_worker_pool()
        gen = self._pool_gen
        self._epoch_active = True
        n = len(self._procs)

        def rng_spec(w):
            return ((ds.base_seed, self._COLLATE_RNG_TAG, epoch, ds.dp_rank,
                     w) if rng else None)

        for w in range(n):
            self._cmd_qs[w].put(("epoch", epoch, rng_spec(w)))
        live = list(range(n))
        served = [0] * n    # batches yielded, per worker
        restarts = [0] * n  # deaths survived this epoch, per worker
        skip = [0] * n      # replayed batches to discard after a restart
        obs_on = obs.enabled()
        if obs_on:
            from ..observability import attribution
            stage, pc = attribution.stage_counter(), time.perf_counter
        try:
            while live:
                for w in list(live):
                    kind, payload = self._next_from(
                        w, epoch, rng_spec(w), restarts, served, skip)
                    if kind == "error":
                        raise RuntimeError(
                            "loader worker {} failed:\n{}".format(w, payload))
                    if kind == "end":
                        if skip[w] > 0:
                            raise RuntimeError(
                                "loader worker {} replay ended {} batch(es) "
                                "early; its stream is not reproducing "
                                "deterministically".format(w, skip[w]))
                        live.remove(w)
                        continue
                    served[w] += 1
                    self.queue_bytes += len(payload)
                    self.queue_batches += 1
                    if obs_on:
                        # ipc: the payload decode thread mode never pays
                        # (the queue wait is in batch_wait).
                        t0 = pc()
                        decoded = qserde.decode(payload)
                        stage.inc(pc() - t0, stage="ipc")
                        yield decoded
                    else:
                        yield qserde.decode(payload)
        finally:
            if live:
                # Failed or abandoned mid-epoch: tear the pool down (its
                # workers are mid-stream, so without grace), unless a
                # newer epoch already replaced it.
                if self._pool_gen == gen and self._procs is not None:
                    self._shutdown_pool(grace_s=0)
            if self._pool_gen == gen:
                self._epoch_active = False

    # ---------------------------------------------------------- iterate

    def __iter__(self):
        inner = (self._iter_process() if self._worker_mode == "process"
                 else self._iter_thread())
        if not obs.enabled():
            yield from inner
            return
        yield from self._iter_instrumented(inner)

    def _iter_instrumented(self, inner):
        """The loader span, per-batch latency and padding, and the
        boundary pair ``batch_wait`` (consumer blocked in next()) /
        ``step_gap`` (consumer away), which partition the epoch's wall."""
        from ..observability import attribution
        watcher = _EpochObserver()
        stage = attribution.stage_counter()
        try:
            with obs.span("loader.epoch", mode=self._worker_mode,
                          batch_size=self.batch_size):
                t0 = time.perf_counter()
                for batch in inner:
                    t_ready = time.perf_counter()
                    watcher.batch(batch, t_ready - t0)
                    stage.inc(t_ready - t0, stage="batch_wait")
                    yield batch
                    t0 = time.perf_counter()
                    stage.inc(t0 - t_ready, stage="step_gap")
        finally:
            watcher.finish()
            inner.close()   # an abandoned epoch ends its workers now

    def attribution_snapshot(self):
        """The attribution report so far in this process (stage seconds,
        shares, verdict), or None when telemetry is off or nothing
        iterated."""
        from ..observability import attribution
        return attribution.snapshot()


class Binned:
    """One DataLoader per sequence-length bin; every iteration all ranks
    draw the same bin from the world RNG stream, weighted by remaining
    samples — identical choice with zero communication."""

    def __init__(self, dataloaders, base_seed=12345, start_epoch=0,
                 logger=None):
        self._dataloaders = dataloaders
        self._base_seed = base_seed
        self._epoch = start_epoch - 1
        self._logger = logger or DatasetLogger()

    def __len__(self):
        return sum(len(dl) for dl in self._dataloaders)

    @property
    def epoch(self):
        return self._epoch

    def _get_batch_size(self, batch):
        raise NotImplementedError("Binned is abstract: use a subclass that "
                                  "knows the batch structure")

    def shutdown_workers(self):
        """Stop every bin loader's process workers."""
        for dl in self._dataloaders:
            dl.shutdown_workers()

    def attribution_snapshot(self):
        """The attribution report across every bin (the stage counter is
        process-wide)."""
        from ..observability import attribution
        return attribution.snapshot()

    def __iter__(self):
        self._epoch += 1
        # Refresh every bin before sizing the epoch, so the remaining-
        # sample bookkeeping and each bin's epoch agree on one file set.
        for dl in self._dataloaders:
            refresh = getattr(dl.dataset, "maybe_refresh", None)
            if refresh is not None:
                refresh()
        world_g = lrng.world_rng(self._base_seed, self._epoch)
        remaining = [len(dl.dataset) for dl in self._dataloaders]
        iters = [iter(dl) for dl in self._dataloaders]
        bin_ids = list(range(len(iters)))
        obs_on = obs.enabled()
        log = self._logger.to("rank")
        try:
            for i in range(len(self)):
                bin_id = lrng.choices(world_g, bin_ids, weights=remaining)[0]
                log.debug("iteration {} selects bin {}".format(i, bin_id))
                if obs_on:
                    obs.inc("loader_bin_choice_total", bin=bin_id)
                if remaining[bin_id] <= 0:
                    raise RuntimeError("bin {} chosen with no samples left"
                                       .format(bin_id))
                batch = next(iters[bin_id])
                remaining[bin_id] -= self._get_batch_size(batch)
                yield batch
            if sum(remaining) != 0:
                raise RuntimeError("bin bookkeeping out of sync: {} samples "
                                   "unaccounted".format(sum(remaining)))
            # Let each bin iterator finish naturally (consume its end
            # marker): closing a suspended process-mode iterator would read
            # as an abandoned epoch and tear its pool down.
            for it in iters:
                if next(it, None) is not None:
                    raise RuntimeError("bin served a batch past its count")
        finally:
            # An abandoned or failed epoch closes every bin's iterator now
            # (a finished one is closed already), not when collected.
            for it in iters:
                it.close()


def _to_host_tensors(batch):
    import numpy as np
    import torch
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


class _DevicePrefetcher:
    """Iterable produced by :func:`prefetch_to_device` (re-iterable: each
    ``iter()`` runs one epoch of the wrapped loader)."""

    def __init__(self, loader, device, depth):
        self._loader = loader
        self._device = device
        self._depth = depth

    def __len__(self):
        return len(self._loader)

    def __iter__(self):
        import torch
        device = self._device
        cuda = device.type == "cuda"
        copy_stream = torch.cuda.Stream(device) if cuda else None

        def device_put(batch):
            host = _to_host_tensors(batch)
            if not cuda:
                return host, None
            # Pinned host memory (a copy, so a tensor over a qserde frame
            # never feeds an asynchronous copy) and a non_blocking copy on
            # the side stream, which overlaps the consumer's step.
            with torch.cuda.stream(copy_stream):
                out = {k: t.pin_memory().to(device, non_blocking=True)
                       for k, t in host.items()}
                done = torch.cuda.Event()
                done.record(copy_stream)
            return out, done

        obs_on = obs.enabled()
        if obs_on:
            from ..observability import attribution
            reg = obs.registry()
            batches = reg.counter("loader_prefetch_batches_total")
            wait = reg.histogram("loader_prefetch_wait_seconds")
            stage = attribution.stage_counter()
            untimed_put = device_put

            def device_put(batch, _d=untimed_put, _s=stage,
                           _pc=time.perf_counter):
                # h2d: the host side of the transfer (tensor wrap, pinned
                # copy, dispatch of the asynchronous copy).
                t0 = _pc()
                out = _d(batch)
                _s.inc(_pc() - t0, stage="h2d")
                return out

        stop = threading.Event()
        q = queue.Queue(maxsize=self._depth)

        def put(item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            it = iter(self._loader)
            try:
                for batch in it:
                    if not put(("batch", device_put(batch))):
                        return
                put(("end", None))
            except BaseException as e:  # noqa: BLE001 - forwarded
                put(("error", e))
            finally:
                close = getattr(it, "close", None)
                if close is not None:
                    close()   # an abandoned epoch ends its workers now

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            t_yield = None
            while True:
                t0 = time.perf_counter()
                if obs_on and t_yield is not None:
                    # The consumer was away running its step.
                    stage.inc(t0 - t_yield, stage="prefetch_gap")
                kind, payload = q.get()
                if kind == "error":
                    raise payload
                if kind == "end":
                    return
                if obs_on:
                    dt = time.perf_counter() - t0
                    batches.inc()
                    wait.observe(dt)
                    stage.inc(dt, stage="prefetch_wait")
                out, done = payload
                if done is not None:
                    # The step's stream waits for the copy to land, and
                    # the allocator keeps each tensor's memory until that
                    # stream is done with it.
                    stream = torch.cuda.current_stream(device)
                    stream.wait_event(done)
                    for v in out.values():
                        v.record_stream(stream)
                if obs_on:
                    t_yield = time.perf_counter()
                yield out
        finally:
            stop.set()
            t.join(timeout=5)


def prefetch_to_device(loader, device=None, depth=2):
    """Double-buffered host->device pipeline: a background thread drains
    ``loader`` and copies each numpy batch dict to ``device`` (default
    ``cuda``, ``cuda:LOCAL_RANK`` once a process group is up;
    ``device="cpu"`` gives CPU tensors) up to ``depth`` batches ahead of
    the consumer. On CUDA the copy runs from pinned memory on a side
    stream; the consumer's current stream waits on an event recorded
    after the copy, so a step never reads a batch before it lands.
    Order-preserving and re-iterable (one loader epoch per ``iter()``).
    With telemetry on it records ``loader_prefetch_batches_total``,
    ``loader_prefetch_wait_seconds`` and the ``h2d``, ``prefetch_wait``
    and ``prefetch_gap`` stages."""
    from ..device import resolve_device
    return _DevicePrefetcher(loader, resolve_device(device), max(1, depth))
