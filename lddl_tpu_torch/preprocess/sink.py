"""Asynchronous durable shard sink: the double-buffered writer thread.

Counterpart of ``lddl_tpu/preprocess/sink.py``, without its telemetry. A
:class:`ShardWriter` owns ONE writer thread and a bounded queue (depth 2:
double buffering), and the producer hands it *deferred publish closures*
instead of writing inline. While the writer encodes, fsyncs and publishes
bucket N, the producer tokenizes and masks bucket N+1; parquet encode,
lz4, fsync and the file writes release the GIL, so the overlap is real
in one process.

Invariants (the writer only defers the publish path; what is written
does not change):

- **Byte identity.** Closures run in FIFO submit order on one thread, so
  shard bytes, file names and manifests equal a serial run's.
- **Atomic publish.** Closures publish through ``utils.io``'s atomic
  writes, as the inline path does.
- **Errors fail the unit loudly.** A closure that raises marks its unit
  failed, the unit's remaining closures are skipped, and the failure
  reaches the producer at the next ``completed()``/``drain()``, before
  the unit's ledger record is written, so a resume redoes the unit.
- **Journal ordering.** Unit ledger records are written only after the
  writer drained that unit's closures.
- **Fenced publish.** In elastic mode a task carries its unit's lease
  fence; the writer checks it immediately before the deferred publish,
  and a fenced-off unit fails with ``LeaseLost`` (the claim loop turns
  that into a fence reject). The ``sink-write`` fault site fires just
  before that check.
"""

import queue
import threading

from ..resilience import faults

_END = object()  # end-of-unit marker

# Queue depth: two deferred publishes in flight (double buffering).
DEPTH = 2


class DeferredUnit:
    """What a unit function returns when its writes (and so its result
    dict) materialize on the shard writer: the unit completes at a later
    ``completed()``/``drain()``."""

    __slots__ = ("unit",)

    def __init__(self, unit):
        self.unit = unit


class ShardWriter:
    """One writer thread + bounded FIFO queue of deferred publish tasks.

    Producer API (single producer thread):
        ``submit(unit, fn, fence=None)``  enqueue one deferred publish;
            ``fn() -> {path: rows}`` accumulates into the unit's result;
            ``fence() -> bool`` (elastic mode) is checked right before
            ``fn`` runs.
        ``end_unit(unit)``  mark the unit's last task as enqueued.
        ``completed()``  -> [(unit, written, exc)] units finished SO FAR.
        ``drain()``  block until the queue is empty, then ``completed()``.
        ``close()``  stop the thread (idempotent; call from ``finally``).
    """

    def __init__(self, name="shard-sink"):
        self._lock = threading.Lock()
        self._open = {}   # unit -> {"written": dict, "exc": Exception|None}
        self._done = []   # [(unit, written, exc)] awaiting collection
        self._queue = queue.Queue(maxsize=DEPTH)
        self._thread = threading.Thread(target=self._run, name=name,
                                        daemon=True)
        self._thread.start()

    def submit(self, unit, fn, fence=None):
        self._open.setdefault(unit, {"written": {}, "exc": None})
        self._queue.put((unit, fn, fence))

    def end_unit(self, unit):
        self._open.setdefault(unit, {"written": {}, "exc": None})
        self._queue.put((unit, _END, None))

    def completed(self):
        """Units whose last task finished since the previous call, in
        completion (== submit) order."""
        with self._lock:
            done, self._done = self._done, []
        return done

    def drain(self):
        """Block until every enqueued task ran; return ``completed()``."""
        self._queue.join()
        return self.completed()

    def close(self):
        if self._thread is not None:
            self._queue.join()
            self._queue.put(None)  # thread shutdown sentinel
            self._thread.join()
            self._thread = None

    def _run(self):
        while True:
            task = self._queue.get()
            if task is None:
                self._queue.task_done()
                return
            unit, fn, fence = task
            state = self._open.get(unit)
            try:
                if fn is _END:
                    self._finish(unit, state)
                elif state["exc"] is None:
                    faults.fault_point("sink-write", str(unit))
                    if fence is not None and not fence():
                        from ..resilience.leases import LeaseLost
                        raise LeaseLost(
                            "unit {} was stolen before its deferred "
                            "publish; self-terminating".format(unit))
                    res = fn()
                    if res:
                        state["written"].update(res)
            # The writer thread must never die with tasks queued (drain
            # would deadlock): a failure becomes the unit's error.
            except Exception as e:  # noqa: BLE001 - surfaces at drain
                if state is not None:
                    state["exc"] = e
                else:
                    with self._lock:
                        self._done.append((unit, {}, e))
            finally:
                self._queue.task_done()

    def _finish(self, unit, state):
        if state is None:
            state = {"written": {}, "exc": RuntimeError(
                "unmatched end_unit for {!r} (no open unit)".format(unit))}
        self._open.pop(unit, None)
        with self._lock:
            self._done.append((unit, state["written"], state["exc"]))


def collect_into(done, record, record_failure):
    """Route ``completed()`` tuples into the runner's per-unit result /
    failure recorders (a unit is journaled by ``record`` only here, i.e.
    only after its writes drained)."""
    for unit, written, exc in done:
        if exc is None:
            record(unit, written)
        else:
            record_failure(unit, "{}: {}".format(type(exc).__name__, exc))
