"""Batch iteration: worker-threaded DataLoader, the synchronized Binned
wrapper, and the host-to-device prefetcher.

Counterpart of ``lddl_tpu/loader/dataloader.py`` (``DataLoader`` in
thread mode, ``Binned``, ``prefetch_to_device``). Batch order is a pure
function of (base_seed, epoch): worker w collates its own stream and the
loader serves worker batches round-robin; ``Binned`` draws each
iteration's bin from the world stream, weighted by remaining samples.
"""

import logging
import queue
import threading

import numpy as np
import torch

from ..device import resolve_device
from ..utils import rng as lrng

logger = logging.getLogger(__name__)


class DataLoader:
    """Iterates a ParquetDataset in batches (one thread per worker).

    Epoch advance happens on ``__iter__`` (via dataset.start_epoch)."""

    # Domain tag for per-worker collation RNG streams (dynamic masking).
    _COLLATE_RNG_TAG = 0xC011

    def __init__(self, dataset, batch_size, collate_fn=None, prefetch=2):
        if batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        self.dataset = dataset
        self.batch_size = batch_size
        self._collate_fn = collate_fn or (lambda samples: samples)
        self._prefetch = max(1, prefetch)

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

    def __iter__(self):
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


class Binned:
    """One DataLoader per sequence-length bin; every iteration all ranks
    draw the same bin from the world RNG stream, weighted by remaining
    samples — identical choice with zero communication."""

    def __init__(self, dataloaders, base_seed=12345, start_epoch=0):
        self._dataloaders = dataloaders
        self._base_seed = base_seed
        self._epoch = start_epoch - 1

    def __len__(self):
        return sum(len(dl) for dl in self._dataloaders)

    def _get_batch_size(self, batch):
        raise NotImplementedError("Binned is abstract: use a subclass that "
                                  "knows the batch structure")

    def __iter__(self):
        self._epoch += 1
        world_g = lrng.world_rng(self._base_seed, self._epoch)
        remaining = [len(dl.dataset) for dl in self._dataloaders]
        iters = [iter(dl) for dl in self._dataloaders]
        bin_ids = list(range(len(iters)))
        for i in range(len(self)):
            bin_id = lrng.choices(world_g, bin_ids, weights=remaining)[0]
            logger.debug("iteration %d selects bin %d", i, bin_id)
            if remaining[bin_id] <= 0:
                raise RuntimeError("bin {} chosen with no samples left"
                                   .format(bin_id))
            batch = next(iters[bin_id])
            remaining[bin_id] -= self._get_batch_size(batch)
            yield batch
        if sum(remaining) != 0:
            raise RuntimeError("bin bookkeeping out of sync: {} samples "
                               "unaccounted".format(sum(remaining)))
        # Let each bin iterator finish naturally (consume its end marker).
        for it in iters:
            if next(it, None) is not None:
                raise RuntimeError("bin served a batch past its count")


def _to_host_tensors(batch):
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
        device = self._device
        cuda = device.type == "cuda"
        copy_stream = torch.cuda.Stream(device) if cuda else None

        def device_put(batch):
            host = _to_host_tensors(batch)
            if not cuda:
                return host, None
            # Pinned host memory + a non_blocking copy on the side stream:
            # the copy overlaps the step running on the consumer's stream.
            with torch.cuda.stream(copy_stream):
                out = {k: t.pin_memory().to(device, non_blocking=True)
                       for k, t in host.items()}
                done = torch.cuda.Event()
                done.record(copy_stream)
            return out, done

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
            try:
                for batch in self._loader:
                    if not put(("batch", device_put(batch))):
                        return
                put(("end", None))
            except BaseException as e:  # noqa: BLE001 - forwarded
                put(("error", e))

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                kind, payload = q.get()
                if kind == "error":
                    raise payload
                if kind == "end":
                    return
                out, done = payload
                if done is not None:
                    # The step's stream waits for the copy to land, and the
                    # allocator keeps each tensor's memory until the step's
                    # stream is done with it.
                    stream = torch.cuda.current_stream(device)
                    stream.wait_event(done)
                    for v in out.values():
                        v.record_stream(stream)
                yield out
        finally:
            stop.set()
            t.join(timeout=5)


def prefetch_to_device(loader, device=None, depth=2):
    """Double-buffered host->device pipeline: a background thread drains
    ``loader`` and copies each numpy batch dict to ``device`` (default
    ``cuda``, ``cuda:LOCAL_RANK`` once a process group is up;
    ``device="cpu"`` gives CPU tensors) up to ``depth`` batches
    ahead of the consumer. On CUDA the copy runs from pinned memory on a
    side stream; the consumer's current stream waits on an event recorded
    after the copy, so a step never reads a batch before it lands.
    Order-preserving and re-iterable (one loader epoch per ``iter()``)."""
    return _DevicePrefetcher(loader, resolve_device(device), max(1, depth))
