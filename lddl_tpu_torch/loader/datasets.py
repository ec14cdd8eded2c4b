"""Streaming shard datasets with deterministic epoch-seeded shuffling.

Counterpart of ``lddl_tpu/loader/datasets.py`` (``ShuffleBuffer``,
``ParquetDataset``) for balanced shards read synchronously: each worker
stream reads its shards one after another with ``pyarrow.parquet``. That
is the byte stream the reference loader yields with its shard read-ahead
off (``LDDL_TPU_LOADER_PREFETCH_SHARDS=0``), which equals the stream with
it on.

Determinism contract: epoch k derives every random choice from
(base_seed, epoch) — a world-identical file shuffle, then per-(dp_rank,
worker) shuffle-buffer streams. All ranks of one dp group draw identical
files and samples.
"""

import collections
import logging
import os

from ..utils import rng as lrng
from ..utils.fs import (get_num_samples_of_parquet, read_num_samples_cache,
                        trusted_num_samples_entries)

logger = logging.getLogger(__name__)

File = collections.namedtuple("File", ["path", "num_samples"])


class ShuffleBuffer:
    """Streaming shuffle: warmup fills the buffer at ``warmup_factor``:1,
    then each new sample swap-replaces a random buffered sample, which is
    yielded; the tail is shuffled and drained."""

    def __init__(self, files, max_num_samples_to_yield, decode_record_batch,
                 size, warmup_factor, g):
        num_wasted = (sum(f.num_samples for f in files)
                      - max_num_samples_to_yield)
        if not 0 <= num_wasted <= len(files):
            raise ValueError("shuffle buffer asked for {} of {} samples"
                             .format(max_num_samples_to_yield,
                                     sum(f.num_samples for f in files)))
        self._files = files
        self._max_num_samples_to_yield = max_num_samples_to_yield
        self._decode_record_batch = decode_record_batch
        self._size = size
        self._warmup_factor = warmup_factor
        self._g = g

    @property
    def num_samples(self):
        return sum(f.num_samples for f in self._files)

    def __iter__(self):
        import pyarrow.parquet as pq
        buffer = []
        num_to_yield = min(self._max_num_samples_to_yield, self.num_samples)
        remaining = num_to_yield
        for f in self._files:
            table = pq.read_table(f.path)
            for record_batch in table.to_batches():
                for sample in self._decode_record_batch(record_batch):
                    if remaining <= 0:
                        return
                    warmup_cap = ((num_to_yield - remaining + 1)
                                  * self._warmup_factor)
                    if len(buffer) >= min(self._size, warmup_cap):
                        idx = int(self._g.integers(0, len(buffer)))
                        yield buffer[idx]
                        buffer[idx] = sample
                        remaining -= 1
                    else:
                        buffer.append(sample)
        lrng.shuffle(self._g, buffer)
        for sample in buffer:
            if remaining <= 0:
                return
            yield sample
            remaining -= 1


class ParquetDataset:
    """Balanced parquet shards -> per-(dp_rank, worker) sample streams.

    ``file_paths`` must be balanced (all counts equal ±1); files are
    truncated to the min count so every dp group sees the same number of
    samples per epoch."""

    def __init__(self, file_paths, base_seed=12345, start_epoch=0,
                 dp_rank=0, num_dp_groups=1, num_workers=1,
                 shuffle_buffer_size=16384, shuffle_buffer_warmup_factor=16,
                 decode_record_batch=None):
        if decode_record_batch is None:
            raise ValueError("decode_record_batch is required")
        if not file_paths:
            raise ValueError("no input shard files")
        num_workers = max(1, num_workers)
        if len(file_paths) % num_dp_groups != 0:
            raise ValueError(
                "{} files not divisible by {} data-parallel groups".format(
                    len(file_paths), num_dp_groups))
        if (len(file_paths) // num_dp_groups) % num_workers != 0:
            raise ValueError(
                "{} files per dp group not divisible by {} workers".format(
                    len(file_paths) // num_dp_groups, num_workers))
        self._base_seed = base_seed
        self._epoch = start_epoch - 1
        self._dp_rank = dp_rank
        self._num_dp_groups = num_dp_groups
        self._num_workers = num_workers
        self._shuffle_buffer_size = shuffle_buffer_size
        self._shuffle_buffer_warmup_factor = shuffle_buffer_warmup_factor
        self._decode_record_batch = decode_record_batch
        self._files = self._census(sorted(file_paths))
        self._num_samples_per_file = self._validate_counts(self._files)

    @staticmethod
    def _validate_counts(files):
        counts = [f.num_samples for f in files]
        lo, hi = min(counts), max(counts)
        if not (lo == hi or lo + 1 == hi):
            raise ValueError(
                "input shards not balanced (counts range {}..{}); balance "
                "them first".format(lo, hi))
        if lo == 0:
            raise ValueError("input shards contain empty files")
        lost = sum(counts) - lo * len(files)
        if lost:
            logger.warning(
                "dropping %d sample(s) to equalize shard counts", lost)
        return lo

    @staticmethod
    def _census(file_paths):
        """Per-file counts from the ``.num_samples.json`` caches; footer
        reads only for entries a cache cannot vouch for."""
        counts = {}
        for d in sorted({os.path.dirname(p) for p in file_paths}):
            cached = read_num_samples_cache(d)
            trusted, untrusted = trusted_num_samples_entries(d, cached)
            if cached is not None and untrusted:
                logger.warning(
                    ".num_samples.json in %s cannot vouch for %d shard(s); "
                    "counting those from parquet footers", d, len(untrusted))
            for name, n in trusted.items():
                counts[os.path.join(d, name)] = int(n)
        return [File(p, counts.get(p) or get_num_samples_of_parquet(p))
                for p in file_paths]

    @property
    def base_seed(self):
        return self._base_seed

    @property
    def dp_rank(self):
        return self._dp_rank

    @property
    def num_files_per_group(self):
        return len(self._files) // self._num_dp_groups

    @property
    def num_samples_per_file(self):
        return self._num_samples_per_file

    @property
    def num_workers(self):
        return self._num_workers

    @property
    def epoch(self):
        return self._epoch

    def __len__(self):
        """Samples one dp group sees per epoch."""
        return self._num_samples_per_file * self.num_files_per_group

    def start_epoch(self):
        """Advance to the next epoch; returns per-worker sample streams.

        The file shuffle uses the world stream; this dp group takes
        ``files[dp_rank::num_dp_groups]`` and worker w every
        num_workers-th of those."""
        self._epoch += 1
        world_g = lrng.world_rng(self._base_seed, self._epoch)
        files = list(self._files)
        lrng.shuffle(world_g, files)
        group_files = files[self._dp_rank::self._num_dp_groups]
        return [self._worker_stream(group_files, w)
                for w in range(self._num_workers)]

    def _worker_stream(self, group_files, w):
        worker_files = group_files[w::self._num_workers]
        worker_g = lrng.worker_rng(self._base_seed, self._epoch,
                                   self._dp_rank, self._num_dp_groups, w,
                                   self._num_workers)
        return iter(ShuffleBuffer(
            worker_files,
            self._num_samples_per_file * len(worker_files),
            self._decode_record_batch,
            self._shuffle_buffer_size,
            self._shuffle_buffer_warmup_factor,
            worker_g,
        ))
