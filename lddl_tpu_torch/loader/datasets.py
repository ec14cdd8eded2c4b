"""Streaming shard datasets with deterministic epoch-seeded shuffling.

Counterpart of ``lddl_tpu/loader/datasets.py`` (``verified_shard_paths``,
``annotate_quarantine``, ``ShuffleBuffer``, ``ParquetDataset``). Sharding
is by data-parallel group (``dp_rank``).

Determinism contract: epoch k derives every random choice from
(base_seed, epoch) — a world-identical file shuffle, then per-(dp_rank,
worker) shuffle-buffer streams — so restarting at ``start_epoch=k``
reproduces epoch k, and all ranks of one dp group draw identical files
and samples. ``worker_stream(epoch, w)`` is a pure function of those, so
a process-mode worker rebuilds its own stream from a pickled copy.

Shards are read through ``shardcache.shard_tables`` (read-ahead, the
shard cache and decode-ahead, or a plain synchronous read), always in
file order, so the stream is the same either way.

Nothing here imports torch: process-mode workers unpickle this module.
"""

import os

from .. import observability as obs
from ..utils import rng as lrng
from ..utils.fs import (get_num_samples_of_parquet, read_num_samples_cache,
                        trusted_num_samples_entries)
from ..utils.logging import DatasetLogger
from ..utils.types import File
from .shardcache import shard_tables


def verified_shard_paths(path, file_paths, on_corrupt=None, logger=None,
                         comm=None):
    """Startup integrity gate of the loader factories: verify the shards
    against their directories' ``.manifest.json`` (shards without one are
    trusted as they are). ``on_corrupt`` is ``"fail"`` (raise naming every
    corrupt shard) or ``"quarantine"`` (exclude them, log each, return the
    survivors); None defers to ``LDDL_TPU_ON_CORRUPT``, then ``"fail"``.
    Raises if quarantine leaves no shard."""
    from ..resilience.integrity import verify_shards
    if on_corrupt is None:
        on_corrupt = os.environ.get("LDDL_TPU_ON_CORRUPT", "fail")
    log = None
    if logger is not None:
        log = lambda msg: logger.to("rank").warning(msg)  # noqa: E731
    good, _ = verify_shards(file_paths, on_corrupt=on_corrupt, log=log,
                            comm=comm)
    if not good:
        raise ValueError(
            "every parquet shard under {} was quarantined as corrupt; "
            "re-run the producing stage".format(path))
    return good


def annotate_quarantine(exc, n_quarantined):
    """A downstream shard-set error (bin contiguity, dp-group
    divisibility, balance) with the quarantine called out, so the
    operator looks at the corrupt shards just logged."""
    return ValueError(
        "{} (note: {} corrupt shard(s) were quarantined at startup, which "
        "changed the shard set — re-run the producing stage to restore "
        "them, or adjust num_dp_groups/num_workers to the surviving "
        "count)".format(exc, n_quarantined))


class _SoloComm:
    """A world of one, for census and refresh without a communicator
    (the port's ``parallel`` package imports torch; this module must
    not)."""

    rank = 0
    world_size = 1

    @staticmethod
    def allreduce_sum(values):
        return list(values)


class ShuffleBuffer:
    """Streaming shuffle: warmup fills the buffer at ``warmup_factor``:1,
    then each new sample swap-replaces a random buffered sample, which is
    yielded; the tail is shuffled and drained."""

    def __init__(self, files, max_num_samples_to_yield, decode_record_batch,
                 size, warmup_factor, g, logger=None):
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
        self._logger = logger

    @property
    def num_samples(self):
        return sum(f.num_samples for f in self._files)

    def __iter__(self):
        buffer = []
        num_to_yield = min(self._max_num_samples_to_yield, self.num_samples)
        remaining = num_to_yield
        # Telemetry is hoisted out of the per-sample loop: one check per
        # epoch; the fill gauge samples every 1024 yields.
        obs_on = obs.enabled()
        gauge = None
        decode = self._decode_record_batch
        if obs_on:
            import time
            from ..observability import attribution
            gauge = obs.registry().gauge(
                "loader_shuffle_buffer_fill",
                help="shuffle-buffer occupancy / configured size")
            stage = attribution.stage_counter()

            def decode(rb, _d=self._decode_record_batch, _s=stage,
                       _pc=time.perf_counter):
                # The decode stage: time spent inside the sample
                # generator, timed per resume.
                it = iter(_d(rb))
                while True:
                    t0 = _pc()
                    try:
                        sample = next(it)
                    except StopIteration:
                        _s.inc(_pc() - t0, stage="decode")
                        return
                    _s.inc(_pc() - t0, stage="decode")
                    yield sample

        for _, table in shard_tables(self._files, logger=self._logger):
            for record_batch in table.to_batches():
                for sample in decode(record_batch):
                    if remaining <= 0:
                        return
                    warmup_cap = ((num_to_yield - remaining + 1)
                                  * self._warmup_factor)
                    if len(buffer) >= min(self._size, warmup_cap):
                        idx = int(self._g.integers(0, len(buffer)))
                        yield buffer[idx]
                        buffer[idx] = sample
                        remaining -= 1
                        if gauge is not None and remaining % 1024 == 0:
                            gauge.set(len(buffer) / max(self._size, 1))
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
    samples per epoch. ``comm`` (a ``parallel`` communicator) runs the
    sample-count census and the generation agreement across ranks.
    ``refresh`` is an optional picklable callable returning the current
    verified file list of a growing (multi-generation) directory, read
    once per epoch boundary (``maybe_refresh``)."""

    def __init__(self, file_paths, base_seed=12345, start_epoch=0,
                 dp_rank=0, num_dp_groups=1, num_workers=1,
                 shuffle_buffer_size=16384, shuffle_buffer_warmup_factor=16,
                 decode_record_batch=None, comm=None, logger=None,
                 refresh=None):
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
        self._logger = logger or DatasetLogger()
        # The communicator is never pickled and pickled copies never
        # refresh: process-mode workers get a new file list through a
        # respawn of the pool.
        self._refresh = refresh
        self._comm = comm
        self._files_version = 0
        self._refreshed_for = None
        self._files = self._census(sorted(file_paths), comm or _SoloComm())
        self._num_samples_per_file = self._validate_counts(self._files)

    def _validate_counts(self, files):
        """The ±1 balance check; returns the per-file (min) count."""
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
            self._logger.to("rank").warning(
                "dropping {} sample(s) to equalize shard counts".format(lost))
        return lo

    def __getstate__(self):
        state = self.__dict__.copy()
        state["_comm"] = None
        state["_refresh"] = None
        return state

    def _census(self, file_paths, comm, on_error="raise"):
        """Per-file counts from the ``.num_samples.json`` caches, with
        strided footer reads and one allreduce for the entries a cache
        cannot vouch for. Every rank allreduces a full-length vector, each
        index contributed by its stride owner, so participation never
        depends on a rank's local view of the caches. ``on_error=
        "sentinel"`` (epoch-boundary refresh) poisons the count of an
        unreadable footer instead of raising, so no rank abandons the
        collective."""
        dir_counts = {}
        for d in sorted({os.path.dirname(p) for p in file_paths}):
            cached = read_num_samples_cache(d)
            trusted, untrusted = trusted_num_samples_entries(d, cached)
            if cached is not None and untrusted:
                self._logger.to("rank").warning(
                    ".num_samples.json in {} cannot vouch for {} shard(s); "
                    "counting those from parquet footers".format(
                        d, len(untrusted)))
            for name, n in trusted.items():
                dir_counts[os.path.join(d, name)] = n
        counts = [0] * len(file_paths)
        for i in range(comm.rank, len(file_paths), comm.world_size):
            p = file_paths[i]
            n = dir_counts.get(p)
            if n:
                counts[i] = int(n)
            elif on_error == "raise":
                counts[i] = get_num_samples_of_parquet(p)
            else:
                try:
                    counts[i] = get_num_samples_of_parquet(p)
                except (OSError, ValueError):
                    counts[i] = -(1 << 40)
        counts = comm.allreduce_sum(counts)
        return [File(p, int(n)) for p, n in zip(file_paths, counts)]

    @property
    def base_seed(self):
        return self._base_seed

    @property
    def dp_rank(self):
        return self._dp_rank

    @property
    def num_dp_groups(self):
        return self._num_dp_groups

    @property
    def num_files_per_group(self):
        return len(self._files) // self._num_dp_groups

    @property
    def num_samples_per_file(self):
        return self._num_samples_per_file

    @property
    def num_workers(self):
        return self._num_workers

    def __len__(self):
        """Samples one dp group sees per epoch."""
        return self._num_samples_per_file * self.num_files_per_group

    @property
    def epoch(self):
        return self._epoch

    @property
    def files_version(self):
        """Bumped whenever ``maybe_refresh`` changes the file set, so a
        process-worker pool knows to respawn."""
        return self._files_version

    def maybe_refresh(self):
        """Pick up newly published generations at an epoch boundary.

        A no-op without a ``refresh`` callable, when the published set is
        unchanged, or when this boundary already refreshed (``Binned``
        refreshes every bin up front). A new set must pass the checks of
        construction; a violation defers the pickup with a warning.
        Returns True when the file set changed. Never called mid-epoch."""
        if self._refresh is None:
            return False
        if self._refreshed_for == self._epoch + 1:
            return False
        self._refreshed_for = self._epoch + 1
        warn = self._logger.to("rank").warning
        refresh = self._refresh
        if hasattr(refresh, "set_epoch_key"):
            # One shared snapshot per boundary across every bin.
            refresh.set_epoch_key(self._epoch + 1)
        try:
            new_paths = sorted(refresh())
        except (OSError, ValueError, RuntimeError) as e:
            warn("generation refresh failed ({}: {}); keeping the current "
                 "file set".format(type(e).__name__, e))
            new_paths = None
        comm = self._comm or _SoloComm()
        if comm.world_size > 1 and not self._ranks_agree(comm, new_paths):
            # The agreement collective runs on every boundary, whatever
            # this rank saw, so the ranks' collectives stay in step.
            warn("generation refresh deferred: ranks observed different "
                 "published file sets; retrying next epoch")
            return False
        if new_paths is None:
            return False
        current = [f.path for f in self._files]
        if new_paths == current:
            return False
        if len(new_paths) % self._num_dp_groups != 0 or (
                len(new_paths) // self._num_dp_groups) % self._num_workers:
            warn("generation refresh deferred: {} files not divisible by "
                 "{} dp group(s) x {} worker(s); keeping the current "
                 "set".format(len(new_paths), self._num_dp_groups,
                              self._num_workers))
            return False
        files = self._census(new_paths, comm, on_error="sentinel")
        if any(f.num_samples < 0 for f in files):
            warn("generation refresh deferred (unreadable shard footer); "
                 "keeping the current file set")
            return False
        try:
            per_file = self._validate_counts(files)
        except ValueError as e:
            warn("generation refresh deferred ({}); keeping the current "
                 "file set".format(e))
            return False
        self._files = files
        self._num_samples_per_file = per_file
        self._files_version += 1
        if obs.enabled() or obs.fleet.enabled():
            obs.inc("loader_generation_refreshes_total")
            loaded, lag = None, None
            root = getattr(self._refresh, "root", None)
            if root is not None:
                from ..utils.fs import get_generation_of_path
                loaded = max(get_generation_of_path(root, f.path)
                             for f in self._files)
                obs.set_gauge("loader_generations_loaded", loaded + 1)
                gate = getattr(self._refresh, "last_gate", None)
                if gate is not None:
                    lag = gate - loaded
                    obs.set_gauge("loader_generation_lag", lag)
            obs.fleet.record("generation.pickup", files=len(self._files),
                             epoch=self._epoch + 1, loaded=loaded, lag=lag)
        self._logger.to("rank").info(
            "picked up new generation(s): {} -> {} files".format(
                len(current), len(self._files)))
        return True

    @staticmethod
    def _ranks_agree(comm, new_paths):
        """Agreement on the refreshed file set with a sum collective:
        every rank contributes a digest of its set, and the ranks agree
        iff the digests' variance is zero (world * sum(d^2) ==
        (sum d)^2). A failed refresh contributes a value outside the
        digest range."""
        import zlib
        digest = (1 << 28) if new_paths is None else (
            zlib.crc32("\n".join(new_paths).encode()) & 0xFFFFFFF)
        s1, s2 = comm.allreduce_sum([digest, digest * digest])
        return int(s2) * comm.world_size == int(s1) * int(s1)

    def advance_epoch(self):
        """Advance the epoch counter (no streams built) and return it;
        generations are picked up here, at the boundary."""
        self.maybe_refresh()
        self._epoch += 1
        return self._epoch

    def start_epoch(self):
        """Advance to the next epoch; returns per-worker sample streams.

        The file shuffle uses the world stream; this dp group takes
        ``files[dp_rank::num_dp_groups]`` and worker w every
        num_workers-th of those."""
        self.advance_epoch()
        group_files = self._epoch_group_files(self._epoch)
        return [self.worker_stream(self._epoch, w, _group_files=group_files)
                for w in range(self._num_workers)]

    def _epoch_group_files(self, epoch):
        world_g = lrng.world_rng(self._base_seed, epoch)
        files = list(self._files)
        lrng.shuffle(world_g, files)
        return files[self._dp_rank::self._num_dp_groups]

    def worker_stream(self, epoch, w, _group_files=None):
        """Worker ``w``'s sample stream of ``epoch``: a pure function of
        (files, base_seed, epoch, dp group, worker)."""
        group_files = (_group_files if _group_files is not None
                       else self._epoch_group_files(epoch))
        worker_files = group_files[w::self._num_workers]
        worker_g = lrng.worker_rng(self._base_seed, epoch, self._dp_rank,
                                   self._num_dp_groups, w, self._num_workers)
        return iter(ShuffleBuffer(
            worker_files,
            self._num_samples_per_file * len(worker_files),
            self._decode_record_batch,
            self._shuffle_buffer_size,
            self._shuffle_buffer_warmup_factor,
            worker_g,
            logger=self._logger,
        ))
