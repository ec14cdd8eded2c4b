"""SPMD load balancer: equalize per-shard sample counts to ±1.

The port's own copy of ``balance_shards`` and ``generate_num_samples_cache``
of ``lddl_tpu/balance/balancer.py`` over the port's ``Communicator``
(``parallel.distributed``), with its spans and counters: the same plan,
the same output contract (``shard-<i>.parquet[_<bin>]`` with every shard
holding ``base`` or ``base+1`` samples, plus ``.num_samples.json`` and
``.manifest.json``), so the port's output equals the reference's byte for
byte. The delta balancer of streaming ingest is ``balance/delta.py``.

Why balancing matters: the loader shards *files* across data-parallel
groups; equal per-file counts keep rank-sharded epochs from diverging.

Design: SPMD-replicated deterministic control flow. Every rank computes
the identical transfer plan over shard *metadata*; exactly one rank, the
transfer's owner, performs the parquet I/O for each transfer. Row
custody always lives on the shared filesystem: every mutation is
persisted by its owner, so any rank can own the next transfer touching
that shard after the per-iteration barrier. Communication is one
sum-allreduce (census) plus one barrier per iteration. Transfers move
exact ``min(surplus, deficit)`` amounts in one two-pointer sweep, and
all transfers out of one source shard are grouped into a single load.
"""

import os

import pyarrow as pa

from .. import observability as obs
from ..utils.comm import LocalCommunicator
from ..preprocess.binning import (DEFAULT_PARQUET_COMPRESSION,
                                  write_options_for_names)
from ..resilience.integrity import build_manifest
from ..utils.fs import (
    get_all_bin_ids,
    get_all_parquets_under,
    get_bin_id_of_path,
    get_file_paths_for_bin_id,
    get_num_samples_of_parquet,
    write_num_samples_cache,
)
from ..utils.io import read_table, write_table_atomic
from ..utils.types import File


class _Shard:
    """One output shard: the input Files still feeding it plus *part files*
    holding rows it has taken custody of. All ranks track the same
    metadata; only transfer owners move actual rows.

    Custody is write-once part files (``<out>.partK``, K a metadata-
    replicated sequence number): every store persists a FRESH file, never a
    read-modify-write — so two transfers owned by different ranks can land
    rows on the same destination within one barrier window without racing,
    and appending never re-reads accumulated rows. ``flush`` merges the
    remaining inputs + parts into the final shard file after the
    convergence barrier.

    ``stats`` (optional dict) accumulates the I/O the plan implies, in
    rows, identically on every rank (the plan is SPMD-replicated):
    ``rows_read`` counts source-file reads, ``rows_reread`` part-file
    drain re-reads, ``rows_written`` rows persisted (leftovers, landed
    transfers, and the final merge). A minimal pass costs total_rows read
    + total_rows written; everything above that is the balancing overhead
    being quantified."""

    def __init__(self, idx, input_files, out_dir, postfix="", stats=None):
        self.idx = idx
        self.input_files = list(input_files)
        self.out_path = os.path.join(
            out_dir, "shard-{}.parquet{}".format(idx, postfix))
        self.output_parts = []  # custody Files, deterministic paths
        self._part_seq = 0
        self.stats = stats

    def _count(self, key, n):
        if self.stats is not None:
            self.stats[key] = self.stats.get(key, 0) + int(n)

    @property
    def num_samples(self):
        return (sum(f.num_samples for f in self.input_files)
                + sum(f.num_samples for f in self.output_parts))

    def _store(self, num_samples, table=None):
        """Take custody of rows in a fresh part file. ``table`` is given
        only on the rank doing real I/O; all other ranks mirror the
        metadata (including the part sequence number)."""
        assert num_samples > 0
        path = "{}.part{}".format(self.out_path, self._part_seq)
        self._part_seq += 1
        self.output_parts.append(File(path, num_samples))
        self._count("rows_written", num_samples)
        if table is not None:
            assert table.num_rows == num_samples
            write_table_atomic(table, path,
                               compression=DEFAULT_PARQUET_COMPRESSION,
                               **write_options_for_names(table.schema.names))
            _count_bytes_rewritten(path)

    def _load(self, num_samples, with_table):
        """Remove rows, consuming input files from the end first, then
        custody parts. The leftover of a partially-consumed source becomes
        a fresh part (persisted immediately when ``with_table``)."""
        assert num_samples <= self.num_samples
        tables = [] if with_table else None
        while num_samples > 0:
            from_output = not self.input_files
            src = (self.output_parts.pop() if from_output
                   else self.input_files.pop())
            take = min(src.num_samples, num_samples)
            self._count("rows_reread" if from_output else "rows_read",
                        src.num_samples)
            src_table = None
            if with_table:
                src_table = read_table(src.path)
                assert src_table.num_rows == src.num_samples
                tables.append(src_table.slice(0, take))
            if take < src.num_samples:
                self._store(
                    src.num_samples - take,
                    table=src_table.slice(take) if with_table else None)
            if from_output and with_table:
                # The popped part is dead (its leftover, if any, moved to a
                # fresh part above): delete so stale rows cannot linger.
                os.remove(src.path)
            num_samples -= take
        if with_table:
            return pa.concat_tables(tables)
        return None

    def transfer_to_many(self, assignments, i_am_owner):
        """Move rows to several shards with ONE load of this shard:
        ``assignments`` is [(shard, num_samples), ...]. Grouping all
        transfers out of a source avoids re-reading its leftover once per
        destination (the dominant I/O cost when one giant file feeds many
        shards)."""
        total = sum(n for _, n in assignments)
        if i_am_owner:
            # Owner-side count: every rank mirrors the plan metadata, but
            # only the owner moves rows, so the counter is exact per
            # process in multi-rank layouts too.
            obs.inc("balance_samples_moved_total", total)
        table = self._load(total, with_table=i_am_owner)
        offset = 0
        for other, n in assignments:
            other._store(n, table=table.slice(offset, n) if i_am_owner
                         else None)
            offset += n

    def flush(self, i_am_owner):
        """Merge remaining input files + custody parts into the final
        shard file. Must run after a barrier so every part written by any
        owner is visible; every shard flushes exactly once."""
        inputs = [f for f in self.input_files if f.num_samples > 0]
        sources = inputs + self.output_parts
        self.input_files = []
        parts, self.output_parts = self.output_parts, []
        n = sum(f.num_samples for f in sources)
        assert n > 0, "shard {} would be empty".format(self.idx)
        self._count("rows_read", sum(f.num_samples for f in inputs))
        self._count("rows_reread", sum(f.num_samples for f in parts))
        self._count("rows_written", n)
        if i_am_owner:
            table = pa.concat_tables([read_table(f.path) for f in sources])
            assert table.num_rows == n
            write_table_atomic(table, self.out_path,
                               compression=DEFAULT_PARQUET_COMPRESSION,
                               **write_options_for_names(table.schema.names))
            _count_bytes_rewritten(self.out_path)
            for f in parts:
                os.remove(f.path)
        self.final_file = File(self.out_path, n)


def _count_bytes_rewritten(path):
    """Bytes this rank physically wrote while balancing (custody parts
    and final merges): the I/O cost the ``stats`` row counts only
    imply."""
    if not obs.enabled():
        return
    try:
        obs.inc("balance_bytes_rewritten_total", os.stat(path).st_size)
    except OSError:  # a telemetry-only stat must not fail the balance
        pass


def _census(file_paths, comm):
    """Per-file sample counts: rank-strided footer reads + sum-allreduce."""
    counts = [0] * len(file_paths)
    for i in range(comm.rank, len(file_paths), comm.world_size):
        counts[i] = get_num_samples_of_parquet(file_paths[i])
    counts = comm.allreduce_sum(counts)
    return [File(p, int(n)) for p, n in zip(file_paths, counts)]


def compute_targets(total, num_shards):
    """Per-shard target counts: base everywhere, +1 on the first
    ``total % num_shards`` shards."""
    base = total // num_shards
    num_plus_one = total - base * num_shards
    return [base + (1 if i < num_plus_one else 0) for i in range(num_shards)]


def _converge(shards, targets, comm):
    """Drive shards to exact targets via owner-striped transfers.

    One sweep suffices: surpluses and deficits sum to zero by construction,
    and the two-pointer walk pairs them off exactly, grouping every
    transfer out of one source shard into a single load. Deterministic SPMD
    control flow; the iteration bound is a safety net, not an expectation.
    Exposed separately so the plan can be property-tested metadata-only
    (no rank ever owning a transfer)."""
    group_idx = 0
    iterations = 0
    for _ in range(len(shards) + 2):
        large = [s for s in shards if s.num_samples > targets[s.idx]]
        small = [s for s in shards if s.num_samples < targets[s.idx]]
        if not large and not small:
            break
        iterations += 1
        large.sort(key=lambda s: s.num_samples - targets[s.idx], reverse=True)
        small.sort(key=lambda s: targets[s.idx] - s.num_samples, reverse=True)
        deficits = {s.idx: targets[s.idx] - s.num_samples for s in small}
        si = 0
        for ls in large:
            surplus = ls.num_samples - targets[ls.idx]
            assignments = []
            while surplus > 0 and si < len(small):
                ss = small[si]
                n = min(surplus, deficits[ss.idx])
                assignments.append((ss, n))
                surplus -= n
                deficits[ss.idx] -= n
                if deficits[ss.idx] == 0:
                    si += 1
            if assignments:
                ls.transfer_to_many(
                    assignments,
                    i_am_owner=(group_idx % comm.world_size == comm.rank))
                group_idx += 1
        comm.barrier()
    else:
        raise RuntimeError("balancer failed to converge")

    for s in shards:
        assert s.num_samples == targets[s.idx], (
            "shard {} has {} != target {}".format(
                s.idx, s.num_samples, targets[s.idx]))
    return iterations


def _balance_one_set(file_paths, out_dir, num_shards, comm, postfix="",
                     stats=None):
    """Balance one (possibly per-bin) file set into num_shards outputs."""
    files = _census(file_paths, comm)
    total = sum(f.num_samples for f in files)
    if total < num_shards:
        raise ValueError(
            "cannot balance {} samples into {} shards; every shard must "
            "receive at least one sample".format(total, num_shards))
    targets = compute_targets(total, num_shards)

    shards = [
        _Shard(i, files[i::num_shards], out_dir, postfix=postfix, stats=stats)
        for i in range(num_shards)
    ]
    _converge(shards, targets, comm)

    for s in shards:
        s.flush(i_am_owner=(s.idx % comm.world_size == comm.rank))
    comm.barrier()
    return {os.path.basename(s.out_path): int(s.final_file.num_samples)
            for s in shards}


def balance_shards(in_dir, out_dir, num_shards, comm=None, log=None,
                   stats=None):
    """Balance preprocessor output into ``num_shards`` equal shards (per bin
    when the input is binned). SPMD: call on every host with identical args.

    Returns {shard_basename: num_samples}; writes .num_samples.json.
    Pass ``stats={}`` to collect the plan's I/O cost in rows (see _Shard).
    """
    comm = comm or LocalCommunicator()
    log = log or (lambda msg: None)
    if num_shards < 1:
        raise ValueError("num_shards must be >= 1")
    # Top-level stage span.
    with obs.span("balance.run", rank=comm.rank, num_shards=num_shards):
        return _balance_shards_body(in_dir, out_dir, num_shards, comm, log,
                                    stats)


def _balance_shards_body(in_dir, out_dir, num_shards, comm, log, stats):
    if os.path.isdir(out_dir):
        stale = [n for n in sorted(os.listdir(out_dir)) if ".parquet" in n]
        if stale:
            raise ValueError(
                "output dir {} already contains {} shard files (e.g. {}); "
                "remove them or choose a fresh directory".format(
                    out_dir, len(stale), stale[0]))
    os.makedirs(out_dir, exist_ok=True)
    file_paths = get_all_parquets_under(in_dir)
    if not file_paths:
        raise ValueError("no parquet shards under {}".format(in_dir))
    bin_ids = get_all_bin_ids(file_paths)
    counts = {}
    if bin_ids:
        unbinned = [p for p in file_paths if get_bin_id_of_path(p) is None]
        if unbinned:
            raise ValueError(
                "input mixes binned and unbinned shards ({} unbinned, e.g. "
                "{}); balance them separately".format(
                    len(unbinned), os.path.basename(unbinned[0])))
        for b in bin_ids:
            bin_paths = get_file_paths_for_bin_id(file_paths, b)
            with obs.span("balance.bin", bin=b, files=len(bin_paths)):
                counts.update(
                    _balance_one_set(bin_paths, out_dir, num_shards, comm,
                                     postfix="_{}".format(b), stats=stats))
            log("balanced bin {}: {} files -> {} shards".format(
                b, len(bin_paths), num_shards))
    else:
        counts.update(_balance_one_set(file_paths, out_dir, num_shards, comm,
                                       stats=stats))
        log("balanced {} files -> {} shards".format(
            len(file_paths), num_shards))
    if stats is not None:
        log("balance I/O (rows): {}".format(
            {k: stats[k] for k in sorted(stats)}))
    if comm.rank == 0:
        write_num_samples_cache(out_dir, counts)
    comm.barrier()
    # Integrity manifest next to .num_samples.json: per-shard byte length
    # + CRC32, verified by the loader at startup (rank-strided checksums).
    build_manifest(out_dir, comm=comm, log=log)
    return counts


def generate_num_samples_cache(path, comm=None):
    """(Re)build .num_samples.json for a directory of parquet shards.
    """
    comm = comm or LocalCommunicator()
    file_paths = get_all_parquets_under(path)
    if not file_paths:
        raise ValueError("no parquet shards under {}".format(path))
    files = _census(file_paths, comm)
    counts = {os.path.basename(f.path): int(f.num_samples) for f in files}
    if comm.rank == 0:
        write_num_samples_cache(path, counts)
    comm.barrier()
    return counts
