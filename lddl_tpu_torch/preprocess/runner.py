"""Distributed preprocessing runner: the static schedule, and the hooks of
the elastic one.

Counterpart of ``lddl_tpu/preprocess/runner.py`` (``run_sharded_pipeline``,
``run_bert_preprocess``). On the static schedule every host plans the
identical block list, takes units by rank striding over the port's
``parallel.Communicator`` (``torch.distributed``, gloo on a CPU-only
cluster), and meets the others only at phase barriers. ``elastic=True``
hands the same units to the lease-fenced work-stealing claim loop of
:mod:`.steal` instead (independent hosts sharing only the output
directory). The global document shuffle is a two-pass, shared-filesystem
all-to-all over a two-level radix:

    phase 1 (scatter):  each writer (one per rank, or per pool worker)
                        reads its input blocks; every document goes to a
                        hash-assigned fine bucket (a deterministic hash of
                        (seed, block, doc position)), and is appended,
                        under a "#B <block> <bucket>" header, to the
                        COARSE group spool file this writer exclusively
                        owns: _shuffle/group-<bucket % G>/w<writer>.txt
                        (elastic: s<slice>.e<epoch>.<holder>.txt, one
                        file per claim attempt).
    phase 2 (gather):   workers own coarse groups by striding; each reads
                        its group's spool files once, splits per fine
                        bucket, restores the canonical per-bucket order
                        (block-id lex order), shuffles in-bucket,
                        tokenizes, builds pairs, masks, writes
                        part.<k>.parquet[_<bin>].

Completed units are journaled under ``_done/`` so ``resume=True`` redoes
only unfinished ones, behind a fingerprint of every argument that shapes
the output. Ledger records, spool appends and spool reads go through
``resilience/io`` (its retries and its ``open``/``read``/``replace``
fault sites), as the reference's do. The stages report the reference's
spans (``preprocess.run``, ``.scatter``, ``.gather``, ``.scatter_block``,
``.process_block``, ``.gather_group``) and counters (``preprocess_*``)
into ``observability``.
"""

import contextlib
import hashlib
import json
import logging
import os
import shutil
import time

from .. import observability as obs
from ..resilience import io as rio
from ..resilience.integrity import build_manifest
from ..utils import rng as lrng
from ..utils.io import atomic_write
from .bert import (
    BertPretrainConfig,
    TokenizerInfo,
    instances_from_texts,
    masked_instances_from_texts,
    materialize_columns,
    materialize_rows,
)
from .readers import discover_source_files, plan_blocks, read_documents
from . import binning as binning_mod
from . import sink as sink_mod

_SPOOL_DIR = "_shuffle"
_LEDGER_DIR = "_done"
_SCATTER_MARKER = ".scatter_done"

_log = logging.getLogger("lddl_tpu_torch.preprocess.runner")


class _Progress:
    """Throttled phase progress lines with ETA, so a long run is not a
    black box between barriers."""

    def __init__(self, log, phase, total, interval_s=5.0):
        self.log = log
        self.phase = phase
        self.total = total
        self.interval_s = interval_s
        self.done = 0
        self.samples = 0
        # Log-only rate/ETA meter; never reaches shard bytes or order.
        self.t0 = time.monotonic()
        self._last = 0.0

    def tick(self, samples=0, force=False):
        self.done += 1
        self.samples += samples
        now = time.monotonic()
        if not force and now - self._last < self.interval_s \
                and self.done < self.total:
            return
        self._last = now
        elapsed = now - self.t0
        rate = self.done / elapsed if elapsed > 0 else 0.0
        eta = (self.total - self.done) / rate if rate > 0 else float("inf")
        msg = "{}: {}/{} units in {:.0f}s (eta {:.0f}s)".format(
            self.phase, self.done, self.total, elapsed, eta)
        if self.samples:
            msg += ", {} samples".format(self.samples)
        self.log(msg)


def _run_units(fn, units, pool_factory, log, phase, retry_deaths=True,
               max_rounds=3, progress_interval=5.0, on_result=None,
               writer=None):
    """Run ``fn(unit) -> result`` over all units, serially or on a process
    pool, with per-unit fault isolation: a unit whose task raises is
    recorded as failed (others continue). A worker process dying (OOM
    killer, preemption) breaks the whole pool; when ``retry_deaths``, the
    pool is rebuilt and every unfinished unit resubmitted — a break names
    no culprit, so collateral units are NOT charged an attempt. After
    ``max_rounds`` pool-wide rounds the survivors run one-by-one in fresh
    single-worker pools (exact attribution: a unit that breaks its solo
    pool is the culprit and fails; innocents complete). ``on_result`` is
    called as each unit finishes (journal hook — survives a later crash).

    ``writer`` (serial path only): a :class:`sink.ShardWriter` the unit
    functions defer their durable writes to. A unit returning
    ``sink.DeferredUnit`` completes asynchronously — its result (or
    failure) is collected from the writer at the next unit boundary and
    at the final drain, and ``on_result`` (the ledger journal) fires only
    then, i.e. only after that unit's writes actually hit stable storage.
    This is the cross-unit double buffer: unit N's parquet encode + fsync
    + publish overlap unit N+1's read/tokenize/mask.
    Returns ({unit: result}, {unit: error_string})."""
    import concurrent.futures as cf
    from concurrent.futures.process import BrokenProcessPool

    progress = _Progress(log, phase, len(units), interval_s=progress_interval)
    results, failures = {}, {}

    def record(u, res):
        results[u] = res
        if on_result is not None:
            on_result(u, res)
        progress.tick(sum(res.values()) if isinstance(res, dict) else 0)

    def record_failure(u, msg):
        failures[u] = msg
        progress.tick()

    if pool_factory is None:
        def safe_record(u, res):
            # Per-unit isolation extends to the journal hook itself: an
            # on_result failure (e.g. persistent EIO on the ledger dir)
            # fails THAT unit, never the whole phase.
            try:
                record(u, res)
            except Exception as e:  # noqa: BLE001 - isolate per unit
                record_failure(u, "{}: {}".format(type(e).__name__, e))

        for u in units:
            if writer is not None:
                # Collect (and journal) units whose deferred writes have
                # finished while this thread was computing later units.
                sink_mod.collect_into(writer.completed(), safe_record,
                                      record_failure)
            try:
                res = fn(u)
                if isinstance(res, sink_mod.DeferredUnit):
                    continue  # completes at a later collect / final drain
                record(u, res)
            except Exception as e:  # noqa: BLE001 - isolate per unit
                record_failure(u, "{}: {}".format(type(e).__name__, e))
        if writer is not None:
            sink_mod.collect_into(writer.drain(), safe_record,
                                  record_failure)
        return results, failures

    pending = list(units)
    rounds = 0
    pool = pool_factory()
    try:
        while pending and rounds < max_rounds:
            rounds += 1
            futures = {pool.submit(fn, u): u for u in pending}
            pending = []
            broken = False
            for fut in cf.as_completed(futures):
                u = futures[fut]
                try:
                    record(u, fut.result())
                except BrokenProcessPool:
                    broken = True
                    if retry_deaths:
                        pending.append(u)
                    else:
                        record_failure(u, "worker process died")
                except Exception as e:  # noqa: BLE001
                    record_failure(u, "{}: {}".format(type(e).__name__, e))
            if broken and pending:
                log("{}: worker died; rebuilding pool, retrying {} "
                    "unit(s)".format(phase, len(pending)))
                pool.shutdown(wait=False)
                pool = pool_factory()
        if pending:  # repeated breaks: exact attribution, one unit at a time
            log("{}: repeated worker deaths; isolating {} unit(s)".format(
                phase, len(pending)))
            pool.shutdown(wait=False)
            pool = None
            for u in pending:
                solo = pool_factory(max_workers=1)
                try:
                    record(u, solo.submit(fn, u).result())
                except BrokenProcessPool:
                    record_failure(u, "worker process died (isolated)")
                except Exception as e:  # noqa: BLE001
                    record_failure(u, "{}: {}".format(type(e).__name__, e))
                finally:
                    solo.shutdown(wait=False)
    finally:
        if pool is not None:
            pool.shutdown()
    return results, failures


def _ledger_path(out_dir, group):
    return os.path.join(out_dir, _LEDGER_DIR, "group-{}.json".format(group))


def _check_resume_manifest(out_dir, fingerprint, resume, rank):
    """Stamp the run arguments that define unit identity into the ledger
    dir; a resume with a different fingerprint would silently mix units
    from two incompatible plans (ledger ids denote different bucket sets,
    stale part files survive the skipped dirty-dir guard), so refuse."""
    path = os.path.join(out_dir, _LEDGER_DIR, "manifest.json")
    if resume and os.path.exists(path):
        with open(path) as f:
            prior = json.load(f)
        if prior != fingerprint:
            raise ValueError(
                "resume fingerprint mismatch: this run was started with "
                "{} but resume got {}; re-run with the original arguments "
                "or start a fresh output dir".format(prior, fingerprint))
    elif rank == 0:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        atomic_write(path, json.dumps(fingerprint))


def _ledger_write(out_dir, group, written):
    """Durable atomic per-group completion record: a crash between
    part-file writes and the ledger write just redoes the group, and a
    crash right after the write can never publish a torn ledger that a
    resume would half-trust."""
    path = _ledger_path(out_dir, group)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    atomic_write(path, json.dumps(written))


def _ledger_read(out_dir, group):
    """One group's completion record, or None when the unit is not done.

    Reads ride ``resilience.io.read_json`` (transient EIO/ESTALE on a
    shared mount retries instead of reading as "not done" and redoing a
    finished unit). A torn or unparseable record (atomic writes leave
    none, but flaky storage may serve torn bytes) degrades to "not done"
    with a warning: the unit is redone."""
    path = _ledger_path(out_dir, group)
    rec, status = rio.read_json(path)
    if status == "torn":
        _log.warning("torn/unparseable ledger record %s (%d bytes); "
                     "treating unit as not done (it will be redone)",
                     path, len(rec))
        return None
    return rec


def _canonical_paths(corpus_paths):
    """``discover_source_files``'s {name: path} dict with every path
    absolutized (normpath+abspath, NO symlink resolution: realpath would
    diverge across hosts whose automounters resolve the same logical
    path differently, spuriously refusing a multi-host resume).
    Explicit file lists (the ingest service's form) canonicalize as the
    sorted absolutized list."""
    def canon(v):
        if isinstance(v, str):
            return os.path.abspath(v)
        if isinstance(v, (list, tuple)):
            return sorted(os.path.abspath(str(p)) for p in v)
        return str(v)

    return {k: canon(v) for k, v in sorted(corpus_paths.items())}


def splitter_digest(splitter_params):
    """One digest rule for learned splitter params in resume fingerprints
    (BERT and BART must invalidate identically on a splitter change)."""
    if splitter_params is None:
        return "none"
    return hashlib.sha256(splitter_params.serialize()).hexdigest()[:16]


def processor_fingerprint(*fields):
    """Shared digest skeleton for processor resume fingerprints: joins the
    stringified fields (dataclass configs serialize as sorted json) and
    hashes. One implementation so BERT/BART digests cannot drift."""
    import dataclasses

    def canon(f):
        if dataclasses.is_dataclass(f) and not isinstance(f, type):
            return json.dumps(dataclasses.asdict(f), sort_keys=True,
                              default=str)
        return str(f)

    return hashlib.sha256(
        "|".join(canon(f) for f in fields).encode()).hexdigest()[:16]


def _num_spool_groups(nbuckets):
    """Default coarse-group count: enough groups for gather parallelism,
    few enough that spool files stay O(groups x writers)."""
    return min(nbuckets, max(64, nbuckets // 8))


def _group_of_bucket(bucket, ngroups):
    return bucket % ngroups


def _buckets_of_group(group, nbuckets, ngroups):
    return range(group, nbuckets, ngroups)


def _spool_one_block(block, out_dir, seed, sample_ratio, nbuckets, ngroups,
                     spool_name):
    """Scatter one input block: every document goes to a hash-assigned
    fine bucket and is appended, per coarse group, to THIS writer's
    exclusive spool file ``_shuffle/group-<g>/<spool_name>``
    (``w<rank>-<pid>.txt`` on the static schedule; the elastic one names
    files per claim attempt, ``s<slice>.e<epoch>.<holder>.txt``, so a
    reclaimed unit's debris is sweepable and a zombie's late appends are
    fenced out by name). A "#B <block> <bucket>" header line
    precedes each run of document lines (written as " " + text), so the
    gather pays no per-line field parsing."""
    with obs.span("preprocess.scatter_block", block=block.block_id):
        _spool_one_block_inner(block, out_dir, seed, sample_ratio, nbuckets,
                               ngroups, spool_name)


def _spool_one_block_inner(block, out_dir, seed, sample_ratio, nbuckets,
                           ngroups, spool_name):
    import numpy as np
    buf, text_starts, text_ends = _scan_block_documents(
        block, sample_ratio, seed)
    n = len(text_starts)
    obs.inc("preprocess_docs_total", n)
    obs.inc("preprocess_doc_bytes_total",
            int((text_ends - text_starts).sum()))
    if not n:
        return
    # Bucket of document o: blake2b("{seed}:{block_id}:{o}") (8 bytes,
    # little-endian) mod nbuckets, the reference's frozen assignment; one
    # hasher fed the common prefix, copied per ordinal.
    base = hashlib.blake2b(
        "{}:{}:".format(seed, block.block_id).encode(), digest_size=8)
    buckets = np.empty(n, dtype=np.int64)
    for o in range(n):
        h = base.copy()
        h.update(str(o).encode())
        buckets[o] = int.from_bytes(h.digest(), "little") % nbuckets
    # Vectorized scatter: one stable lexsort orders the documents by
    # (group, bucket, ordinal), then each group's spool bytes are built
    # with one gather/scatter over the block buffer. Raw bytes end to end
    # (see readers.read_block_lines): document bytes are copied exactly
    # as read, never decoded.
    from .arrowcols import concat_aranges
    groups = buckets % ngroups
    order = np.lexsort((buckets, groups))
    src = np.frombuffer(buf, dtype=np.uint8)
    g_sorted = groups[order]
    g_bounds = np.flatnonzero(np.diff(g_sorted)) + 1
    spool_root = os.path.join(out_dir, _SPOOL_DIR)
    for g_lo, g_hi in zip(np.r_[0, g_bounds],
                          np.r_[g_bounds, len(order)]):
        sel = order[g_lo:g_hi]
        group_dir = os.path.join(
            spool_root, "group-{}".format(int(g_sorted[g_lo])))
        os.makedirs(group_dir, exist_ok=True)
        b_sel = buckets[sel]
        run_starts = np.r_[0, np.flatnonzero(np.diff(b_sel)) + 1]
        headers = ["#B {} {}\n".format(block.block_id,
                                       int(b_sel[s])).encode()
                   for s in run_starts]
        dlen = (text_ends[sel] - text_starts[sel]).astype(np.int64)
        rec = dlen + 2  # b" " + doc + b"\n"
        extra = np.zeros(len(sel), dtype=np.int64)
        extra[run_starts] = [len(h) for h in headers]
        rec_start = np.cumsum(extra + rec) - rec  # the space byte
        out = np.empty(int(rec_start[-1] + rec[-1]), dtype=np.uint8)
        for hb, s in zip(headers, run_starts):
            p = int(rec_start[s]) - len(hb)
            out[p:p + len(hb)] = np.frombuffer(hb, dtype=np.uint8)
        out[rec_start] = 0x20
        out[rec_start + 1 + dlen] = 0x0A
        dst = np.repeat(rec_start + 1, dlen) + concat_aranges(dlen)
        gat = np.repeat(text_starts[sel], dlen) + concat_aranges(dlen)
        out[dst] = src[gat]
        # Guarded append (fault site "open"): only the open retries; a
        # half-applied append is handled at the unit level (the unmarked
        # spool is wiped and redone on resume).
        with rio.open_append(os.path.join(group_dir, spool_name)) as f:
            f.write(memoryview(out))


_WS_TABLE = None  # ASCII whitespace membership (bytes.split(None) set)


def _scan_block_documents(block, sample_ratio, base_seed):
    """Vectorized replay of ``readers.read_documents`` for the scatter:
    returns (buffer, text_starts, text_ends) where document i's text bytes
    are ``buffer[text_starts[i]:text_ends[i]]`` — same documents, same
    order, same per-line sample draws (one bulk ``g.random(n)`` consumes
    the stream exactly like n scalar draws), but the line split, the
    blank-line filter and the '<doc id> <text>' parse all run as numpy
    scans instead of per-line Python."""
    import numpy as np
    global _WS_TABLE
    if _WS_TABLE is None:
        table = np.zeros(256, dtype=bool)
        table[[9, 10, 11, 12, 13, 32]] = True  # bytes.strip()/split(None)
        _WS_TABLE = table
    with open(block.path, "rb") as f:
        if block.start == 0:
            f.seek(0)
        else:
            f.seek(block.start - 1)
            # If the previous byte is not a newline, our start is
            # mid-line: that line belongs to the previous block.
            prev = f.read(1)
            if prev != b"\n":
                f.readline()
        pos0 = f.tell()
        if pos0 >= block.end:
            z = np.zeros(0, dtype=np.int64)
            return b"", z, z
        data = f.read(block.end - pos0)
        # A line that STARTS inside the block is owned whole: complete a
        # truncated tail line from beyond the block boundary.
        if data and not data.endswith(b"\n"):
            data += f.readline()
    if not data:
        z = np.zeros(0, dtype=np.int64)
        return b"", z, z
    arr = np.frombuffer(data, dtype=np.uint8)
    n = len(arr)
    is_ws = _WS_TABLE[arr]
    # ONE nonzero pass: newlines are whitespace (0x0A is in _WS_TABLE),
    # so the line scan is a cheap sub-select of the word scan instead of
    # a second full-buffer np.nonzero (this pair was a profile-top-5
    # hotspot: two O(n) scans per block where one suffices).
    ws_pos = np.flatnonzero(is_ws)  # ~one per word; cheap to search
    nl = ws_pos[arr[ws_pos] == 0x0A]
    nlines = len(nl) + (0 if (len(nl) and nl[-1] == n - 1) else 1)
    line_starts = np.zeros(nlines, dtype=np.int64)
    line_starts[1:] = nl[:nlines - 1] + 1
    line_ends = np.empty(nlines, dtype=np.int64)
    line_ends[:len(nl)] = nl[:nlines]
    if nlines > len(nl):
        line_ends[-1] = n
    # id_start: first non-ws byte of the line. Fast path — the line
    # starts with its doc id (no leading whitespace); the rare
    # leading-ws/blank lines walk forward in Python.
    id_start = line_starts.copy()
    odd = np.flatnonzero(is_ws[np.minimum(line_starts, n - 1)]
                         | (line_starts >= line_ends))
    blank = np.zeros(nlines, dtype=bool)
    for li in odd:
        j = int(line_starts[li])
        e = int(line_ends[li])
        while j < e and is_ws[j]:
            j += 1
        if j >= e:
            blank[li] = True  # `not line.strip()`
        else:
            id_start[li] = j
    id_start = id_start[~blank]
    nb_ends = line_ends[~blank]
    # Per-line sample draw (only non-blank lines draw, as in the scalar
    # path; a kept draw may still yield no document — one bulk
    # ``g.random(n)`` consumes the stream exactly like n scalar draws).
    if sample_ratio < 1.0:
        g = lrng.sample_rng(base_seed, block.block_id)
        kept = g.random(len(id_start)) < sample_ratio
        id_start = id_start[kept]
        nb_ends = nb_ends[kept]
    # '<doc id> <text...>': text starts at the first non-ws after the
    # first ws-run following the id token; lines with no text drop.
    # First ws at/after id_start via ONE searchsorted over ws positions.
    if len(ws_pos):
        j = np.searchsorted(ws_pos, id_start)
        ws_after = np.where(
            j < len(ws_pos), ws_pos[np.minimum(j, len(ws_pos) - 1)], n)
    else:
        ws_after = np.full(len(id_start), n, dtype=np.int64)
    has_sep = ws_after < nb_ends
    # Fast path: a single separator byte (text at ws_after + 1); rare
    # multi-ws separators walk forward in Python.
    probe = np.minimum(ws_after + 1, n - 1)
    multi = np.flatnonzero(has_sep & is_ws[probe])
    text_start = np.where(has_sep, np.minimum(ws_after + 1, n), nb_ends)
    for li in multi:
        j2 = int(text_start[li])
        e = int(nb_ends[li])
        while j2 < e and is_ws[j2]:
            j2 += 1
        text_start[li] = j2
    has_text = has_sep & (text_start < nb_ends)
    return data, text_start[has_text], nb_ends[has_text]


def _read_group_texts(out_dir, group, nbuckets, ngroups, accept=None):
    """Read one coarse spool group once; return {bucket: DocSpans} — a
    ZERO-COPY view per bucket over the group's merged spool bytes (each
    document is a (start, end) range; the native engine reads the buffer
    in place). Each bucket's documents come in canonical order: blocks
    sorted by block id as a STRING, the reference's order, so shard bytes
    equal the reference's. Within a block, scatter wrote lines in document order under one "#B" header in one
    writer's file, so collecting per (bucket, block) and walking blocks in
    sorted order preserves it regardless of how blocks were dealt to
    writers.

    The line parse is vectorized: newline offsets come from one numpy
    scan, per-line Python happens only at "#B" headers (one per
    (block, bucket) run, not per document).

    ``accept``: optional collection of exact file names to read, the
    elastic scheduler's epoch fence: only the spool files named by each
    scatter unit's completion record (the winning (epoch, holder)
    attempt) are trusted; a fenced-off zombie's late appends land in
    files this set never names."""
    import numpy as np
    from .readers import DocSpans
    group_dir = os.path.join(out_dir, _SPOOL_DIR, "group-{}".format(group))
    empty = np.zeros(0, dtype=np.int64)
    by_bucket = {b: {} for b in _buckets_of_group(group, nbuckets, ngroups)}
    if not os.path.isdir(group_dir):
        return {b: DocSpans(b"", empty, empty) for b in by_bucket}
    # Merge the group's spool files into ONE buffer (guarded reads:
    # transient EIO/ESTALE on the shared spool retries). Every writer
    # terminates every line, but a crashed writer may leave a torn tail —
    # reinsert the newline so file boundaries never fuse lines.
    datas = []
    for name in sorted(os.listdir(group_dir)):
        if accept is not None and name not in accept:
            continue
        data = rio.read_bytes(os.path.join(group_dir, name))
        if data and not data.endswith(b"\n"):
            data += b"\n"
        datas.append(data)
    blob = b"".join(datas)
    del datas
    if not blob:
        return {b: DocSpans(blob, empty, empty) for b in by_bucket}
    arr = np.frombuffer(blob, dtype=np.uint8)
    nl = np.flatnonzero(arr == 0x0A)
    if not len(nl):  # unreachable (files are newline-terminated above)
        return {b: DocSpans(blob, empty, empty) for b in by_bucket}
    line_starts = np.empty(len(nl), dtype=np.int64)
    line_starts[0] = 0
    line_starts[1:] = nl[:-1] + 1
    line_ends = nl.astype(np.int64)  # exclusive of the newline
    # Header lines start with '#'; documents were written as b" " + text.
    # Only an exact b"#B " prefix is a header (anything else starting '#'
    # is document text, as in the per-line parser this replaces).
    hdr_idx = np.flatnonzero(arr[line_starts] == 0x23)
    runs = []  # (bucket, block_key, first_doc_line, end_doc_line)
    for pos, h in enumerate(hdr_idx):
        s, e = int(line_starts[h]), int(line_ends[h])
        line = blob[s:e]
        bucket = None
        if line.startswith(b"#B "):
            hdr = line.split()
            if len(hdr) == 3:
                try:
                    bucket = int(hdr[2].decode())
                except ValueError:
                    bucket = None
        nxt = (int(hdr_idx[pos + 1]) if pos + 1 < len(hdr_idx)
               else len(line_starts))
        if bucket in by_bucket:
            runs.append((bucket, hdr[1], int(h) + 1, nxt))
    for bucket, block_key, lo, hi in runs:
        starts = line_starts[lo:hi] + 1  # skip the leading b" "
        ends = line_ends[lo:hi]
        keep = ends > starts  # empty documents are dropped, as before
        by_bucket[bucket].setdefault(block_key, []).append(
            (starts[keep], ends[keep]))
    out = {}
    for b, blocks in by_bucket.items():
        if not blocks:
            out[b] = DocSpans(blob, empty, empty)
            continue
        parts = [p for _, chunks in sorted(blocks.items()) for p in chunks]
        out[b] = DocSpans(blob,
                          np.concatenate([p[0] for p in parts]),
                          np.concatenate([p[1] for p in parts]))
    return out


class BertBucketProcessor:
    """Picklable per-bucket BERT pipeline stage: shuffle -> instances ->
    materialize -> shard sink. Pickles the vocab table; the TokenizerInfo
    tables and native engine are rebuilt lazily once per process."""

    def __init__(self, tokenizer, config, seed, out_dir, bin_size,
                 output_format, splitter_params=None, pack_seq_length=None,
                 pack_max_per_row=8):
        self.tokenizer = tokenizer
        self.config = config
        self.seed = seed
        self.out_dir = out_dir
        self.bin_size = bin_size
        self.output_format = output_format
        self.splitter_params = splitter_params  # picklable SplitterParams
        self.pack_seq_length = pack_seq_length  # offline FFD sink budget
        self.pack_max_per_row = pack_max_per_row
        self._tok_info = None

    def __getstate__(self):
        state = self.__dict__.copy()
        state["_tok_info"] = None  # rebuilt per process
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)

    @property
    def tok_info(self):
        if self._tok_info is None:
            self._tok_info = TokenizerInfo(self.tokenizer)
        return self._tok_info

    def fingerprint(self):
        """Digest of everything that shapes this processor's output bytes,
        for the resume manifest: resuming with a different vocab, seed,
        bin width, masking config or sink format would silently mix shards
        from two incompatible runs."""
        # The digest hashes the id->token table the pipeline actually
        # tokenizes with, so any vocab difference changes it.
        vocab = self.tok_info.vocab_digest
        # schema_version leaves the digest when 1, as in the reference.
        import dataclasses
        cfg = dataclasses.asdict(self.config)
        if cfg.get("schema_version") == 1:
            del cfg["schema_version"]
        # The torch masks are bit-identical on every device: a run may
        # resume on another one.
        del cfg["device"]
        cfg = json.dumps(cfg, sort_keys=True, default=str)
        fields = [type(self).__name__, vocab, cfg, self.seed, self.bin_size,
                  self.output_format, splitter_digest(self.splitter_params),
                  "codec=" + binning_mod.DEFAULT_PARQUET_COMPRESSION]
        if (self.config.schema_version == 2
                and self.output_format == "parquet"):
            # The id-columnar (v2/packed) shards use the tuned parquet
            # layout (binning.SINK_PROFILE_V2).
            fields.append("v2sink=" + binning_mod.SINK_PROFILE_V2)
        if self.pack_seq_length is not None:
            fields.append("pack={}x{}".format(self.pack_seq_length,
                                              self.pack_max_per_row))
        return processor_fingerprint(*fields)

    def prepare(self, texts, bucket):
        """Compute phase of the two-phase sink protocol: shuffle ->
        instances -> masking -> columns, all producer-side; returns a
        zero-argument *deferred publish closure* that performs only the
        durable write (sink.ShardWriter executes it on the writer
        thread, pipelined against the next bucket's compute, or the pool
        worker calls it at once)."""
        config, seed = self.config, self.seed
        g = lrng.sample_rng(seed, 0x9A1A, bucket)
        lrng.shuffle(g, texts)
        if self.output_format == "txt":
            batch = instances_from_texts(
                texts, self.tok_info, config, seed, bucket,
                splitter_params=self.splitter_params)
            rows = materialize_rows(batch, config, self.tok_info, seed,
                                    (0x3A5C, bucket))
            return lambda: _write_txt_shard(rows, self.out_dir, bucket,
                                            config.masking, self.bin_size,
                                            config.max_seq_length)
        batch = None
        if config.masking:
            # Fused-masked kernel: split + WordPiece + NSP + shuffle + the
            # Philox masking replay in ONE native call. None = outside
            # its contract (the torch engine, whole-word masking).
            batch = masked_instances_from_texts(
                texts, self.tok_info, config, seed, bucket, (0x3A5C, bucket),
                splitter_params=self.splitter_params)
        if batch is None:
            batch = instances_from_texts(
                texts, self.tok_info, config, seed, bucket,
                splitter_params=self.splitter_params)
        columns, n = materialize_columns(batch, config, self.tok_info, seed,
                                         (0x3A5C, bucket))
        if obs.enabled() and "num_tokens" in columns:
            obs.inc("preprocess_tokens_total",
                    int(sum(int(t) for t in columns["num_tokens"])))
        out_dir, bin_size = self.out_dir, self.bin_size
        pack_seq_length = self.pack_seq_length
        pack_max_per_row = self.pack_max_per_row
        pack_special_ids = ((self.tok_info.cls_id, self.tok_info.sep_id)
                            if pack_seq_length is not None else None)

        def publish():
            return binning_mod.write_shard_columns(
                columns, n, out_dir, bucket, masking=config.masking,
                bin_size=bin_size,
                target_seq_length=config.max_seq_length,
                pack_seq_length=pack_seq_length,
                pack_max_per_row=pack_max_per_row,
                pack_special_ids=pack_special_ids)

        return publish


def _write_txt_shard(rows, out_dir, part_id, masking, bin_size,
                     target_seq_length):
    """Human-readable debug sink."""
    from ..utils.fs import deserialize_np_array
    os.makedirs(out_dir, exist_ok=True)

    def fmt(r):
        if masking:
            return ("is_random_next: {} - [CLS] {} [SEP] {} [SEP] - "
                    "masked_lm_positions: {} - masked_lm_labels: {} - {}".format(
                        r["is_random_next"], r["A"], r["B"],
                        deserialize_np_array(r["masked_lm_positions"]).tolist(),
                        r["masked_lm_labels"], r["num_tokens"]))
        return "is_random_next: {} - [CLS] {} [SEP] {} [SEP] - {}".format(
            r["is_random_next"], r["A"], r["B"], r["num_tokens"])

    written = {}
    if bin_size is None:
        path = os.path.join(out_dir, "{}.txt".format(part_id))
        atomic_write(path, "".join(fmt(r) + "\n" for r in rows))
        written[path] = len(rows)
        return written
    nbins = binning_mod.num_bins(target_seq_length, bin_size)
    by_bin = {}
    for r in rows:
        b = binning_mod.bin_id_of_num_tokens(r["num_tokens"], bin_size, nbins)
        by_bin.setdefault(b, []).append(r)
    for b, bin_rows in sorted(by_bin.items()):
        path = os.path.join(out_dir, "{}.txt_{}".format(part_id, b))
        atomic_write(path, "".join(fmt(r) + "\n" for r in bin_rows))
        written[path] = len(bin_rows)
    return written


# Worker-process globals for the intra-host pool (set by _pool_init).
_POOL = {}


def _pool_init(process_bucket, spec):
    _POOL["process_bucket"] = process_bucket
    _POOL["spec"] = spec


def _run_block_bucket(spec, process_bucket, bucket, fence=None, writer=None):
    """No-global-shuffle unit: bucket == block; re-read the block directly
    (texts never cross the process boundary). ``fence`` (elastic mode):
    checked after the read and again before the write; a holder whose
    lease was stolen self-terminates instead of publishing. ``writer``
    (static serial path): the unit's durable write is deferred onto the
    shard-writer thread and the unit completes (and journals) when it
    drains."""
    input_files = discover_source_files(spec["corpus_paths"])
    blocks = plan_blocks(input_files, spec["num_blocks"])
    texts = [text for _, text in read_documents(
        blocks[bucket], sample_ratio=spec["sample_ratio"],
        base_seed=spec["seed"])]
    if spec.get("clean_first"):
        _clean_bucket_outputs(spec["out_dir"], bucket)
    _check_fence(fence, bucket)
    with obs.span("preprocess.process_block", bucket=bucket):
        publish = _publish_task(process_bucket.prepare(texts, bucket),
                                bucket)
    if writer is not None:
        writer.submit(bucket, publish, fence=fence)
        writer.end_unit(bucket)
        return sink_mod.DeferredUnit(bucket)
    _check_fence(fence, bucket)
    return publish()


def _check_fence(fence, unit):
    """Raise LeaseLost when an elastic unit's lease was stolen mid-run.
    Placed between a unit's read step and its writes: once a steal has
    happened, anything read afterwards may be swept or finalized away
    concurrently, so the loser must never publish bytes derived from it
    (the claim loop turns the raise into a fence reject)."""
    if fence is not None and not fence():
        from ..resilience.leases import LeaseLost
        raise LeaseLost(
            "unit {} was stolen mid-run; self-terminating".format(unit))


def _pool_run_block_bucket(bucket):
    return _run_block_bucket(_POOL["spec"], _POOL["process_bucket"], bucket)


def _clean_bucket_outputs(out_dir, bucket):
    """Remove partial part/txt files a crashed attempt may have left for
    this bucket (resume-safety; exact-prefix globs cannot cross buckets)."""
    import glob
    for pattern in ("part.{}.parquet*".format(bucket),
                    "{}.txt*".format(bucket)):
        for path in sorted(glob.glob(os.path.join(out_dir, pattern))):
            os.remove(path)


def _record_bucket_written(written):
    """Per-bin sample accounting of one processed bucket: a counter per
    bin (parsed off the part-file suffix) and a histogram of bucket
    sizes (skew visibility)."""
    if not obs.enabled() or not isinstance(written, dict):
        return
    from ..utils.fs import get_bin_id_of_path
    total = 0
    for path, n in written.items():
        b = get_bin_id_of_path(path)
        obs.inc("preprocess_shards_total", bin="none" if b is None else b)
        obs.inc("preprocess_samples_total", n,
                bin="none" if b is None else b)
        total += n
    obs.observe("preprocess_bucket_samples", total)


def _publish_task(publish, bucket):
    """Wrap a processor's deferred publish with the per-bucket sample
    accounting (it runs on the writer thread; obs is thread-safe)."""
    def task():
        written = publish()
        _record_bucket_written(written)
        return written
    return task


def _run_group(spec, process_bucket, group, fence=None, writer=None):
    """Gather unit: read one coarse spool group, process each fine bucket.
    ``fence`` (elastic mode) is checked after the spool read and before
    every bucket's compute, and re-checked by the shard writer right
    before every deferred publish (see `_check_fence` and
    sink.ShardWriter). With a ``writer`` (the static serial path) the
    writes are deferred ACROSS units and the call returns
    ``sink.DeferredUnit``; otherwise (pool workers, the elastic claim
    loop) an own writer pipelines the buckets WITHIN the unit and drains
    before returning, so the unit's result, and the journal record
    derived from it, strictly follows its bytes."""
    with obs.span("preprocess.gather_group", group=group):
        texts_by_bucket = _read_group_texts(
            spec["out_dir"], group, spec["nbuckets"], spec["ngroups"],
            accept=spec.get("spool_accept"))
        own = writer is None
        w = sink_mod.ShardWriter() if own else writer
        try:
            for bucket in sorted(texts_by_bucket):
                if spec.get("clean_first"):
                    _clean_bucket_outputs(spec["out_dir"], bucket)
                _check_fence(fence, group)
                publish = process_bucket.prepare(texts_by_bucket[bucket],
                                                 bucket)
                w.submit(group, _publish_task(publish, bucket), fence=fence)
            w.end_unit(group)
            if not own:
                return sink_mod.DeferredUnit(group)
            done = w.drain()
        finally:
            if own:
                w.close()
        _, written, exc = done[0]
        if exc is not None:
            raise exc  # LeaseLost included: the claim loop fences the unit
    return written


def _pool_run_group(group):
    return _run_group(_POOL["spec"], _POOL["process_bucket"], group)


def _pool_scatter_block(block_id):
    spec = _POOL["spec"]
    input_files = discover_source_files(spec["corpus_paths"])
    blocks = plan_blocks(input_files, spec["num_blocks"])
    _spool_one_block(blocks[block_id], spec["out_dir"], spec["seed"],
                     spec["sample_ratio"], len(blocks), spec["ngroups"],
                     "w{}-{}.txt".format(spec["rank"], os.getpid()))
    return block_id


def run_sharded_pipeline(
    corpus_paths,
    out_dir,
    process_bucket,
    num_blocks=64,
    sample_ratio=0.9,
    seed=12345,
    global_shuffle=True,
    comm=None,
    log=None,
    num_workers=1,
    spool_groups=None,
    resume=False,
    progress_interval=5.0,
    elastic=False,
    lease_ttl=30.0,
    holder_id=None,
    scatter_units=None,
    emit_manifest=True,
):
    """Generic SPMD scaffolding shared by the preprocessors: dirty-dir
    guard -> block planning -> (optional) scatter shuffle -> strided
    bucket processing via ``process_bucket.prepare(texts, bucket)`` (a
    deferred publish returning ``{path: n}``) -> manifest, cleanup and
    reduced totals. ``spool_groups`` overrides the coarse radix width
    (default min(nblocks, max(64, nblocks // 8))).
    ``emit_manifest=False`` skips the integrity manifest (the ingest
    service's work-dir part files are consumed by its delta balancer,
    which writes the published manifests).

    ``elastic=True`` replaces the static rank->unit schedule with the
    lease-based work-stealing claim loop (:mod:`.steal`): launch the SAME
    call on N independent host processes sharing ``out_dir`` (no process
    group, no barriers: hosts may join late, die mid-unit and be
    reclaimed by the survivors; the last host out runs the lease-guarded
    finalization). ``lease_ttl`` is the steal horizon in seconds (a dead
    host's units are reclaimed after at most one TTL), ``holder_id``
    names this host in lease files (default: hostname-pid-nonce), and
    ``scatter_units`` pins a fixed count of scatter work units (block
    slices; default: the adaptive plan, probe slices then a journaled
    wall-informed split). The output bytes equal a static single-host
    run's of the same plan: leases decide only WHO runs a unit, never
    what it produces.

    Fault model: a unit (spool group / block) whose processing raises is
    recorded and skipped; a dead pool worker rebuilds the pool and
    retries. Completed units are journaled to ``<out>/_done/group-<g>.json``,
    so a crashed or failed run re-invoked with ``resume=True`` (same
    arguments) redoes only unfinished units; the scatter spool is reused
    when its completion marker exists, else rebuilt from scratch. Any
    unit failures raise RuntimeError at the end, after all healthy units
    finished.

    Returns {path: num_rows} for the shards written by THIS rank (ranks
    own disjoint buckets; the balancer performs the global census), or,
    elastic, the global census.
    SPMD: call on every host with the same arguments; hosts split the
    work by ``comm`` rank and meet at barriers.
    """
    if comm is None:
        # The torch-free world of one: pool workers, elastic and ingest
        # helper hosts import no torch.
        from ..utils.comm import LocalCommunicator
        comm = LocalCommunicator()
    log = log or (lambda msg: None)
    if elastic and comm.world_size > 1:
        raise ValueError(
            "elastic mode replaces the static multihost schedule; launch "
            "independent processes sharing the output dir instead of "
            "joining a process group (--multihost)")
    # Top-level stage span; the scatter/gather phases and the per-unit
    # worker spans nest under it in the per-process trace files.
    with obs.span("preprocess.run", rank=comm.rank,
                  world_size=comm.world_size, elastic=bool(elastic)):
        try:
            return _run_pipeline_body(
                corpus_paths, out_dir, process_bucket, num_blocks,
                sample_ratio, seed, global_shuffle, comm, log, num_workers,
                spool_groups, resume, progress_interval, elastic,
                lease_ttl, holder_id, scatter_units, emit_manifest)
        finally:
            obs.flush()


def _run_pipeline_body(corpus_paths, out_dir, process_bucket, num_blocks,
                       sample_ratio, seed, global_shuffle, comm, log,
                       num_workers, spool_groups, resume, progress_interval,
                       elastic, lease_ttl, holder_id, scatter_units,
                       emit_manifest):
    # Refuse a dirty output dir (unless resuming): stale part files from a
    # previous run with a different block count would silently survive next
    # to fresh ones and duplicate data downstream. Elastic hosts joining a
    # run already in progress are the exception: the ledger manifest below
    # proves the directory belongs to THIS plan (a fingerprint mismatch
    # still refuses).
    manifest_path = os.path.join(out_dir, _LEDGER_DIR, "manifest.json")
    joining = elastic and os.path.exists(manifest_path)
    if elastic and not joining and os.path.isdir(out_dir):
        # Simultaneous elastic starts race the first host's manifest
        # publish: its _done/_leases dirs can exist for a moment before
        # manifest.json lands. Wait briefly before judging the directory
        # dirty; a stale dir still refuses, 10 s later.
        from ..resilience.leases import LEASE_DIR
        if any(os.path.isdir(os.path.join(out_dir, d))
               for d in (_LEDGER_DIR, LEASE_DIR)):
            deadline = time.monotonic() + 10.0
            while time.monotonic() < deadline \
                    and not os.path.exists(manifest_path):
                time.sleep(0.1)
            joining = os.path.exists(manifest_path)
    if os.path.isdir(out_dir) and not resume and not joining:
        stale = [
            n for n in sorted(os.listdir(out_dir))
            if ".parquet" in n or (".txt" in n and not n.startswith("."))
            or n in (_SPOOL_DIR, _LEDGER_DIR)
        ]
        if stale:
            raise ValueError(
                "output dir {} already contains {} shard files (e.g. {}); "
                "remove them, choose a fresh directory, or pass "
                "resume=True/--resume to continue that run".format(
                    out_dir, len(stale), stale[0]))
    # No rank may start writing before every rank has passed the guard.
    comm.barrier()

    t0 = time.perf_counter()
    input_files = discover_source_files(corpus_paths)
    blocks = plan_blocks(input_files, num_blocks)
    nbuckets = len(blocks)
    if spool_groups is not None and int(spool_groups) < 1:
        raise ValueError(
            "spool_groups must be >= 1, got {}".format(spool_groups))
    ngroups = _num_spool_groups(nbuckets) if spool_groups is None else min(
        int(spool_groups), nbuckets)
    log("{} input files -> {} blocks ({} spool groups)".format(
        len(input_files), len(blocks), ngroups))
    fingerprint = {
        "num_blocks": nbuckets, "spool_groups": ngroups, "seed": seed,
        "sample_ratio": sample_ratio, "global_shuffle": global_shuffle,
        # The corpus and the processor's own parameters (vocab, binning,
        # masking, sink format) also define what a ledgered unit's bytes
        # mean. Paths absolutize so a resume launched from another cwd is
        # not spuriously refused.
        "corpus_paths": json.dumps(
            _canonical_paths(corpus_paths), sort_keys=True, default=str),
        "processor": process_bucket.fingerprint(),
    }
    n_scatter_units = None
    if elastic:
        # The elastic unit plan (scatter slices, per-slice records, fenced
        # spool names) is incompatible with the static layout and with
        # another slice count; both are part of unit identity, so mixing
        # them across a resume refuses. The default is the ADAPTIVE plan
        # (probe slices + a journaled wall-informed split,
        # steal._ensure_plan), whose sentinel string mismatches any fixed
        # count, so adaptive<->fixed resumes refuse too.
        n_scatter_units = ("adaptive-v1" if scatter_units is None
                           else max(1, min(int(scatter_units), nbuckets)))
        fingerprint["elastic"] = True
        fingerprint["scatter_units"] = n_scatter_units
    # An elastic host joining a run in progress verifies against the
    # existing manifest as a resume would (hosts start at different
    # times by design; a misconfigured straggler must refuse).
    _check_resume_manifest(out_dir, fingerprint,
                           resume or (elastic and joining), comm.rank)
    comm.barrier()  # manifest visible before anyone journals against it

    # Work units: coarse spool groups under global shuffle, blocks without.
    all_units = list(range(comm.rank, ngroups if global_shuffle else nbuckets,
                           comm.world_size))
    workers = max(1, int(num_workers or 1))
    # Size the in-kernel thread pool so workers x native threads never
    # oversubscribes the usable cores; spawn children inherit this env and
    # resolve their own budget from it (native.resolve_threads). An
    # operator-set LDDL_TPU_NATIVE_THREADS wins.
    from ..utils.cpus import pool_cpu_budget
    os.environ.setdefault("LDDL_TPU_NATIVE_THREADS",
                          str(max(1, pool_cpu_budget() // workers)))
    spec = {
        "global_shuffle": global_shuffle,
        "out_dir": out_dir,
        "corpus_paths": corpus_paths,
        "num_blocks": num_blocks,
        "sample_ratio": sample_ratio,
        "seed": seed,
        "nbuckets": nbuckets,
        "ngroups": ngroups,
        "rank": comm.rank,
    }

    if elastic:
        spec["scatter_units"] = n_scatter_units
        spec["adaptive_scatter"] = n_scatter_units == "adaptive-v1"
        spec["emit_manifest"] = bool(emit_manifest)
        from . import steal
        return steal.run_elastic_pipeline(
            spec, process_bucket, log,
            holder_id=holder_id, lease_ttl=lease_ttl, workers=workers,
            progress_interval=progress_interval, t0=t0)

    def pool_factory_for(n_units):
        if workers <= 1 or n_units <= 1:
            return None

        def factory(max_workers=None):
            import concurrent.futures
            import multiprocessing
            return concurrent.futures.ProcessPoolExecutor(
                max_workers=max_workers or min(workers, n_units),
                mp_context=multiprocessing.get_context("spawn"),
                initializer=_pool_init,
                initargs=(process_bucket, spec))

        return factory

    # Resume bookkeeping: previously completed units are loaded from the
    # ledger and skipped.
    written = {}
    my_units = []
    if resume:
        spec["clean_first"] = True  # wipe partial part files per redone unit
        for u in all_units:
            prior = _ledger_read(out_dir, u)
            if prior is None:
                my_units.append(u)
            else:
                written.update(prior)
        if len(my_units) < len(all_units):
            log("resume: {}/{} units already complete".format(
                len(all_units) - len(my_units), len(all_units)))
    else:
        my_units = all_units

    if global_shuffle:
        marker = os.path.join(out_dir, _SPOOL_DIR, _SCATTER_MARKER)
        scatter_ok = resume and os.path.exists(marker)
        # All ranks must agree on redoing the scatter (a lagging rank's
        # blocks may be missing even if THIS rank's units all completed).
        need_scatter = bool(comm.allreduce_sum(
            [int(bool(my_units) and not scatter_ok)])[0])
        if need_scatter:
            if comm.rank == 0 and os.path.isdir(
                    os.path.join(out_dir, _SPOOL_DIR)):
                # Partial spools are poison (appends are not separable).
                shutil.rmtree(os.path.join(out_dir, _SPOOL_DIR))
                log("resume: incomplete scatter spool wiped, redoing")
            comm.barrier()
            my_blocks = list(range(comm.rank, len(blocks), comm.world_size))
            factory = pool_factory_for(len(my_blocks))
            serial_name = "w{}-0.txt".format(comm.rank)
            # retry_deaths=False: a dead scatter worker leaves partial
            # appends that a re-run would duplicate; the only safe redo is
            # wiping the (unmarked) spool, which the next resume does.
            with obs.span("preprocess.scatter", rank=comm.rank,
                          blocks=len(my_blocks)):
                _, scatter_fail = _run_units(
                    _pool_scatter_block if factory else
                    (lambda b: _spool_one_block(
                        blocks[b], out_dir, seed, sample_ratio, nbuckets,
                        ngroups, serial_name)),
                    my_blocks, factory, log,
                    "rank {} scatter".format(comm.rank), retry_deaths=False,
                    progress_interval=progress_interval)
            n_failed = int(comm.allreduce_sum([len(scatter_fail)])[0])
            if n_failed:
                raise RuntimeError(
                    "scatter failed for {} block(s) (this rank: {}); "
                    "re-run with resume to redo the scatter".format(
                        n_failed, sorted(scatter_fail)))
            comm.barrier()
            if comm.rank == 0:
                os.makedirs(os.path.dirname(marker), exist_ok=True)
                atomic_write(marker, "ok\n")
            comm.barrier()
        unit_fn, pool_fn = _run_group, _pool_run_group
        phase = "gather"
    else:
        unit_fn, pool_fn = _run_block_bucket, _pool_run_block_bucket
        phase = "process"

    factory = pool_factory_for(len(my_units))
    # Cross-unit async sink (serial path only): one shard-writer thread
    # pipelines unit N's parquet encode + fsync + publish against unit
    # N+1's read / tokenize / mask. Pool workers pipeline within each
    # unit instead (results must drain before a future resolves, or the
    # parent would journal bytes still in flight).
    writer = sink_mod.ShardWriter() if factory is None else None
    # The gather phase's span (the reference opens none around the
    # no-shuffle block processing).
    phase_span = (obs.span("preprocess.gather", rank=comm.rank,
                           groups=len(my_units))
                  if global_shuffle else contextlib.nullcontext())
    try:
        with phase_span:
            results, failures = _run_units(
                pool_fn if factory else
                (lambda u: unit_fn(spec, process_bucket, u, writer=writer)),
                my_units, factory, log,
                "rank {} {}".format(comm.rank, phase),
                progress_interval=progress_interval,
                on_result=lambda u, res: _ledger_write(out_dir, u, res),
                writer=writer)
    finally:
        if writer is not None:
            writer.close()

    for res in results.values():
        written.update(res)

    n_failed = int(comm.allreduce_sum([len(failures)])[0])
    comm.barrier()

    if n_failed:
        raise RuntimeError(
            "preprocess failed for {} unit(s) (this rank: {}); completed "
            "units are journaled — re-run with resume=True/--resume to "
            "redo only the failures".format(
                n_failed, failures or "none on this rank"))

    # Integrity manifest (per-shard byte length + CRC32), rank-strided;
    # none for txt output.
    if emit_manifest:
        build_manifest(out_dir, comm=comm, log=log)

    if comm.rank == 0:
        if global_shuffle:
            shutil.rmtree(os.path.join(out_dir, _SPOOL_DIR),
                          ignore_errors=True)
        shutil.rmtree(os.path.join(out_dir, _LEDGER_DIR), ignore_errors=True)
        _sweep_tmp_debris(out_dir)
    totals = comm.allreduce_sum([len(written), sum(written.values())])
    elapsed = time.perf_counter() - t0  # log-only rates
    if obs.enabled():
        # Rates over the whole run (docs/s from the scatter counters,
        # samples/s from the reduced census): the stage's throughput
        # headline in the summary.
        obs.set_gauge("preprocess_samples_per_second",
                      int(totals[1]) / max(elapsed, 1e-9))
        docs = obs.registry().counter("preprocess_docs_total").total()
        if docs:
            obs.set_gauge("preprocess_docs_per_second",
                          docs / max(elapsed, 1e-9))
    log("preprocess done in {:.1f}s, {} shards, {} samples".format(
        elapsed, int(totals[0]), int(totals[1])))
    return written


def _sweep_tmp_debris(out_dir):
    """Sweep atomic-write temp files leaked by hard-killed writers: a
    worker terminated mid-write never runs the unlink in
    write_table_atomic's finally, and if its unit was completed by a
    retry within the same run the ledger marks it done, so no resume
    ever redoes (and cleans) that bucket. Called only after every live
    write has published (after the final barrier); any remaining
    ``*.tmp.*`` is debris by construction."""
    import glob
    for stale in sorted(glob.glob(os.path.join(out_dir, "*.tmp.*"))):
        try:
            os.remove(stale)
            obs.inc("preprocess_stale_tmp_cleaned_total")
        # Best-effort sweep of dead writers' debris: a vanished or
        # unremovable temp file must not fail a completed run.
        except OSError:
            pass


def train_splitter_params_from_corpus(corpus_paths, sample_bytes=1_500_000):
    """Deterministic corpus sample (file-discovery order, first documents
    up to ``sample_bytes``) -> punkt-trained SplitterParams. Every rank
    computes the identical sample, so no coordination is needed."""
    from .sentences import train_splitter_params
    from .readers import split_id_text
    texts = []
    total = 0
    for path in discover_source_files(corpus_paths):
        with open(path, encoding="utf-8", errors="replace") as f:
            for line in f:
                _, text = split_id_text(line.rstrip("\n"))
                if text.strip():
                    texts.append(text)
                    total += len(text)
                if total >= sample_bytes:
                    break
        if total >= sample_bytes:
            break
    if not texts:
        raise ValueError("splitter='learned': corpus sample is empty")
    return train_splitter_params(texts)


def run_bert_preprocess(
    corpus_paths,
    out_dir,
    tokenizer,
    config=None,
    num_blocks=64,
    sample_ratio=0.9,
    seed=12345,
    bin_size=None,
    global_shuffle=True,
    output_format="parquet",
    comm=None,
    log=None,
    num_workers=1,
    spool_groups=None,
    resume=False,
    progress_interval=5.0,
    elastic=False,
    lease_ttl=30.0,
    holder_id=None,
    scatter_units=None,
    emit_manifest=True,
    pack_seq_length=None,
    pack_max_per_row=8,
):
    """Run the full BERT preprocessing pipeline (see run_sharded_pipeline
    for the SPMD execution contract). ``tokenizer`` is a vocab table
    (``preprocess.tokenizer.get_tokenizer``). ``num_workers`` > 1 fans
    the bucket work out over a local SPAWN process pool per host; a
    script that calls this must guard the call with
    ``if __name__ == "__main__":``. ``resume=True`` continues a
    crashed/failed run from its unit ledger.

    ``config.engine="torch"`` masks with the torch maskers on
    ``config.device`` (the card unless ``"cpu"``; no card raises here,
    before any work); with a pool, each worker opens its own device
    context.

    ``pack_seq_length`` switches the shard sink to OFFLINE sequence
    packing (``preprocess.packing``): each bucket's instances are
    first-fit-decreasing-packed into fixed-``pack_seq_length`` rows of at
    most ``pack_max_per_row`` samples. Mutually exclusive with
    ``bin_size``; requires ``schema_version=2`` and parquet output, and
    the budget must hold the longest instance."""
    config = config or BertPretrainConfig()
    if output_format not in ("parquet", "txt"):
        raise ValueError("output_format must be parquet|txt")
    if bin_size is not None:
        binning_mod.num_bins(config.max_seq_length, bin_size)  # validate
    if pack_seq_length is not None:
        if bin_size is not None:
            raise ValueError("pack_seq_length and bin_size are exclusive "
                             "(packing subsumes binning)")
        if output_format != "parquet":
            raise ValueError("offline packing requires parquet output")
        if config.schema_version != 2:
            raise ValueError("offline packing requires schema_version=2 "
                             "(packed rows are id-columnar)")
        if int(pack_seq_length) < config.max_seq_length:
            raise ValueError(
                "pack_seq_length {} cannot hold instances of up to "
                "max_seq_length {} tokens".format(pack_seq_length,
                                                  config.max_seq_length))
        if not (1 <= int(pack_max_per_row)):
            raise ValueError("pack_max_per_row must be >= 1")
        if int(pack_seq_length) >= 1 << 16:
            raise ValueError("pack_seq_length must fit uint16 row totals")
    if config.masking and config.engine == "torch":
        from ..device import resolve_device
        resolve_device(config.device)  # no card and no device="cpu": raise
    splitter_params = (train_splitter_params_from_corpus(corpus_paths)
                       if config.splitter == "learned" else None)

    return run_sharded_pipeline(
        corpus_paths,
        out_dir,
        BertBucketProcessor(tokenizer, config, seed, out_dir, bin_size,
                            output_format,
                            splitter_params=splitter_params,
                            pack_seq_length=pack_seq_length,
                            pack_max_per_row=pack_max_per_row),
        num_blocks=num_blocks,
        sample_ratio=sample_ratio,
        seed=seed,
        global_shuffle=global_shuffle,
        comm=comm,
        log=log,
        num_workers=num_workers,
        spool_groups=spool_groups,
        resume=resume,
        progress_interval=progress_interval,
        elastic=elastic,
        lease_ttl=lease_ttl,
        holder_id=holder_id,
        scatter_units=scatter_units,
        emit_manifest=emit_manifest,
    )
