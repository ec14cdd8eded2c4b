"""Incremental ingest: one journal-diffed generation through the pipeline.

Counterpart of ``lddl_tpu/ingest/incremental.py``. ``ingest_once`` is the
service's unit of work: scan the landing set, diff it against the
intake journal and, only if there is a delta, run preprocess + delta
balance over just those documents, publishing the result as the next
**generation** of the dataset:

    generation 0   classic balanced layout in the dataset root
                   (``shard-<i>.parquet[_<bin>]``), byte-compatible with
                   the offline pipeline's output
    generation N   ``gen-<NNNN>/shard-<i>.parquet[_<bin>]``: appended
                   shards sized to the row budget generation 0 fixed
                   (see balance/delta.py); prior generations' bytes are
                   never touched

Every crash point is redoable or idempotent, and the **journal segment
publish is the single commit point**:

    1. staging corpus written (work dir; documents sorted by content
       hash, the hash as the doc id)
    2. intake record published (freezes the doc set, the prior-shard
       snapshot and every knob that shapes bytes; a resumed generation
       replays THESE, never a fresh scan)
    3. preprocess into the work dir (crash-resumable via its unit ledger)
    4. delta balance staged + plan marker (nothing in the root mutates)
    5. staged bytes published, caches and per-dir integrity manifests
       refreshed, the root manifest's ``__meta__`` gains {"generation":
       N, "generations": {gen: [shards]}} LAST: the loader's
       generation-pickup gate
    6. journal segment published (COMMIT), then scratch swept

The reference also records each step as a fleet lifecycle event
(``observability/fleet.py``); fleet telemetry is not ported, so
``_fleet_record`` stands at those sites and does nothing.
``elastic=True`` runs a round's preprocess on the lease-based
work-stealing schedule (``preprocess/steal.py``), and
``join_pending_generation`` lets a helper host join that preprocess; the
autoscaler that would spawn such helpers waits for the fleet telemetry.
"""

import os
import shutil

from .. import observability as obs
from ..resilience import io as rio
from ..resilience.integrity import build_manifest
from ..utils.fs import (
    _is_parquet_path,
    generation_dir_name,
    get_all_parquets_under,
    get_num_samples_of_parquet,
    read_num_samples_cache,
    trusted_num_samples_entries,
    write_num_samples_cache,
)
from ..balance import delta as delta_mod
from . import journal as journal_mod


def _fleet_record(kind, **fields):
    """A fleet lifecycle event in the reference (``fleet.record``); fleet
    telemetry is not ported, so this does nothing."""


def _snapshot_prior(root):
    """{relpath: count} of every published shard under ``root`` (all
    generations), counts from per-entry-trusted caches with footer reads
    only for untrusted entries. Sorted relpaths; pure function of the
    published state."""
    paths = get_all_parquets_under(root)
    out = {}
    by_dir = {}
    for p in paths:
        by_dir.setdefault(os.path.dirname(p), []).append(p)
    for d in sorted(by_dir):
        trusted, _ = trusted_num_samples_entries(
            d, read_num_samples_cache(d))
        for p in sorted(by_dir[d]):
            name = os.path.basename(p)
            n = trusted.get(name)
            out[os.path.relpath(p, root)] = (
                int(n) if n is not None else get_num_samples_of_parquet(p))
    return out


def _write_staging_corpus(staging_dir, new_docs):
    """The delta as a downloader-contract corpus: one document per line,
    content hash as the doc id, documents in sorted-hash order — byte
    deterministic regardless of landing-directory iteration order."""
    source = os.path.join(staging_dir, "source")
    os.makedirs(source, exist_ok=True)
    parts = []
    for h in sorted(new_docs):
        parts.append(h.encode())
        parts.append(b" ")
        parts.append(new_docs[h])
        parts.append(b"\n")
    rio.atomic_write(os.path.join(source, "0.txt"), b"".join(parts))


def _default_num_blocks(ndocs):
    return max(1, min(64, ndocs // 8 + 1))


def _generations_meta(root, latest):
    """The root manifest's ``__meta__`` extension: the monotonically
    increasing latest generation plus each generation's shard list
    (relpaths), read off the published directories in sorted order."""
    gens = {}
    for gen in range(latest + 1):
        d = root if gen == 0 else os.path.join(root,
                                               generation_dir_name(gen))
        names = []
        if os.path.isdir(d):
            names = [n for n in sorted(os.listdir(d)) if _is_parquet_path(n)]
        prefix = "" if gen == 0 else generation_dir_name(gen) + "/"
        gens[str(gen)] = [prefix + n for n in names]
    return {"generation": latest, "generations": gens}


def _refresh_dir_bookkeeping(root, dirs, latest_generation, known_counts):
    """Refresh ``.num_samples.json`` (with per-entry sizes) and the
    integrity manifest for every directory whose shards changed; the ROOT
    manifest is always refreshed LAST with the generation meta — it is
    the loader's pickup gate, so nothing newer than it is ever visible.

    ``known_counts`` ({relpath: count}, the shards this ingest round just
    published) override the cache: a rewritten shard whose new byte
    length happens to collide with the cached one must not smuggle a
    stale count through the per-entry size check."""
    ordered = sorted(d for d in dirs if os.path.abspath(d)
                     != os.path.abspath(root))
    for d in ordered + [root]:
        names = [n for n in sorted(os.listdir(d)) if _is_parquet_path(n)] \
            if os.path.isdir(d) else []
        # Recount only entries the existing cache cannot vouch for.
        trusted, _ = trusted_num_samples_entries(
            d, read_num_samples_cache(d))
        counts = {}
        for n in names:
            rel = os.path.relpath(os.path.join(d, n), root)
            if rel in known_counts:
                counts[n] = int(known_counts[rel])
            elif n in trusted:
                counts[n] = int(trusted[n])
            else:
                counts[n] = get_num_samples_of_parquet(os.path.join(d, n))
        if counts or os.path.abspath(d) == os.path.abspath(root):
            write_num_samples_cache(d, counts, with_sizes=True)
        extra = None
        if os.path.abspath(d) == os.path.abspath(root):
            extra = _generations_meta(root, latest_generation)
        build_manifest(d, extra_meta=extra)


def ingest_once(
    root,
    tokenizer,
    landing=None,
    files=None,
    config=None,
    num_shards=8,
    bin_size=None,
    seed=12345,
    num_blocks=None,
    num_workers=1,
    flush_tail=False,
    comm=None,
    log=None,
    elastic=False,
    lease_ttl=30.0,
    holder_id=None,
    scatter_units=None,
    pack_seq_length=None,
    pack_max_per_row=8,
):
    """Diff the landing set against the journal and ingest the delta as
    one generation. Returns a report dict ({"noop": True} when there is
    nothing to do). Safe to re-run after any crash: an in-flight
    generation resumes from its intake record.

    ``flush_tail=True`` folds the carryover remainder into the prior tail
    (touches the minimum set of prior shards — see balance/delta.py)
    instead of deferring it; use it in maintenance windows, not while a
    loader is streaming the directory mid-epoch.

    ``pack_seq_length`` grows packed corpora by generations: every
    delta's instances are FFD-packed against the same budget the prior
    generations fixed (the pack shape rides the processor fingerprint,
    so drift refuses like any other config drift), and carry/remainder
    semantics are untouched — carryover rows are whole packed rows.
    """
    log = log or (lambda msg: None)
    with obs.span("ingest.run", root=root):
        return _ingest_once_body(
            root, tokenizer, landing, files, config, num_shards, bin_size,
            seed, num_blocks, num_workers, flush_tail, comm, log, elastic,
            lease_ttl, holder_id, scatter_units, pack_seq_length,
            pack_max_per_row)


def _ingest_once_body(root, tokenizer, landing, files, config, num_shards,
                      bin_size, seed, num_blocks, num_workers, flush_tail,
                      comm, log, elastic, lease_ttl, holder_id,
                      scatter_units, pack_seq_length=None,
                      pack_max_per_row=8):
    from ..preprocess.bert import BertPretrainConfig
    from ..preprocess.runner import BertBucketProcessor, run_bert_preprocess

    config = config or BertPretrainConfig()
    if config.splitter == "learned":
        raise ValueError(
            "ingest requires splitter='rules': learned splitter parameters "
            "are trained per corpus sample, so every delta would tokenize "
            "under different parameters — incompatible with a journal that "
            "promises one document ingests to one set of bytes")
    os.makedirs(root, exist_ok=True)
    journal = journal_mod.Journal.load(root)
    fingerprint = BertBucketProcessor(
        tokenizer, config, seed, root, bin_size, "parquet",
        pack_seq_length=pack_seq_length,
        pack_max_per_row=pack_max_per_row).fingerprint()
    if journal.fingerprint is not None \
            and journal.fingerprint != fingerprint:
        raise ValueError(
            "ingest configuration drift: the journal was built with "
            "processor fingerprint {} but this invocation computes {}; "
            "mixing them would put incompatible bytes in one dataset — "
            "restore the original arguments or start a fresh root".format(
                journal.fingerprint, fingerprint))

    # Adoption: a pre-existing balanced directory with no journal becomes
    # generation 0 as-is (its documents are unknown to the journal, so
    # dedup starts from this point forward).
    if journal.generation < 0 and get_all_parquets_under(root):
        log("ingest: adopting existing balanced directory as generation 0")
        # Publish the generation gate FIRST: an adopted offline manifest
        # has no __meta__.generation, and a gateless directory "follows
        # whatever is on disk" — a follow-mode loader hitting an epoch
        # boundary while generation 1's shards are mid-publish would see
        # the half-published set. Gate before journal so a crash between
        # the two re-enters this branch (journal still empty) and both
        # writes re-run idempotently; the reverse order would skip the
        # branch and leave the directory permanently gateless.
        _refresh_dir_bookkeeping(root, {root}, 0, {})
        journal.publish_generation(0, [], fingerprint)

    pending = journal.pending_work()
    if pending is not None:
        generation = int(pending["generation"])
        if pending.get("fingerprint") != fingerprint:
            raise ValueError(
                "in-flight generation {} was started with fingerprint {} "
                "but this invocation computes {}; resume with the original "
                "arguments".format(generation, pending.get("fingerprint"),
                                   fingerprint))
        intake = pending
        _fleet_record("generation.intake", generation=generation,
                      docs=len(intake["hashes"]), resumed=True)
        log("ingest: resuming in-flight generation {} ({} document(s) "
            "from its intake record)".format(generation,
                                             len(intake["hashes"])))
    else:
        new_docs, scan_stats = journal_mod.diff_landing(
            journal, landing=landing, files=files)
        obs.inc("ingest_docs_seen_total", scan_stats["docs_seen"])
        # Backlog = discovered-but-uncommitted documents; drops back to 0
        # at the journal commit below.
        obs.set_gauge("ingest_backlog_docs", len(new_docs))
        carry_rows = _carry_row_count(root, journal)
        if not new_docs and not (flush_tail and carry_rows):
            _fleet_record("ingest.scan", docs_seen=scan_stats["docs_seen"],
                          docs_new=0, noop=True)
            log("ingest: no new documents ({} seen, all journaled)".format(
                scan_stats["docs_seen"]))
            return {"noop": True, "generation": journal.generation,
                    "docs_seen": scan_stats["docs_seen"],
                    "carry_rows": carry_rows}
        generation = journal.next_generation()
        wdir = journal_mod.work_dir(root, generation)
        if os.path.isdir(wdir):
            # No (valid) intake record -> the previous attempt crashed
            # before freezing its doc set; its scratch is unusable.
            shutil.rmtree(wdir)
        gen_dir = (os.path.join(root, generation_dir_name(generation))
                   if generation >= 1 else None)
        if gen_dir is not None and os.path.isdir(gen_dir):
            # Unpublished debris (the journal commits last): a fresh scan
            # may produce a different plan, so stale shards must not mix.
            shutil.rmtree(gen_dir)
        _write_staging_corpus(os.path.join(wdir, "staging"), new_docs)
        intake = {
            "generation": generation,
            "fingerprint": fingerprint,
            "hashes": sorted(new_docs),
            "doc_bytes": sum(len(t) for t in new_docs.values()),
            "prior": _snapshot_prior(root),
            "carry_in": sorted(journal.carry.values()),
            "num_shards": int(num_shards),
            "num_blocks": (int(num_blocks) if num_blocks
                           else _default_num_blocks(len(new_docs))),
            "seed": int(seed),
            "bin_size": bin_size,
            "flush": bool(flush_tail),
            "pack_seq_length": (int(pack_seq_length)
                                if pack_seq_length else None),
            "pack_max_per_row": int(pack_max_per_row),
        }
        journal_mod.publish_record(
            journal_mod.intake_path(root, generation), intake)
        _fleet_record("generation.intake", generation=generation,
                      docs=len(intake["hashes"]),
                      doc_bytes=intake["doc_bytes"], resumed=False)
        log("ingest: generation {}: {} new document(s) of {} seen".format(
            generation, scan_stats["docs_new"], scan_stats["docs_seen"]))

    wdir = journal_mod.work_dir(root, generation)
    staging = os.path.join(wdir, "staging")
    pre_dir = os.path.join(wdir, "pre")
    part_paths = []
    if intake["hashes"]:
        with obs.span("ingest.preprocess", generation=generation):
            run_bert_preprocess(
                {"ingest": staging},
                pre_dir,
                tokenizer,
                config=config,
                num_blocks=intake["num_blocks"],
                sample_ratio=1.0,
                seed=intake["seed"],
                bin_size=intake["bin_size"],
                global_shuffle=True,
                comm=comm,
                log=log,
                num_workers=num_workers,
                resume=os.path.isdir(pre_dir),
                elastic=elastic,
                lease_ttl=lease_ttl,
                holder_id=holder_id,
                scatter_units=scatter_units,
                emit_manifest=False,
                # A resumed generation replays its FROZEN intake record
                # (legacy records carry no pack keys: unpacked).
                pack_seq_length=intake.get("pack_seq_length"),
                pack_max_per_row=intake.get("pack_max_per_row", 8),
            )
        part_paths = get_all_parquets_under(pre_dir)
        _fleet_record("generation.preprocess", generation=generation,
                      shards=len(part_paths))

    stage_dir = os.path.join(wdir, "balance")
    plan = delta_mod.read_plan(stage_dir)
    if plan is None:
        if os.path.isdir(stage_dir):
            shutil.rmtree(stage_dir)  # marker-less partial staging
        carry_in = [os.path.join(journal_mod.carry_dir(root), name)
                    for name in intake["carry_in"]]
        with obs.span("ingest.delta_balance", generation=generation):
            plan = delta_mod.stage_delta_balance(
                root, generation, part_paths, stage_dir,
                prior=intake["prior"], carry_in_paths=carry_in,
                num_shards=intake["num_shards"],
                flush=intake.get("flush", False), log=log)

    published = delta_mod.publish_delta_balance(
        root, stage_dir, plan, carry_dir=journal_mod.carry_dir(root),
        log=log)
    _fleet_record("generation.delta_balance", generation=generation,
                  new_shards=len(published["new"]),
                  touched_prior=len(published["touched"]))

    changed_dirs = {os.path.dirname(os.path.join(root, rel))
                    for rel in list(published["new"])
                    + list(published["touched"])}
    known_counts = dict(published["new"])
    known_counts.update(published["touched"])
    _refresh_dir_bookkeeping(root, changed_dirs or {root}, generation,
                             known_counts)
    _fleet_record("generation.gate_advance", generation=generation)

    journal.publish_generation(generation, intake["hashes"], fingerprint,
                               carry=published["carry"],
                               doc_bytes=intake.get("doc_bytes", 0))
    _fleet_record("generation.committed", generation=generation,
                  docs=len(intake["hashes"]))
    obs.set_gauge("ingest_backlog_docs", 0)

    # Post-commit sweep (idempotent; redone by pending_work on a crash):
    # consumed carry inputs, then the whole work dir.
    cdir = journal_mod.carry_dir(root)
    keep = set(journal.carry.values())
    # Backend-routed sweep: on the mock store the carry files are
    # objects, and a raw unlink of only the view would leave them
    # readable through their commit records (silent resurrection).
    names = rio.list_dir(cdir)
    for name in names or ():
        if name not in keep:
            rio.remove(os.path.join(cdir, name))
    shutil.rmtree(wdir, ignore_errors=True)

    carry_rows = sum(
        plan["bins"][k]["carry"].get(name, 0)
        for k in plan["bins"] for name in plan["bins"][k]["carry"])
    samples_new = sum(plan["bins"][k]["consumed"] for k in plan["bins"])
    report = {
        "noop": False,
        "generation": generation,
        "docs": len(intake["hashes"]),
        "samples_visible": samples_new,
        "carry_rows": carry_rows,
        "new_shards": len(published["new"]),
        "touched_prior_shards": sorted(published["touched"]),
    }
    if obs.enabled():
        obs.inc("ingest_docs_total", len(intake["hashes"]),
                generation=generation)
        obs.inc("ingest_shards_appended_total", len(published["new"]),
                generation=generation)
        obs.set_gauge("ingest_generation", generation)
        obs.set_gauge("ingest_carry_rows", carry_rows)
    log("ingest: generation {} published: {} doc(s), {} new shard(s), "
        "{} row(s) carried, {} prior shard(s) touched".format(
            generation, report["docs"], report["new_shards"], carry_rows,
            len(published["touched"])))
    return report


def _carry_row_count(root, journal):
    total = 0
    cdir = journal_mod.carry_dir(root)
    for name in sorted(journal.carry.values()):
        path = os.path.join(cdir, name)
        if os.path.isfile(path):
            total += get_num_samples_of_parquet(path)
    return total


def join_pending_generation(root, tokenizer, *, config=None, num_workers=1,
                            lease_ttl=30.0, holder_id=None,
                            scatter_units=None, comm=None, log=None):
    """Join the in-flight generation's ELASTIC preprocess as a helper
    host (the reference's autoscaler spawns such helpers; the port's
    waits for the fleet telemetry).

    A helper never scans the landing dir, never balances, never commits
    the journal: it replays the primary's FROZEN intake record (doc set
    and knobs were fixed at intake time, so every joining host computes
    the identical plan) and enters the same lease claim loop, stealing
    scatter/gather units exactly like any elastic peer. It exits when
    the preprocess phase is done (or there is nothing to join); the
    primary's ingest round does the rest.

    Returns a report dict: ``{"joined": False, "why": ...}`` when there
    was nothing to do, else ``{"joined": True, "generation": N}``."""
    from ..preprocess.bert import BertPretrainConfig
    from ..preprocess.runner import BertBucketProcessor, run_bert_preprocess

    log = log or (lambda msg: None)
    config = config or BertPretrainConfig()
    journal = journal_mod.Journal.load(root)
    pending = journal.pending_work()
    if pending is None:
        return {"joined": False, "why": "no in-flight generation"}
    generation = int(pending["generation"])
    if not pending["hashes"]:
        return {"joined": False, "why": "pending generation has no "
                                        "documents (flush-only round)"}
    # Same drift refusal as the primary, against the intake-frozen knobs:
    # a helper with a different processor config would journal units
    # whose bytes mean something else.
    fingerprint = BertBucketProcessor(
        tokenizer, config, int(pending["seed"]), root, pending["bin_size"],
        "parquet",
        pack_seq_length=pending.get("pack_seq_length"),
        pack_max_per_row=pending.get("pack_max_per_row", 8)).fingerprint()
    if pending.get("fingerprint") != fingerprint:
        raise ValueError(
            "helper configuration drift: in-flight generation {} was "
            "started with fingerprint {} but this helper computes {}; "
            "launch the helper with the primary's arguments".format(
                generation, pending.get("fingerprint"), fingerprint))
    wdir = journal_mod.work_dir(root, generation)
    staging = os.path.join(wdir, "staging")
    pre_dir = os.path.join(wdir, "pre")
    if not os.path.isdir(staging):
        return {"joined": False, "why": "staging corpus not on disk yet"}
    if os.path.isdir(pre_dir) and get_all_parquets_under(pre_dir) \
            and not os.path.isdir(os.path.join(pre_dir, "_done")):
        # Shards present and the unit ledger already retired: the
        # preprocess finished; the primary is balancing/committing and
        # a late joiner would only redo finished work.
        return {"joined": False, "why": "preprocess already finalized"}
    log("ingest helper: joining generation {} ({} document(s))".format(
        generation, len(pending["hashes"])))
    with obs.span("ingest.join", generation=generation):
        run_bert_preprocess(
            {"ingest": staging},
            pre_dir,
            tokenizer,
            config=config,
            num_blocks=int(pending["num_blocks"]),
            sample_ratio=1.0,
            seed=int(pending["seed"]),
            bin_size=pending["bin_size"],
            global_shuffle=True,
            comm=comm,
            log=log,
            num_workers=num_workers,
            resume=os.path.isdir(pre_dir),
            elastic=True,
            lease_ttl=lease_ttl,
            holder_id=holder_id,
            scatter_units=scatter_units,
            emit_manifest=False,
            pack_seq_length=pending.get("pack_seq_length"),
            pack_max_per_row=pending.get("pack_max_per_row", 8),
        )
    _fleet_record("generation.joined", generation=generation,
                  holder=str(holder_id or ""))
    return {"joined": True, "generation": generation}


def watch(root, tokenizer, landing, interval_s=30.0, max_rounds=0,
          log=None, **kwargs):
    """The polling service loop: ``ingest_once`` forever (or
    ``max_rounds`` times), sleeping ``interval_s`` between scans. Each
    round is independently crash-safe; the loop itself holds no state.
    Reports are returned only in bounded (``max_rounds``) mode — the
    forever loop never returns, and accumulating a dict per round for
    months would be a slow leak."""
    import time
    log = log or (lambda msg: None)
    rounds = 0
    reports = [] if max_rounds else None
    while True:
        report = ingest_once(root, tokenizer, landing=landing, log=log,
                             **kwargs)
        rounds += 1
        if max_rounds:
            reports.append(report)
            if rounds >= max_rounds:
                return reports
        time.sleep(interval_s)
