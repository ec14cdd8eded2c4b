"""Intake journal: the durable record of which documents were ingested.

Counterpart of ``lddl_tpu/ingest/journal.py``. The streaming-ingestion
service scans a landing directory (or an explicit file list), diffs it
against this journal and preprocesses only the delta. The journal is
keyed by **content hash**: a document's identity is its bytes, never its
path, mtime or position in the landing directory, so re-delivered,
renamed and duplicate documents all diff to nothing.

Layout under ``<root>/.ingest/``::

    journal/gen-<NNNN>.json   authoritative per-generation segments: one
                              immutable, atomically published record per
                              generation ({"generation", "fingerprint",
                              "hashes", "carry", "docs", "doc_bytes"})
    journal.json              compaction cache of the union; a torn cache
                              degrades to re-scanning the segments with a
                              warning
    carry/                    carryover shards (rows journaled but not
                              yet shard-visible; see balance/delta.py)
    work/gen-<NNNN>/          in-flight generation scratch (staging
                              corpus, preprocess output, balance staging)

Everything is published through ``resilience.io`` and read through its
retried reads, with the ``journal-read`` and ``journal-publish`` fault
sites. Journal bytes are deterministic: content hashes and generation
numbers only, hash lists sorted. Counters:
``ingest_journal_rescans_total``, ``ingest_journal_idempotent_commits_total``
and ``ingest_generations_published_total`` in the port's registry.
"""

import hashlib
import json
import logging
import os
import shutil

from .. import observability as obs
from ..resilience import faults
from ..resilience import io as rio

INGEST_DIR = ".ingest"
JOURNAL_CACHE_NAME = "journal.json"
SEGMENT_DIR = "journal"
CARRY_DIR = "carry"
WORK_DIR = "work"
INTAKE_NAME = "intake.json"

_log = logging.getLogger("lddl_tpu_torch.ingest.journal")


def ingest_root(root):
    return os.path.join(root, INGEST_DIR)


def segment_dir(root):
    return os.path.join(ingest_root(root), SEGMENT_DIR)


def segment_path(root, generation):
    return os.path.join(segment_dir(root),
                        "gen-{:04d}.json".format(generation))


def carry_dir(root):
    return os.path.join(ingest_root(root), CARRY_DIR)


def work_dir(root, generation):
    return os.path.join(ingest_root(root), WORK_DIR,
                        "gen-{:04d}".format(generation))


def intake_path(root, generation):
    return os.path.join(work_dir(root, generation), INTAKE_NAME)


def doc_content_hash(text):
    """Content identity of one document: blake2b of its raw bytes."""
    if isinstance(text, str):
        text = text.encode("utf-8")
    return hashlib.blake2b(text, digest_size=16).hexdigest()


def read_record(path):
    """One journal record through the ``journal-read`` fault site and the
    retried JSON reader: ``(value, status)``, status "ok", "missing" or
    "torn" (an injected truncate makes a clean read torn)."""
    action = faults.fault_point("journal-read", path)
    rec, status = rio.read_json(path)
    if action == "truncate" and status == "ok":
        return None, "torn"
    return rec, status


def publish_record(path, payload, exclusive=False):
    """Atomically publish one journal record (the ``journal-publish``
    fault site); ``payload`` is serialized with sorted keys.

    ``exclusive=True`` marks the per-generation segment, the ingest
    commit point: on the mock store it is a conditional create, where a
    raced commit of identical content is absorbed and different content
    for the same generation refuses; on the local backend it is an
    atomic write (ingest is single-writer there by contract)."""
    faults.fault_point("journal-publish", path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    data = json.dumps(payload, sort_keys=True)
    if exclusive:
        if rio.put_exclusive(path, data) == "conflict":
            current, status = rio.read_json(path)
            if status == "ok" and current == payload:
                obs.inc("ingest_journal_idempotent_commits_total")
                return
            raise ValueError(
                "conflicting concurrent commit of journal record {}: "
                "another writer already published DIFFERENT content for "
                "this generation — refusing to overwrite the "
                "authoritative segment".format(path))
        return
    rio.atomic_write(path, data)


class Journal:
    """The loaded union of all published generation segments.

    ``entries``: {doc_hash: generation}; ``generation``: the latest
    published generation (-1 before any); ``fingerprint``: the processor
    digest every generation must match; ``carry``: {bin_key:
    carry_file_basename}, rows journaled but not yet visible as shards.
    """

    def __init__(self, root, entries=None, generation=-1, fingerprint=None,
                 carry=None):
        self.root = root
        self.entries = entries or {}
        self.generation = generation
        self.fingerprint = fingerprint
        self.carry = carry or {}

    @classmethod
    def load(cls, root):
        """The cache when it parses, else a re-scan of the segments (a
        torn cache is never trusted and never fatal). A torn or missing
        segment IS fatal: segments are the ground truth, and guessing at
        their hashes would silently re-ingest documents."""
        cache_path = os.path.join(ingest_root(root), JOURNAL_CACHE_NAME)
        rec, status = read_record(cache_path)
        if status == "ok" and cls._cache_valid(rec):
            return cls(root, entries=dict(rec["entries"]),
                       generation=int(rec["generation"]),
                       fingerprint=rec.get("fingerprint"),
                       carry=dict(rec.get("carry") or {}))
        if status == "torn" or (status == "ok" and not cls._cache_valid(rec)):
            _log.warning(
                "torn/unparseable journal cache %s; re-scanning the "
                "per-generation segments (the cache is a compaction — "
                "segments are authoritative)", cache_path)
            obs.inc("ingest_journal_rescans_total")
        return cls._load_from_segments(root)

    @staticmethod
    def _cache_valid(rec):
        return (isinstance(rec, dict)
                and isinstance(rec.get("entries"), dict)
                and isinstance(rec.get("generation"), int))

    @classmethod
    def _load_from_segments(cls, root):
        seg_dir = segment_dir(root)
        journal = cls(root)
        if not os.path.isdir(seg_dir):
            return journal
        seen = set()
        for name in sorted(os.listdir(seg_dir)):
            path = os.path.join(seg_dir, name)
            rec, status = read_record(path)
            if status == "missing":
                continue
            if status == "torn" or not isinstance(rec, dict) \
                    or "generation" not in rec:
                raise ValueError(
                    "journal segment {} is torn or unparseable; segments "
                    "are the authoritative ingest record and are written "
                    "atomically, so this implicates the storage medium — "
                    "restore the file before ingesting (re-scanning would "
                    "silently duplicate already-ingested documents)".format(
                        path))
            g = int(rec["generation"])
            seen.add(g)
            for h in rec.get("hashes", ()):
                journal.entries[h] = g
            if g > journal.generation:
                journal.generation = g
                journal.fingerprint = rec.get("fingerprint")
                journal.carry = dict(rec.get("carry") or {})
        # Generations publish strictly in sequence: a hole is a lost
        # segment, whose documents would be re-ingested on top.
        if seen and seen != set(range(journal.generation + 1)):
            missing = sorted(set(range(journal.generation + 1)) - seen)
            raise ValueError(
                "journal segment(s) for generation(s) {} are missing from "
                "{} (segments present: {}); the ingest sequence cannot "
                "have holes — restore the lost segment(s) before "
                "ingesting (re-scanning would silently duplicate their "
                "documents)".format(missing, seg_dir, sorted(seen)))
        return journal

    def publish_generation(self, generation, hashes, fingerprint,
                           carry=None, doc_bytes=0):
        """Commit one generation: the segment publish is the commit point
        (before it the generation is redoable from its intake record,
        after it only idempotent cleanup remains), then the cache."""
        if generation != self.generation + 1:
            raise ValueError(
                "generation {} published out of order (journal is at "
                "{})".format(generation, self.generation))
        payload = {
            "generation": generation,
            "fingerprint": fingerprint,
            "hashes": sorted(hashes),
            "carry": dict(carry or {}),
            "docs": len(hashes),
            "doc_bytes": int(doc_bytes),
        }
        publish_record(segment_path(self.root, generation), payload,
                       exclusive=True)
        for h in hashes:
            self.entries[h] = generation
        self.generation = generation
        self.fingerprint = fingerprint
        self.carry = dict(carry or {})
        self._write_cache()
        obs.inc("ingest_generations_published_total")

    def _write_cache(self):
        publish_record(
            os.path.join(ingest_root(self.root), JOURNAL_CACHE_NAME),
            {"entries": self.entries, "generation": self.generation,
             "fingerprint": self.fingerprint, "carry": self.carry})

    def next_generation(self):
        return self.generation + 1

    def pending_work(self):
        """The intake record of a crashed, unpublished generation (its
        work dir holds an intake.json of generation journal.generation +
        1), or None. Work dirs of already-published generations (a crash
        between the commit and the sweep) are swept here."""
        wroot = os.path.join(ingest_root(self.root), WORK_DIR)
        if not os.path.isdir(wroot):
            return None
        pending = None
        for name in sorted(os.listdir(wroot)):
            path = os.path.join(wroot, name, INTAKE_NAME)
            rec, status = read_record(path)
            if status == "torn":
                _log.warning(
                    "torn intake record %s; discarding the in-flight "
                    "generation's scratch (nothing was published, so the "
                    "delta is simply re-detected from the landing "
                    "directory)", path)
                shutil.rmtree(os.path.join(wroot, name), ignore_errors=True)
                continue
            if rec is None:
                continue
            g = int(rec["generation"])
            if g <= self.generation:
                # Published: only the cleanup was interrupted.
                shutil.rmtree(os.path.join(wroot, name), ignore_errors=True)
            elif g == self.generation + 1:
                pending = rec
            else:
                raise ValueError(
                    "work dir {} claims generation {} but the journal is "
                    "at {}; the ingest sequence cannot skip generations "
                    "— remove the stray work dir if it is debris".format(
                        os.path.join(wroot, name), g, self.generation))
        return pending


def iter_landing_documents(landing=None, files=None):
    """(content_hash, text_bytes) of every non-empty document in the
    landing directory (one document per line, the first token its id) or
    an explicit ``files`` list. Files are visited in sorted order; the
    diff does not depend on it (identity is the content hash)."""
    from ..preprocess.readers import split_id_text
    if (landing is None) == (files is None):
        raise ValueError("give exactly one of landing= or files=")
    if files is None:
        from ..preprocess.readers import discover_source_files
        files = discover_source_files({"landing": landing})
    for path in sorted(files):
        with open(path, "rb") as f:
            for line in f:
                line = line.rstrip(b"\n")
                if not line.strip():
                    continue
                _, text = split_id_text(line)
                if not text.strip():
                    continue
                yield doc_content_hash(text), text


def diff_landing(journal, landing=None, files=None):
    """The preprocess work set: {content_hash: text_bytes} of documents in
    the landing set but not in the journal, and scan stats. Duplicates
    within one scan collapse to one entry (counted in the stats)."""
    new_docs = {}
    seen = dupes = 0
    for h, text in iter_landing_documents(landing=landing, files=files):
        seen += 1
        if h in journal.entries or h in new_docs:
            dupes += h in new_docs
            continue
        new_docs[h] = text
    return new_docs, {"docs_seen": seen, "docs_new": len(new_docs),
                      "dupes_in_scan": dupes}
