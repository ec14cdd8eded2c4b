"""Delta balancer: extend a balanced shard directory without rewriting it.

Counterpart of ``lddl_tpu/balance/delta.py``. The classic balancer
(:mod:`.balancer`) rewrites every shard; this module rebalances **only
the tail**: the new generation's rows plus, at most, the minimum set of
prior-tail shards that keeps the directory-wide ±1 sample-count
invariant.

The **row budget**: generation 0 fixes each bin's per-shard count at
``m`` (every prior shard holds ``m`` or ``m+1`` rows). A delta of ``T1``
rows is cut into ``G = T1 // m`` new shards of ``m`` rows (the first
``min(T1 mod m, G)`` of them take one extra row), and the remainder,
fewer than ``m`` rows, becomes **carryover**: rows already journaled,
parked in ``.ingest/carry/`` and prepended to the NEXT generation's
input. In this steady state no prior shard is touched, so a loader may
stream them while a new generation publishes.

``flush=True`` trades that for zero carry latency: the remainder is
folded into the prior tail by whichever of two moves touches fewer
shards, *absorb-up* (append one row to ``r`` prior shards at ``m``) or
*pull-down* (one more full shard from the remainder plus the last row of
``m - r`` prior shards at ``m+1``); where neither fits, the whole bin is
rebalanced. The touched shards are replaced in place, so flushing is
for maintenance windows, not for directories streamed mid-epoch.

Crash safety is two-phase: everything is staged under the generation's
work dir, a ``plan.json`` marker is published once the staging is
complete, and only then are the staged bytes copied into the dataset
(idempotent: a crashed publish re-runs from the staged bytes).
"""

import json
import logging
import os

import pyarrow as pa

from .. import observability as obs
from ..preprocess.binning import (DEFAULT_PARQUET_COMPRESSION,
                                  write_options_for_names)
from ..resilience import io as rio
from ..utils.fs import (
    GENERATION_DIR_RE,
    generation_dir_name,
    get_bin_id_of_path,
    get_num_samples_of_parquet,
)

PLAN_NAME = "plan.json"

_log = logging.getLogger("lddl_tpu_torch.balance.delta")

# Bin key used in plans/carry maps for unbinned data (bin ids are ints).
UNBINNED_KEY = "unbinned"


def bin_key_of(bin_id):
    return UNBINNED_KEY if bin_id is None else str(bin_id)


def shard_suffix(bin_id):
    return ".parquet" if bin_id is None else ".parquet_{}".format(bin_id)


def carry_basename(generation, bin_id):
    # The bin id rides the standard .parquet_<b> extension so carry files
    # re-enter the next round's bin grouping like any other input.
    return "gen-{:04d}.carry{}".format(generation, shard_suffix(bin_id))


def plan_bin_delta(prior_counts, new_total):
    """The pure per-bin arithmetic: given the prior shard counts (all
    ``m`` or ``m+1`` — the invariant) and ``new_total`` delta rows,
    return ``(m, G, plus_new, carry)``: ``G`` new shards, the first
    ``plus_new`` of them at ``m+1`` rows, ``carry`` rows (< m) deferred.

    Zero prior shards are touched by construction: new shards only ever
    take counts already in {m, m+1}, so the directory-wide spread stays
    ≤ 1 without moving a single prior row."""
    if not prior_counts:
        raise ValueError("plan_bin_delta needs at least one prior shard")
    m, hi = min(prior_counts), max(prior_counts)
    if hi - m > 1:
        raise ValueError(
            "prior shards are not balanced (counts range {}..{}); run the "
            "full balancer before ingesting incrementally".format(m, hi))
    G = new_total // m
    r = new_total - G * m
    plus_new = min(r, G)
    return m, G, plus_new, r - plus_new


def plan_flush(prior_counts, m, carry):
    """How to fold ``carry`` (< m) leftover rows into the prior tail while
    keeping every count in {m, m+1}. Returns ``("absorb", k)`` — append
    one row to each of the last ``k = carry`` prior shards currently at
    ``m`` — or ``("pull", k)`` — build one more full shard from the carry
    plus the last row of each of the last ``k = m - carry`` prior shards
    currently at ``m+1`` — whichever touches fewer shards. Raises when
    neither move is feasible (degenerate tiny directories)."""
    at_m = sum(1 for c in prior_counts if c == m)
    at_m1 = len(prior_counts) - at_m
    absorb_ok = carry <= at_m
    pull_ok = (m - carry) <= at_m1
    if not absorb_ok and not pull_ok:
        raise ValueError(
            "cannot flush {} leftover row(s): only {} shard(s) at {} and "
            "{} at {}; ingest more data or re-run the full balancer".format(
                carry, at_m, m, at_m1, m + 1))
    if absorb_ok and (not pull_ok or carry <= m - carry):
        return "absorb", carry
    return "pull", m - carry


def _read_concat(paths):
    tables = [rio.read_table(p) for p in paths]
    return tables[0] if len(tables) == 1 else pa.concat_tables(tables)


def _stage_table(table, path):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    rio.write_table_atomic(table, path,
                           compression=DEFAULT_PARQUET_COMPRESSION,
                           **write_options_for_names(table.schema.names))


def _bin_inputs(part_paths, carry_in_paths):
    """Group delta inputs by bin id: carryover first (oldest rows flush
    into shards first — FIFO), then the preprocess part files in sorted
    order. Pure name-based grouping, deterministic."""
    by_bin = {}
    for path in sorted(carry_in_paths):
        b = get_bin_id_of_path(path)
        by_bin.setdefault(b, []).append(path)
    for path in sorted(part_paths):
        b = get_bin_id_of_path(path)
        by_bin.setdefault(b, []).append(path)
    return by_bin


def _generation_of_relpath(rel):
    m = GENERATION_DIR_RE.match(rel.split(os.sep, 1)[0])
    return int(m.group(1)) if m else 0


def _pack_shape_of_first(paths):
    """Packed row shape of the first (sorted) shard, or None — one footer
    read is enough: within one producer run the shape is schema-level
    constant, and cross-run drift is what the caller refuses on."""
    from ..preprocess.packing import pack_shape_of_parquet
    for p in sorted(paths):
        return pack_shape_of_parquet(p)
    return None


def _check_packed_shape(root, inputs, prior_bins):
    """The delta balancer learns the packed row shape: delta part files
    must be packed against the SAME (budget, max_per_row) the prior
    generations fixed — mixing packed and unpacked rows (or two budgets)
    in one directory would give the loader rows of two incompatible
    shapes. The ingest fingerprint already freezes this for the service;
    this guard catches manual misuse of the balancer API."""
    in_paths = [p for paths in inputs.values() for p in paths]
    prior_rels = [os.path.join(root, rel)
                  for bins in prior_bins.values() for rel, _ in bins]
    if not in_paths or not prior_rels:
        return
    delta_shape = _pack_shape_of_first(in_paths)
    prior_shape = _pack_shape_of_first(prior_rels)
    if delta_shape != prior_shape:
        raise ValueError(
            "delta and prior shards disagree on the packed row shape "
            "(delta {}, prior {}); the ingest configuration drifted — "
            "packed corpora must append deltas packed against the same "
            "pack_seq_length/pack_max_per_row".format(
                delta_shape or "unpacked", prior_shape or "unpacked"))


def _prior_by_bin(prior):
    """{bin_id: [(relpath, count)]} from the prior snapshot, each bin's
    shards ordered by (generation, relpath) — so the deterministic
    'tail' the flush moves index from the end of is the NEWEST
    generation's shards, and generation 0's bulk is the last thing a
    flush would ever touch."""
    by_bin = {}
    for rel in sorted(prior, key=lambda r: (_generation_of_relpath(r), r)):
        by_bin.setdefault(get_bin_id_of_path(rel), []).append(
            (rel, int(prior[rel])))
    return by_bin


def stage_delta_balance(root, generation, part_paths, stage_dir, *,
                        prior, carry_in_paths=(), num_shards=8,
                        flush=False, log=None):
    """Phase 1: compute the delta plan and stage every output file under
    ``stage_dir``; publish the ``plan.json`` marker last. Nothing in the
    dataset root is touched. Returns the plan dict.

    - ``prior``: {relpath: count} snapshot of the existing shards (empty
      for generation 0, which becomes a classic full balance of the delta
      into the root).
    - ``carry_in_paths``: the previous generation's carryover shards,
      consumed ahead of the new part files.
    - ``num_shards``: shard count for generation 0 and for bins the prior
      generations have never seen.
    """
    log = log or (lambda msg: None)
    inputs = _bin_inputs(part_paths, carry_in_paths)
    prior_bins = _prior_by_bin(prior)
    _check_packed_shape(root, inputs, prior_bins)
    if inputs and prior_bins:
        in_binned = set(inputs) != {None}
        prior_binned = set(prior_bins) != {None}
        if in_binned != prior_binned:
            raise ValueError(
                "delta and prior shards disagree on binning (delta bins "
                "{}, prior bins {}); the ingest configuration drifted".format(
                    sorted(map(bin_key_of, inputs)),
                    sorted(map(bin_key_of, prior_bins))))
    plan = {"generation": generation, "bins": {}, "flush": bool(flush),
            "target": "" if generation == 0
                      else generation_dir_name(generation)}
    visible_bins = {b for b in prior_bins if b is not None}

    for b in sorted(inputs, key=lambda x: (-1 if x is None else x)):
        paths = inputs[b]
        counts = [get_num_samples_of_parquet(p) for p in paths]
        total = sum(counts)
        if total == 0:
            continue
        key = bin_key_of(b)
        bin_plan = {"new": {}, "touched": {}, "carry": {}, "consumed": 0,
                    "inputs": total}
        plan["bins"][key] = bin_plan
        prior_bin = prior_bins.get(b, [])

        if not prior_bin:
            defer = None
            if prior_bins and b is not None and visible_bins and not (
                    min(visible_bins) - 1 <= b <= max(visible_bins) + 1):
                # The loader requires a gap-free bin range; a delta-only
                # bin far from the existing range would poison the whole
                # directory, so its rows wait in carryover until the
                # range grows to meet it. (Generation 0 accepts whatever
                # bins the corpus produces — classic-pipeline parity.)
                defer = ("bin {} would leave a gap next to the existing "
                         "bins {}..{}".format(b, min(visible_bins),
                                              max(visible_bins)))
            elif prior_bins and total < num_shards:
                defer = ("new bin {} has {} row(s), fewer than {} "
                         "shards".format(key, total, num_shards))
            if defer is not None:
                log("delta balance: deferring {} row(s) to carryover "
                    "({})".format(total, defer))
                table = _read_concat(paths)
                name = carry_basename(generation, b)
                _stage_table(table, os.path.join(stage_dir, "carry", name))
                bin_plan["carry"][name] = total
                continue
            # Generation 0 (or a brand-new contiguous bin): classic full
            # balance of the delta itself — this FIXES the bin's row
            # budget m for every later generation.
            if total < num_shards:
                raise ValueError(
                    "cannot balance {} samples into {} shards; every "
                    "shard must receive at least one sample".format(
                        total, num_shards))
            from .balancer import compute_targets
            sizes = compute_targets(total, num_shards)
            table = _read_concat(paths)
            offset = 0
            for i, n in enumerate(sizes):
                name = "shard-{}{}".format(i, shard_suffix(b))
                _stage_table(table.slice(offset, n),
                             os.path.join(stage_dir, "new", name))
                bin_plan["new"][name] = n
                offset += n
            bin_plan["consumed"] = total
            if b is not None:
                visible_bins.add(b)
            continue

        prior_counts = [c for _, c in prior_bin]
        m, G, plus_new, carry = plan_bin_delta(prior_counts, total)
        if carry and flush:
            try:
                plan_flush(prior_counts, m, carry)
            except ValueError:
                # Neither a ±1 absorb nor a ±1 pull can place the
                # remainder (few shards, large leftover): the "minimum
                # set of prior shards to touch" degenerates to the whole
                # bin, so rebalance it outright — still staged and
                # published like every other delta, just with every
                # prior shard of this bin in the touched set.
                _stage_full_bin_rebalance(root, stage_dir, b, prior_bin,
                                          paths, total, G, bin_plan, log)
                continue
        sizes = [m + 1] * plus_new + [m] * (G - plus_new)
        table = _read_concat(paths)
        offset = 0
        for i, n in enumerate(sizes):
            name = "shard-{}{}".format(i, shard_suffix(b))
            _stage_table(table.slice(offset, n),
                         os.path.join(stage_dir, "new", name))
            bin_plan["new"][name] = n
            offset += n
        bin_plan["consumed"] = offset
        remainder = table.slice(offset)

        if carry and flush:
            move, k = plan_flush(prior_counts, m, carry)
            if move == "absorb":
                # Append one remainder row to each of the last k prior
                # shards currently at m (tail-first, deterministic).
                targets = [rc for rc in prior_bin if rc[1] == m][-k:]
                for j, (rel, c) in enumerate(targets):
                    prior_table = rio.read_table(os.path.join(root, rel))
                    merged = pa.concat_tables(
                        [prior_table, remainder.slice(j, 1)])
                    _stage_table(merged, _touched_stage_path(stage_dir, rel))
                    bin_plan["touched"][rel] = c + 1
            else:
                # One more full shard: remainder + the last row of each of
                # the last k prior shards currently at m+1.
                donors = [rc for rc in prior_bin if rc[1] == m + 1][-k:]
                donated = []
                for rel, c in donors:
                    prior_table = rio.read_table(os.path.join(root, rel))
                    donated.append(prior_table.slice(c - 1, 1))
                    _stage_table(prior_table.slice(0, c - 1),
                                 _touched_stage_path(stage_dir, rel))
                    bin_plan["touched"][rel] = c - 1
                extra = pa.concat_tables([remainder] + donated)
                name = "shard-{}{}".format(G, shard_suffix(b))
                _stage_table(extra, os.path.join(stage_dir, "new", name))
                bin_plan["new"][name] = extra.num_rows
            bin_plan["consumed"] = total
        elif carry:
            name = carry_basename(generation, b)
            _stage_table(remainder, os.path.join(stage_dir, "carry", name))
            bin_plan["carry"][name] = carry

    rio.atomic_write(os.path.join(stage_dir, PLAN_NAME),
                     json.dumps(plan, sort_keys=True))
    return plan


def _stage_full_bin_rebalance(root, stage_dir, bin_id, prior_bin, paths,
                              delta_total, G, bin_plan, log):
    """Flush fallback: re-slice one whole bin (prior shards in tail order,
    then the delta stream) into ``len(prior) + G`` exactly-balanced
    shards. Every prior shard of the bin is rewritten in place; the ``G``
    new shards still land in the generation directory."""
    from .balancer import compute_targets
    prior_tables = [rio.read_table(os.path.join(root, rel))
                    for rel, _ in prior_bin]
    table = pa.concat_tables(prior_tables + [_read_concat(paths)])
    total = table.num_rows
    s_new = len(prior_bin) + G
    targets = compute_targets(total, s_new)
    log("delta balance: flush rebalances whole bin {} ({} prior "
        "shard(s) rewritten)".format(bin_key_of(bin_id), len(prior_bin)))
    offset = 0
    for (rel, _), n in zip(prior_bin, targets[:len(prior_bin)]):
        _stage_table(table.slice(offset, n),
                     _touched_stage_path(stage_dir, rel))
        bin_plan["touched"][rel] = n
        offset += n
    for i, n in enumerate(targets[len(prior_bin):]):
        name = "shard-{}{}".format(i, shard_suffix(bin_id))
        _stage_table(table.slice(offset, n),
                     os.path.join(stage_dir, "new", name))
        bin_plan["new"][name] = n
        offset += n
    bin_plan["consumed"] = delta_total


def _touched_stage_path(stage_dir, relpath):
    return os.path.join(stage_dir, "touched", relpath.replace(os.sep, "__"))


def read_plan(stage_dir):
    """The staged plan, or None when staging never completed (the marker
    is published only after every staged file exists)."""
    rec, status = rio.read_json(os.path.join(stage_dir, PLAN_NAME))
    if status != "ok" or not isinstance(rec, dict):
        return None
    return rec


def publish_delta_balance(root, stage_dir, plan, *, carry_dir, log=None):
    """Phase 2: copy staged bytes into the dataset. Idempotent — staged
    files survive until the caller's final cleanup, so a crashed publish
    simply re-runs (byte-identically: the plan is frozen). New-generation
    shards land under the plan's target dir (stale non-plan names are
    removed first, file by file — never an rmtree, so a reader mid-epoch
    never sees a published path vanish), touched prior shards are
    atomically replaced in the root, carryover lands under ``carry_dir``.
    All copies are zero-memory ``atomic_copy`` (hard-link + rename).
    Returns {"new": {relpath: count}, "touched": {...},
    "carry": {bin_key: basename}}."""
    log = log or (lambda msg: None)
    target = os.path.join(root, plan["target"]) if plan["target"] else root
    if plan["target"] and os.path.isdir(target):
        # Remove stale NAMES a crashed attempt may have left, but never
        # rmtree the directory: a plan resumed from its intake record is
        # deterministic, so re-published files are byte-identical and
        # land via atomic replace — a follow-mode loader that (behind a
        # prematurely advanced gate, e.g. a crash between the gate write
        # and the journal commit) is already streaming these shards
        # never sees a vanished path. Bookkeeping dotfiles stay; they
        # are refreshed after publish.
        expected = {name for key in plan["bins"]
                    for name in plan["bins"][key]["new"]}
        for name in sorted(os.listdir(target)):
            if name in expected or name.startswith("."):
                continue
            try:
                os.remove(os.path.join(target, name))
            except FileNotFoundError:
                pass
    published = {"new": {}, "touched": {}, "carry": {}}
    bytes_new = bytes_rewritten = 0
    for key in sorted(plan["bins"]):
        bin_plan = plan["bins"][key]
        for name in sorted(bin_plan["new"]):
            staged = os.path.join(stage_dir, "new", name)
            os.makedirs(target, exist_ok=True)
            rio.atomic_copy(staged, os.path.join(target, name))
            rel = os.path.join(plan["target"], name) if plan["target"] \
                else name
            published["new"][rel] = bin_plan["new"][name]
            bytes_new += os.path.getsize(staged)
        for rel in sorted(bin_plan["touched"]):
            staged = _touched_stage_path(stage_dir, rel)
            rio.atomic_copy(staged, os.path.join(root, rel))
            published["touched"][rel] = bin_plan["touched"][rel]
            bytes_rewritten += os.path.getsize(staged)
        for name in sorted(bin_plan["carry"]):
            staged = os.path.join(stage_dir, "carry", name)
            os.makedirs(carry_dir, exist_ok=True)
            rio.atomic_copy(staged, os.path.join(carry_dir, name))
            published["carry"][key] = name
    if obs.enabled():
        obs.inc("ingest_shard_bytes_appended_total", bytes_new)
        if bytes_rewritten:
            obs.inc("ingest_shard_bytes_rewritten_total", bytes_rewritten)
    log("delta balance: published {} new shard(s), {} touched prior "
        "shard(s), {} carry file(s)".format(
            len(published["new"]), len(published["touched"]),
            len(published["carry"])))
    return published
