"""Elastic multi-host preprocessing: the lease-fenced work-stealing loop.

Counterpart of ``lddl_tpu/preprocess/steal.py``. The static runner
(:mod:`.runner`) schedules units by rank striding and meets at barriers:
one dead host wedges the phase. This module replaces the schedule with a
**claim loop** over the same units: N independent host processes (no
process group, no barriers, nothing shared but the output directory)
each repeatedly

    1. pick a unit whose completion record is absent,
    2. claim it via an atomic-rename lease (:mod:`..resilience.leases`),
    3. sweep any previous attempt's partial outputs,
    4. run it (serially or on the host's local spawn pool),
    5. fence-check the lease and, only if still held at the claimed
       epoch, journal the completion record,

until every unit is journaled. A host that dies mid-unit stops renewing
its lease; after one TTL any survivor steals the unit (epoch bump),
sweeps the debris and redoes it. A host that *stalls* and wakes after a
steal fails the fence check and discards its late result
(``lease_fence_rejects_total``): the ledger sees one winner per unit.

Determinism contract: a unit's output bytes are a pure function of the
resume fingerprint and the unit id. Leases decide WHO runs a unit, never
what it produces, so an elastic run of any host count, with any sequence
of host deaths, is byte-identical to a static single-host run of the
same plan (``tests/test_torch_elastic.py`` holds it against a live
static ``lddl_tpu`` run).

Unit kinds and their fencing:

- **scatter slices** (blocks of the plan): spool appends are not
  idempotent, so every claim attempt writes its own files
  ``group-<g>/s<slice>.e<epoch>.<holder>.txt`` and the completion record
  stores the winning ``(epoch, holder)``. The gather reads ONLY the
  recorded file names: a fenced-off zombie's late appends land in files
  nothing reads.
- **gather groups** (coarse spool groups) / **blocks** (no-shuffle mode):
  outputs are whole shard files published atomically under deterministic
  names, so a zombie rewriting them writes the same bytes; the fence
  protects the ledger record itself.
- **finalize** (manifest + cleanup) is itself a lease-guarded unit: the
  last host out runs it, and if it dies mid-finalize a survivor steals
  that too. The lease directory is removed last: its disappearance is
  the "run complete" signal waiting hosts poll for.

Every unit's lifecycle (claimed, renewed, stolen, fenced, failed,
journaled) is also reported to the fleet telemetry
(``observability/fleet.py``) when it is armed. What a spawned pool worker
imports (this module, the runner, the leases) loads no torch.
"""


import concurrent.futures as cf
import hashlib
import json
import logging
import os
import shutil
import time

from .. import observability as obs
from ..resilience import io as rio
from ..resilience import leases
from . import runner as _runner

_FINALIZE_UNIT = "finalize"
_SCATTER_PREFIX = "scatter-"
_GROUP_PREFIX = "group-"
_BLOCK_PREFIX = "block-"

_log = logging.getLogger("lddl_tpu_torch.preprocess.steal")


def _fence_for(out_dir, prefix, unit, epoch, holder, deadline=0.0):
    """A fence closure for unit bodies (works across the pool process
    boundary: everything needed to re-check the lease travels as plain
    values and the closure is rebuilt inside the worker). Deadline-cached
    via :func:`leases.fence_at` — while the wall clock is inside the last
    deadline the fence read (seeded with the claim-time ``deadline`` when
    the submitter passes it), the check costs no filesystem op; past it,
    a real read refreshes from the keeper-renewed record. False once the
    unit's lease stops naming exactly this (holder, epoch) attempt."""
    root = leases.lease_root(out_dir)
    key = "{}{}".format(prefix, unit)
    return leases.fence_at(root, key, holder, epoch, deadline=deadline)


# ------------------------------------------------------------ unit records


def _scatter_record_path(out_dir, unit):
    return os.path.join(out_dir, _runner._LEDGER_DIR,
                        "scatter-{}.json".format(unit))


def _read_scatter_record(out_dir, unit):
    """A scatter slice's completion record ({"epoch", "holder"}), or None.
    Torn bytes degrade to "not done" with a warning, like `_ledger_read`."""
    rec, status = rio.read_json(_scatter_record_path(out_dir, unit))
    if status == "torn":
        _log.warning("torn scatter record for unit %s; treating as not "
                     "done", unit)
        return None
    return rec if isinstance(rec, dict) else None


def _publish_scatter_record(out_dir, unit, lease, wall=None):
    """Journal a completed scatter slice. The record IS the epoch fence
    for spool bytes: it names the one (epoch, holder) attempt whose files
    the gather may read — so lease state flowing into this _done record
    is the design, not a leak (it never reaches shard bytes or
    .manifest.json).
    ``wall`` (a monotonic duration, seconds — never a wall-clock instant)
    rides probe records so the adaptive plan can size the remaining units
    from observed throughput; like epoch/holder it stays scheduling
    state, retired with the ledger at finalize.

    Returns the journaled record dict on success (the claim loop feeds it
    to incremental consumers), False on a post-publish fence loss."""
    path = _scatter_record_path(out_dir, unit)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    record = {"epoch": lease.epoch, "holder": lease.holder}
    if wall is not None:
        record["wall"] = round(float(wall), 6)
    payload = json.dumps(record, sort_keys=True)
    # Fence record by design (see docstring): epoch+holder+probe wall,
    # never shard bytes.
    rio.atomic_write(path, payload)
    # Post-publish fence re-check: if the lease was stolen in the tiny
    # window between the pre-publish verify and this write, the thief may
    # ALREADY have journaled its own record — which our stale write just
    # clobbered with file names the thief swept. Re-read: if the record on
    # disk is ours but the lease is not, withdraw it so the unit is redone
    # rather than pointing at deleted spool files.
    if not leases.verify(lease):
        cur = _read_scatter_record(out_dir, unit)
        if cur == record:
            # Backend-routed withdrawal: on the mock store a raw unlink
            # would leave the record's commit records readable.
            rio.remove(path)
        _prune_empty_scaffolding(out_dir)
        return False
    return record


def _prune_empty_scaffolding(out_dir):
    """Best-effort removal of `_done`/`_leases` dirs a zombie's late write
    resurrected AFTER finalize retired them (os.makedirs inside the
    publish/acquire paths recreates the dir). rmdir only succeeds on
    empty dirs, so a live run's scaffolding is never touched."""
    for d in (os.path.join(out_dir, _runner._LEDGER_DIR),
              leases.lease_root(out_dir)):
        try:
            os.rmdir(d)
        # Non-empty (live run) or already gone: both fine by design.
        except OSError:
            pass


def _publish_gather_record(out_dir, unit, result, lease):
    """Journal a completed gather unit, with the same post-publish fence
    re-check the scatter path has: if the lease was lost in the window
    between the claim loop's verify and this write, the record is
    withdrawn — a stalled zombie must not resurrect `_done/` inside an
    already-finalized output dir (and in the live-thief case a withdrawn
    record merely makes the unit's owner republish identical bytes).
    Returns the journaled record (= ``result``) on success so the
    incremental gather can consume it without re-reading the ledger."""
    _runner._ledger_write(out_dir, unit, result)
    if not leases.verify(lease):
        rio.remove(_runner._ledger_path(out_dir, unit))
        _prune_empty_scaffolding(out_dir)
        return False
    return result


def spool_name(unit, epoch, holder):
    """The exclusive spool file name of one scatter claim attempt (per
    coarse group). Epoch+holder make every attempt's files disjoint."""
    return "s{}.e{}.{}.txt".format(unit, epoch, holder)


# --------------------------------------------------- adaptive unit sizing
#
# Fixed scatter units make small corpora coordination-bound: the lease
# acquire/renew/fence cost per unit is flat regardless of how little work
# the unit holds. Adaptive mode probes first — a few small leading slices
# whose completion records carry their observed wall — then one
# lease-guarded PLAN unit sizes the remaining blocks into contiguous
# ranges targeting a wall of K × (measured lease round-trip). The plan is
# journaled in ``_done/scatter-plan.json`` so every host (and every
# resume) partitions identically; byte identity is untouched either way
# because the gather sorts blocks by block id across the whole accept set
# — unit boundaries only ever decide WHO spools a block, never where its
# text lands.

_PLAN_UNIT = "scatter-plan"
_PLAN_TARGET_K = 64.0


def _probe_layout(nblocks):
    """The fixed leading probe slices: up to 4 contiguous ranges covering
    at most ~1/8 of the blocks (1 block each on small plans). Deterministic
    in nblocks alone, so every host agrees on probe identity before any
    coordination happens."""
    n_probe = min(nblocks, 4)
    if n_probe <= 0:
        return []
    span = max(1, nblocks // (8 * n_probe))
    return [("p{}".format(i), i * span, (i + 1) * span)
            for i in range(n_probe)]


def _scatter_unit_blocks(spec, unit, nblocks):
    """The block indices one scatter unit owns. String units are probes
    (contiguous leading ranges); int units are plan ranges when an
    adaptive plan is loaded, else the classic ``unit, unit+S, ...``
    stride of fixed mode."""
    if isinstance(unit, str):
        for key, s, e in _probe_layout(nblocks):
            if key == unit:
                return range(s, min(e, nblocks))
        raise ValueError("unknown probe unit {!r}".format(unit))
    plan = spec.get("scatter_plan")
    if plan is not None:
        s, e = plan["main"][int(unit)]
        return range(s, min(e, nblocks))
    return range(unit, nblocks, spec["scatter_units"])


def _plan_record_path(out_dir):
    return os.path.join(out_dir, _runner._LEDGER_DIR,
                        "{}.json".format(_PLAN_UNIT))


def _read_plan_record(out_dir):
    rec, status = rio.read_json(_plan_record_path(out_dir))
    if status == "torn":
        _log.warning("torn scatter plan record; treating as absent")
        return None
    if isinstance(rec, dict) and isinstance(rec.get("main"), list):
        return rec
    return None


def _read_plan_stable(out_dir, poll):
    """Double-read the plan record (same clobber-then-withdraw window
    argument as :func:`_stable_scatter_records`): a plan must never be
    adopted from a fenced loser's transient record, because two hosts
    running DIFFERENT partitions under the same unit indices would journal
    ranges that don't line up."""
    first = _read_plan_record(out_dir)
    if first is None:
        return None
    time.sleep(min(poll, 0.05))
    second = _read_plan_record(out_dir)
    return second if second == first else None


def _lease_overhead_s(lease):
    """Measured lease round-trip (read + match), the unit-sizing yardstick.
    Monotonic durations only — the plan never sees a wall-clock instant."""
    t0 = time.monotonic()
    for _ in range(3):
        leases.verify_at(lease.root, lease.unit, lease.holder, lease.epoch)
    return max((time.monotonic() - t0) / 3.0, 1e-6)


def _compute_plan(out_dir, probes, nblocks, lease):
    """Size the post-probe blocks into contiguous ranges whose predicted
    wall is ~K× the measured lease overhead (clamped to [2s, 120s]), with
    at least min(rest, 8) units so a small corpus still fans out across
    hosts. Probe records missing a wall (fenced redo races) simply don't
    vote; with no votes at all the split degrades to the fixed-mode
    formula — the plan only ever shapes scheduling, never bytes."""
    import math
    walls, probed = [], 0
    for key, s, e in probes:
        rec = _read_scatter_record(out_dir, key)
        w = rec.get("wall") if isinstance(rec, dict) else None
        if isinstance(w, (int, float)) and w >= 0:
            walls.append(float(w))
            probed += max(1, min(e, nblocks) - s)
    covered = min(probes[-1][2], nblocks) if probes else 0
    rest = max(0, nblocks - covered)
    plan = {"epoch": lease.epoch, "holder": lease.holder, "main": []}
    if rest == 0:
        return plan
    if walls:
        per_block = max(sum(walls) / max(probed, 1), 1e-6)
        target = min(max(_PLAN_TARGET_K * _lease_overhead_s(lease), 2.0),
                     120.0)
        per_unit = max(1, int(target / per_block))
        n_units = min(rest, max(min(rest, 8),
                                int(math.ceil(rest / float(per_unit)))))
        plan["per_block_s"] = round(per_block, 6)
        plan["target_wall_s"] = round(target, 3)
    else:
        n_units = min(rest, max(8, rest // 16))
    base, extra = divmod(rest, n_units)
    start = covered
    for i in range(n_units):
        size = base + (1 if i < extra else 0)
        plan["main"].append([start, start + size])
        start += size
    return plan


def _ensure_plan(spec, probes, nblocks, holder, ttl, keeper, poll, log):
    """Read-or-compute the adaptive scatter plan, exactly-once via the
    ``scatter-plan`` lease (crash-tolerant like every other unit: a dead
    planner's lease expires and a survivor recomputes from the journaled
    probe walls). The plan is coordination metadata, not a work unit — it
    does not count toward ``elastic_units_completed_total`` and emits no
    ``unit.journaled`` event. Returns None when another host already
    finalized the whole run."""
    out_dir = spec["out_dir"]
    root = leases.lease_root(out_dir)
    ledger_dir = os.path.join(out_dir, _runner._LEDGER_DIR)
    while True:
        rec = _read_plan_stable(out_dir, poll)
        if rec is not None:
            return rec
        if not os.path.isdir(ledger_dir):
            return None  # finalized under us
        lease = leases.try_acquire(root, _PLAN_UNIT, holder, ttl)
        if lease is None:
            time.sleep(poll)
            continue
        keeper.add(lease)
        try:
            rec = _read_plan_record(out_dir)  # post-acquire re-check
            if rec is not None:
                return rec
            plan = _compute_plan(out_dir, probes, nblocks, lease)
            if not leases.verify(lease):
                continue
            path = _plan_record_path(out_dir)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            payload = json.dumps(plan, sort_keys=True)
            # Scheduling metadata fenced like a scatter record (see
            # _publish_scatter_record): epoch/holder + monotonic durations.
            rio.atomic_write(path, payload)
            if not leases.verify(lease):
                cur = _read_plan_record(out_dir)
                if cur == plan:
                    rio.remove(path)
                _prune_empty_scaffolding(out_dir)
                continue
            log("elastic scatter: adaptive plan journaled ({} probe(s) + "
                "{} main unit(s) over {} blocks)".format(
                    len(probes), len(plan["main"]), nblocks))
            return plan
        finally:
            keeper.remove(lease)
            leases.release(lease)


def _stable_scatter_records(out_dir, scatter_units, lease_root, ttl, poll):
    """Read every scatter record until two consecutive sweeps agree.

    Returns ``("ok", {unit: record})``, ``("finalized", None)`` when
    another host already finalized the whole run, or ``("retry", None)``
    when a record is missing with no live lease — a fenced loser's
    clobber-then-withdraw transiently un-journaled the unit and the
    withdrawer died before redoing it, so the caller must re-enter the
    claim loop. The double read closes the window in which an accept set
    built from a loser's transient record would name spool files the
    winner's sweep deleted; what remains requires two suspensions at
    exactly the wrong microseconds AND is still bounded by this
    function's own re-read."""
    ledger_dir = os.path.join(out_dir, _runner._LEDGER_DIR)
    patience = max(2.0 * ttl, 3.0)
    deadline = time.monotonic() + patience
    prev = None
    while True:
        if not os.path.isdir(ledger_dir):
            return "finalized", None
        recs = {}
        missing = None
        for u in scatter_units:
            rec = _read_scatter_record(out_dir, u)
            if rec is None:
                missing = u
                break
            recs[u] = rec
        if missing is None:
            if recs == prev:
                return "ok", recs
            prev = recs
            time.sleep(min(poll, 0.05))
            continue
        prev = None
        if leases.is_live(lease_root,
                          "{}{}".format(_SCATTER_PREFIX, missing)):
            # Someone is actively republishing/redoing it: keep waiting.
            deadline = time.monotonic() + patience
        elif time.monotonic() >= deadline:
            return "retry", None
        time.sleep(poll)


# -------------------------------------------------------------- unit tasks
#
# Module-level so spawn pools can pickle them; serial mode calls them
# directly via closures built in run_elastic_pipeline. All take
# (unit, epoch, holder, deadline) so the claimed attempt's identity
# reaches the spool file names and the claim-time lease deadline seeds
# the worker-side fence cache.


def _scatter_slice(spec, unit, epoch, holder, deadline=0.0):
    """Scatter all blocks of one slice (:func:`_scatter_unit_blocks` —
    a fixed stride, a probe range, or a plan range) into this attempt's
    exclusive spool files, self-terminating between blocks if the lease
    is stolen (appends after a steal would only be debris — fenced out by
    name — but stopping early keeps the thief's sweep meaningful and the
    host honest)."""
    input_files = _runner.discover_source_files(spec["corpus_paths"])
    blocks = _runner.plan_blocks(input_files, spec["num_blocks"])
    name = spool_name(unit, epoch, holder)
    fence = _fence_for(spec["out_dir"], _SCATTER_PREFIX, unit, epoch, holder,
                       deadline=deadline)
    n = 0
    for b in _scatter_unit_blocks(spec, unit, len(blocks)):
        _runner._check_fence(fence, unit)
        _runner._spool_one_block(blocks[b], spec["out_dir"], spec["seed"],
                                 spec["sample_ratio"], len(blocks),
                                 spec["ngroups"], name)
        n += 1
    return n


def _pool_scatter_slice(unit, epoch, holder, deadline=0.0):
    return _scatter_slice(_runner._POOL["spec"], unit, epoch, holder,
                          deadline=deadline)


def _pool_gather_group(unit, epoch, holder, deadline=0.0):
    spec = _runner._POOL["spec"]
    return _runner._run_group(
        spec, _runner._POOL["process_bucket"], unit,
        fence=_fence_for(spec["out_dir"], _GROUP_PREFIX, unit, epoch,
                         holder, deadline=deadline))


def _pool_block_bucket(unit, epoch, holder, deadline=0.0):
    spec = _runner._POOL["spec"]
    return _runner._run_block_bucket(
        spec, _runner._POOL["process_bucket"], unit,
        fence=_fence_for(spec["out_dir"], _BLOCK_PREFIX, unit, epoch,
                         holder, deadline=deadline))


# ------------------------------------------------------------------ sweeps


def _sweep_scatter(spec, unit):
    """Remove EVERY attempt's spool files for a reclaimed scatter slice
    (all epochs/holders: only the attempt about to run may have files)."""
    import glob
    pattern = os.path.join(spec["out_dir"], _runner._SPOOL_DIR, "group-*",
                           "s{}.e*".format(unit))
    n = 0
    for path in sorted(glob.glob(pattern)):
        try:
            os.remove(path)
            n += 1
        except FileNotFoundError:
            pass
    if n:
        obs.inc("elastic_swept_files_total", int(n))
    return n


def _sweep_gather(spec, unit):
    """Remove a reclaimed gather group's partial bucket outputs (final
    part files AND ``*.tmp.*`` atomic-write debris — the exact-prefix
    globs in `_clean_bucket_outputs` cover both)."""
    for bucket in _runner._buckets_of_group(unit, spec["nbuckets"],
                                            spec["ngroups"]):
        _runner._clean_bucket_outputs(spec["out_dir"], bucket)


def _sweep_block(spec, unit):
    _runner._clean_bucket_outputs(spec["out_dir"], unit)


# -------------------------------------------------------------- claim loop


class _InlineExecutor(object):
    """Executor shim for serial hosts: submit() runs the task inline and
    returns an already-settled Future, so the claim loop has one shape."""

    def submit(self, fn, *args):
        fut = cf.Future()
        try:
            fut.set_result(fn(*args))
        except BaseException as e:  # noqa: BLE001 - future carries it
            fut.set_exception(e)
        return fut

    def shutdown(self, wait=True):
        pass


def _rotated(units, holder):
    """Deterministic per-holder rotation of the unit scan order, so N
    hosts starting together fan out across the unit space instead of
    racing for unit 0. Pure scheduling: never shapes output bytes."""
    order = sorted(units)
    if not order:
        return order
    start = int.from_bytes(
        hashlib.blake2b(holder.encode(), digest_size=4).digest(),
        "little") % len(order)
    return order[start:] + order[:start]


def claim_loop(spec, phase, unit_prefix, units, *, holder, ttl, keeper,
               is_done, sweep, task, publish, executor_factory, max_inflight,
               log, poll, progress_interval=5.0, ledger_name=None,
               on_record=None, unit_walls=None):
    """Run every unit to completion across all participating hosts.

    Returns a stats dict. Raises RuntimeError (with the standard
    "re-run with resume" message) if units failed on this host and no
    other host completed them within the patience window.

    - ``is_done(unit)`` — the unit's completion record, or None when not
      done. Done-ness is record EXISTENCE (``is not None``): an empty
      ``{}`` record from a zero-sample unit is still done.
    - ``sweep(unit)`` — remove a prior attempt's partial outputs; called
      on EVERY claim before running (cheap no-op on first attempts).
    - ``task(unit, epoch, holder, deadline)`` — the unit body; picklable
      when an ``executor_factory`` is given (spawn pool), else any
      callable. ``deadline`` is the claim-time lease deadline, seeding
      the body's deadline-cached fence (``leases.fence_at``).
    - ``publish(unit, result, lease)`` — journal completion; called only
      after the fence check passed. May return False to signal a
      post-publish fence loss (the unit stays pending); any other return
      value is treated as the journaled record.
    - ``ledger_name(unit)`` — the unit's completion-record FILE NAME.
      When given (and ``LDDL_TPU_COORD_LEGACY`` is unset), each scan pass
      snapshots the ledger dir and the lease dir ONCE and skips per-unit
      ``is_done``/lease reads that the snapshots already answer; every
      decision that matters (post-acquire re-check, fence, publish) still
      rides a real read, so a stale snapshot costs at most one extra pass.
    - ``on_record(unit, record)`` — fired once per unit the first time
      its completion record is observed (pre-done at entry, discovered
      mid-scan, found post-acquire, or journaled by this host). Lets the
      gather consume records incrementally instead of barriering.
    - ``unit_walls`` — optional dict filled with each locally-completed
      unit's monotonic task wall (seconds); probe publishes read it so
      observed throughput reaches the adaptive plan.
    - ``poll`` — seconds to wait on in-flight units, or before a rescan
      while every remaining unit is held elsewhere.
    """
    from concurrent.futures.process import BrokenProcessPool

    lease_root = leases.lease_root(spec["out_dir"])
    ledger_dir = os.path.join(spec["out_dir"], _runner._LEDGER_DIR)
    use_snapshot = ledger_name is not None and not leases.legacy_coordination()
    held_cache = {} if use_snapshot else None
    seen_records = set()

    def record_seen(unit, rec):
        if on_record is not None and rec is not None \
                and unit not in seen_records:
            seen_records.add(unit)
            on_record(unit, rec)

    def list_ledger():
        """One listing of ``_done`` per scan pass (backend-routed: on the
        mock store this is the ``list`` fault site, so a fault run can
        serve a stale snapshot here): a name absent from the snapshot is
        definitely not journaled (records only ever appear; they are
        withdrawn so rarely the next pass absorbs it), so the per-unit
        is_done read is skipped for it. A STALE listing only delays
        discovery by one pass — record reads, not listings, are what the
        claim loop trusts for done-ness."""
        names = rio.list_dir(ledger_dir)
        return set() if names is None else set(names)

    def run_finalized():
        """True once another host's finalize has retired the ledger. The
        finalizer renames ``_done`` away atomically before deleting it, so
        "completion record missing AND ledger dir missing" unambiguously
        means "everything finished" — never "unit needs redoing". Without
        this, a host racing the finalize would reclaim a finished unit,
        sweep its FINAL outputs, and regenerate them from a spool that no
        longer exists."""
        return not os.path.isdir(ledger_dir)

    stats = {"units": len(units), "completed": 0, "stolen": 0,
             "fence_rejects": 0, "already_done": 0}
    # Done-ness is "a record EXISTS", never record truthiness: a gather
    # unit whose buckets produced zero samples journals a legitimately
    # empty {} record, and treating that as "not done" would make every
    # host redo empty units forever (the static resume path compares
    # `is None` for the same reason).
    remaining = set()
    entry_names = list_ledger() if use_snapshot else None
    for u in units:
        if entry_names is not None and ledger_name(u) not in entry_names:
            remaining.add(u)
            continue
        rec = is_done(u)
        if rec is None:
            remaining.add(u)
        else:
            record_seen(u, rec)
    stats["already_done"] = len(units) - len(remaining)
    progress = _runner._Progress(log, phase, len(remaining),
                                 interval_s=progress_interval)
    order = _rotated(units, holder)
    failed = {}
    inflight = {}  # future -> (unit, lease)
    executor = None

    def ensure_executor():
        nonlocal executor
        if executor is None:
            executor = (executor_factory() if executor_factory is not None
                        else _InlineExecutor())
        return executor

    start_times = {}  # future -> monotonic submit time (unit_walls only)

    def drop_inflight(fut):
        unit, lease = inflight.pop(fut)
        started = start_times.pop(fut, None)
        keeper.remove(lease)
        return unit, lease, started

    def fence_reject(unit, lease, why):
        stats["fence_rejects"] += 1
        obs.inc("lease_fence_rejects_total")
        obs.event("lease.fence_reject", unit="{}{}".format(
            unit_prefix, unit), epoch=lease.epoch)
        obs.fleet.record("unit.fenced", unit="{}{}".format(
            unit_prefix, unit), epoch=lease.epoch, holder=holder, why=why)
        log("{}: unit {} {} at epoch {}; late result discarded "
            "(fence)".format(phase, unit, why, lease.epoch))

    def handle_completed(fut):
        unit, lease, started = drop_inflight(fut)
        try:
            result = fut.result()
        except BrokenProcessPool:
            # A dead pool worker breaks the whole pool and names no
            # culprit. Release so any host (us included) can reclaim
            # immediately; the per-claim sweep redoes partial outputs.
            leases.release(lease)
            raise
        except leases.LeaseLost:
            # The unit body self-terminated mid-run (the thief owns the
            # unit now). Not a failure: the winner's record will appear.
            fence_reject(unit, lease, "self-terminated (stolen)")
            return
        except Exception as e:  # noqa: BLE001 - isolate per unit
            if not leases.still_held(lease):
                # An error on a unit we no longer own is zombie noise,
                # not a unit failure: a thief may have swept our spool
                # files mid-append, or a finalizer may already be
                # deleting the run's scaffolding under us.
                fence_reject(unit, lease,
                             "errored after losing its lease "
                             "({}: {})".format(type(e).__name__, e))
                return
            leases.release(lease)
            failed[unit] = "{}: {}".format(type(e).__name__, e)
            obs.fleet.record("unit.failed", unit="{}{}".format(
                unit_prefix, unit), epoch=lease.epoch, holder=holder,
                error=failed[unit][:200])
            remaining.discard(unit)
            log("{}: unit {} failed ({}); lease released for another "
                "host".format(phase, unit, failed[unit]))
            return
        if unit_walls is not None and started is not None:
            unit_walls[unit] = time.monotonic() - started
        if not leases.still_held(lease):
            # Stolen while we ran (we stalled past the deadline): the
            # thief owns the unit now; discard our late result. Inside
            # the deadline this look is free (leases.still_held); the
            # load-bearing fence is publish's post-publish re-verify.
            fence_reject(unit, lease, "was stolen while this host ran it")
            return
        pub = publish(unit, result, lease)
        if pub is False:
            fence_reject(unit, lease, "lost its lease during publish")
            return
        record_seen(unit, pub if isinstance(pub, dict) else result)
        leases.release(lease)
        if lease.epoch > 0:
            stats["stolen"] += 1
        stats["completed"] += 1
        # Label = the phase word ("scatter"/"gather"/"process"), not the
        # constant "elastic" prefix of the display name.
        obs.inc("elastic_units_completed_total", phase=phase.split()[-1])
        obs.fleet.record("unit.journaled", unit="{}{}".format(
            unit_prefix, unit), epoch=lease.epoch, holder=holder,
            phase=phase.split()[-1])
        remaining.discard(unit)
        progress.tick(sum(result.values())
                      if isinstance(result, dict) else 0)

    def drain(timeout):
        if not inflight:
            return
        done, _ = cf.wait(list(inflight), timeout=timeout,
                          return_when=cf.FIRST_COMPLETED)
        for fut in done:
            if fut not in inflight:
                continue  # a pool reset already dropped it
            try:
                handle_completed(fut)
            except BrokenProcessPool:
                nonlocal_executor_reset()

    def nonlocal_executor_reset():
        nonlocal executor
        log("{}: pool worker died; releasing {} in-flight lease(s) and "
            "rebuilding the pool".format(phase, len(inflight)))
        for fut in list(inflight):
            _, lease, _ = drop_inflight(fut)
            leases.release(lease)
        if executor is not None:
            executor.shutdown(wait=False)
            executor = None

    try:
        while remaining:
            claimed_any = False
            inflight_units = {u for u, _ in inflight.values()}
            # Per-pass snapshots (batched coordination): one _done listdir
            # answers "which units are journaled", one _leases scan feeds
            # try_acquire's known_missing fast path, and held_cache skips
            # re-reading leases whose observed deadline hasn't passed.
            pass_names = list_ledger() if use_snapshot else None
            pass_leases = (leases.scan_units(lease_root) if use_snapshot
                           else None)
            for unit in order:
                if len(inflight) >= max_inflight:
                    break
                if unit not in remaining or unit in inflight_units \
                        or unit in failed:
                    continue
                if pass_names is not None \
                        and ledger_name(unit) not in pass_names:
                    rec = None
                else:
                    rec = is_done(unit)
                if rec is not None:
                    record_seen(unit, rec)
                    remaining.discard(unit)
                    progress.tick()
                    continue
                if run_finalized():
                    remaining.clear()
                    break
                key = "{}{}".format(unit_prefix, unit)
                lease = leases.try_acquire(
                    lease_root, key, holder, ttl,
                    known_missing=(pass_leases is not None
                                   and key not in pass_leases),
                    held_cache=held_cache)
                if lease is None:
                    continue  # validly held elsewhere (or race lost)
                rec = is_done(unit)
                if rec is not None:
                    # Completion records publish BEFORE leases release, so
                    # re-checking after the acquire closes the race where
                    # our pre-claim is_done read predated the winner's
                    # publish: without this, we would sweep (and redo) a
                    # unit whose outputs are already final. Always a REAL
                    # read — never the snapshot.
                    record_seen(unit, rec)
                    leases.release(lease)
                    remaining.discard(unit)
                    progress.tick()
                    continue
                if run_finalized():
                    # Checked AFTER the missing-record read, never before:
                    # a finalize landing between the two checks makes a
                    # COMPLETED unit's record read as missing, and
                    # proceeding to sweep would delete final shards the
                    # (already-deleted) spool can't regenerate. Dir still
                    # present here ⇒ the None above was genuine; dir gone
                    # ⇒ everything (including this unit) finished.
                    # try_acquire's makedirs may also have resurrected
                    # _leases in the finalized dir: release and prune.
                    leases.release(lease)
                    _prune_empty_scaffolding(spec["out_dir"])
                    remaining.clear()
                    break
                sweep(unit)
                keeper.add(lease)
                try:
                    # Submit time taken BEFORE submit: the inline executor
                    # runs the task inside submit(), so an after-the-fact
                    # stamp would record a zero wall.
                    t_submit = time.monotonic()
                    fut = ensure_executor().submit(task, unit, lease.epoch,
                                                   holder, lease.deadline)
                except BrokenProcessPool:
                    # The pool broke while we were scanning (a worker died
                    # between drains): submit itself raises. Hand back the
                    # just-claimed lease, tear the pool down, rescan.
                    keeper.remove(lease)
                    leases.release(lease)
                    nonlocal_executor_reset()
                    continue
                if unit_walls is not None:
                    start_times[fut] = t_submit
                inflight[fut] = (unit, lease)
                inflight_units.add(unit)
                claimed_any = True
            if inflight:
                drain(timeout=poll)
            elif not claimed_any and remaining:
                # Everything left is held by other live hosts (or just
                # journaled): wait for records to appear or leases to
                # expire, then rescan.
                time.sleep(poll)
    finally:
        if executor is not None:
            executor.shutdown(wait=False)

    if failed:
        # Another host may still complete what we could not (our failure
        # released the lease). Wait a patience window that resets on any
        # progress — a completed record OR a live lease on the unit
        # (another host actively redoing it renews at ttl/3; its unit may
        # legitimately take many TTLs, so a fixed countdown would raise a
        # spurious failure on a run that globally succeeds).
        patience = max(2.0 * ttl, 3.0)
        deadline = time.monotonic() + patience
        while failed and time.monotonic() < deadline:
            if run_finalized():
                failed.clear()  # everything completed (and was retired)
                break
            progressing = False
            for u in sorted(failed):
                if is_done(u) is not None:
                    failed.pop(u)
                    progressing = True
                elif leases.is_live(lease_root,
                                    "{}{}".format(unit_prefix, u)):
                    progressing = True
            if progressing:
                deadline = time.monotonic() + patience
            if failed:
                time.sleep(poll)
        if failed:
            raise RuntimeError(
                "{} failed for {} unit(s) (this host: {}); completed units "
                "are journaled — re-run with resume=True/--resume to redo "
                "only the failures".format(phase, len(failed), failed))
    return stats


# --------------------------------------------------------------- pipeline


def _pool_factory_for(process_bucket, spec, workers, n_units):
    if workers <= 1 or n_units <= 1:
        return None

    def factory():
        import multiprocessing
        return cf.ProcessPoolExecutor(
            max_workers=min(workers, n_units),
            mp_context=multiprocessing.get_context("spawn"),
            initializer=_runner._pool_init,
            initargs=(process_bucket, spec))

    return factory


def _census_from_disk(out_dir):
    """Recover the {path: rows} census from the output files themselves —
    the fallback when another host finalized (and deleted ``_done``)
    between our last unit and our merge. Parquet rows come from footers;
    txt shards count lines."""
    import glob
    written = {}
    for path in sorted(glob.glob(os.path.join(out_dir, "part.*"))):
        if ".tmp." in path:
            continue
        if ".parquet" in path:
            import pyarrow.parquet as pq
            written[path] = pq.read_metadata(path).num_rows
    for path in sorted(glob.glob(os.path.join(out_dir, "*.txt*"))):
        if ".tmp." in path or os.path.basename(path).startswith("."):
            continue
        written[path] = rio.read_bytes(path).count(b"\n")
    return written


def _merge_census(out_dir, gather_units, census=None, consumed=()):
    """Union of every gather unit's ledger record — the global census (in
    elastic mode hosts do not own disjoint buckets, so every host returns
    the merged totals). Units already consumed incrementally (the
    overlapped gather's ``on_record`` hook) are not re-read: a gather
    unit's record content is a pure function of the plan, so the copy
    consumed in flight equals what a barrier read would see even if the
    record was withdrawn and republished in between. A record missing NOW
    means another host's finalize is already deleting the ledger, and the
    on-disk output files (all final at this point) are the authoritative
    fallback."""
    written = dict(census or {})
    for g in gather_units:
        if g in consumed:
            continue
        rec = _runner._ledger_read(out_dir, g)
        if rec is None:
            _log.info("ledger record for unit %s already cleaned up by "
                      "another host's finalize; recovering the census "
                      "from the output files", g)
            return _census_from_disk(out_dir)
        written.update(rec)
    return written


def _finalize(spec, holder, ttl, keeper, log, poll):
    """Lease-guarded gather-side finalization: integrity manifest, spool/
    ledger/debris cleanup. Exactly-once in the common case; crash-tolerant
    because a dead finalizer's lease expires and a survivor redoes it
    (every step is idempotent: the manifest is deterministic, the rmtrees
    tolerate absence). The lease directory is deleted LAST — waiting
    hosts treat its disappearance as "finalized"."""
    from ..resilience.integrity import build_manifest

    out_dir = spec["out_dir"]
    root = leases.lease_root(out_dir)
    while True:
        if not os.path.isdir(root):
            return False  # another host finished the whole run
        lease = leases.try_acquire(root, _FINALIZE_UNIT, holder,
                                   max(ttl, 5.0))
        if lease is None:
            time.sleep(poll)
            continue
        keeper.add(lease)
        try:
            with obs.span("preprocess.finalize", holder=holder):
                if spec.get("emit_manifest", True):
                    build_manifest(out_dir, log=log)
                if not leases.verify(lease):
                    obs.inc("lease_fence_rejects_total")
                    log("finalize: lease stolen mid-manifest; yielding to "
                        "the new finalizer")
                    time.sleep(poll)
                    continue
                if spec["global_shuffle"]:
                    shutil.rmtree(os.path.join(out_dir, _runner._SPOOL_DIR),
                                  ignore_errors=True)
                # Retire the ledger ATOMICALLY (rename, then delete the
                # renamed dir): hosts still scanning must see either the
                # complete record set or no ledger dir at all — a
                # half-deleted ledger reads as "unit not done" and would
                # trigger a catastrophic reclaim of finished outputs.
                # Stale retired dirs (a finalizer that died between ITS
                # rename and rmtree) are swept FIRST: renaming onto an
                # existing non-empty dir would fail ENOTEMPTY, and a
                # same-holder resume must not mistake that for "already
                # retired" and leave _done/ behind forever.
                import glob
                ledger = os.path.join(out_dir, _runner._LEDGER_DIR)
                for stale in sorted(glob.glob(ledger + ".retired.*")):
                    shutil.rmtree(stale, ignore_errors=True)
                retired = "{}.retired.{}".format(ledger, holder)
                try:
                    os.replace(ledger, retired)
                except FileNotFoundError:
                    retired = None  # already retired by someone else
                if retired is not None:
                    shutil.rmtree(retired, ignore_errors=True)
                _runner._sweep_tmp_debris(out_dir)
                shutil.rmtree(root, ignore_errors=True)
                return True
        finally:
            keeper.remove(lease)


def run_elastic_pipeline(spec, process_bucket, log, *, holder_id, lease_ttl,
                         workers, progress_interval, t0):
    """The elastic replacement for the static scatter/gather schedule.
    Called from ``runner._run_pipeline_body`` after the dirty-dir guard
    and fingerprint manifest check; every participating host runs this
    with identical arguments (modulo ``holder_id``)."""
    out_dir = spec["out_dir"]
    holder = (leases.sanitize_holder(holder_id) if holder_id
              else leases.default_holder())
    ttl = float(lease_ttl)
    if ttl <= 0:
        raise ValueError("lease_ttl must be > 0, got {}".format(lease_ttl))
    poll = max(0.05, min(ttl / 4.0, 2.0))  # claim-loop rescan period
    keeper = leases.LeaseKeeper(ttl)
    # Fleet spools (when armed) carry the lease holder's name, so the
    # status report's "host h0 stalled" and the lease events' "stolen
    # from h0" name the same thing; the env pin makes pool workers
    # publish into the same spool.
    obs.fleet.adopt_holder(holder, ttl=ttl)
    log("elastic preprocess: holder={} ttl={}s".format(holder, ttl))
    totals = {"completed": 0, "stolen": 0, "fence_rejects": 0}

    def add_stats(stats):
        for k in totals:
            totals[k] += stats[k]

    try:
        if spec["global_shuffle"]:
            adaptive = bool(spec.get("adaptive_scatter"))
            nblocks = len(_runner.plan_blocks(
                _runner.discover_source_files(spec["corpus_paths"]),
                spec["num_blocks"]))
            scatter_walls = {}

            def scatter_loop(unit_list):
                factory = _pool_factory_for(process_bucket, spec, workers,
                                            len(unit_list))
                return claim_loop(
                    spec, "elastic scatter", _SCATTER_PREFIX, unit_list,
                    holder=holder, ttl=ttl, keeper=keeper,
                    is_done=lambda u: _read_scatter_record(out_dir, u),
                    ledger_name=lambda u: "scatter-{}.json".format(u),
                    sweep=lambda u: _sweep_scatter(spec, u),
                    task=(_pool_scatter_slice if factory else
                          (lambda u, e, h, d=0.0: _scatter_slice(
                              spec, u, e, h, deadline=d))),
                    publish=lambda u, res, lease: _publish_scatter_record(
                        out_dir, u, lease,
                        wall=scatter_walls.get(u) if adaptive else None),
                    unit_walls=scatter_walls,
                    executor_factory=factory,
                    max_inflight=max(1, workers),
                    log=log, progress_interval=progress_interval,
                    poll=poll)

            # The accept set: exactly the winning attempt's spool files
            # per slice, read back STABLY after every slice is journaled
            # — identical on every host regardless of who ran what. A
            # "retry" (a record withdrawn by a fenced loser who then
            # died) re-enters the claim loop, which skips done units and
            # redoes only the un-journaled one.
            while True:
                if adaptive:
                    # Probes first (fixed identity), then the lease-guarded
                    # plan sizes the remaining blocks; the main loop's pool
                    # factory is built AFTER the plan lands in spec, so a
                    # spawn pool's spec snapshot carries it.
                    probes = _probe_layout(nblocks)
                    with obs.span("preprocess.scatter", elastic=True,
                                  holder=holder, adaptive=True):
                        add_stats(scatter_loop([k for k, _, _ in probes]))
                        # The plan record carries epoch/holder ON PURPOSE
                        # (fencing audit trail, like every _done record);
                        # it is a journaled-once shared fact, not shard
                        # content — byte identity is pinned by tests.
                        plan = _ensure_plan(spec, probes, nblocks, holder,
                                            ttl, keeper, poll, log)
                        if plan is None:
                            status, recs = "finalized", None
                            break
                        spec["scatter_plan"] = {"main": plan["main"]}
                        add_stats(scatter_loop(
                            list(range(len(plan["main"])))))
                    scatter_units = ([k for k, _, _ in probes]
                                     + list(range(len(plan["main"]))))
                else:
                    scatter_units = list(range(spec["scatter_units"]))
                    with obs.span("preprocess.scatter", elastic=True,
                                  holder=holder):
                        add_stats(scatter_loop(scatter_units))
                status, recs = _stable_scatter_records(
                    out_dir, scatter_units, leases.lease_root(out_dir),
                    ttl, poll)
                if status != "retry":
                    break
                log("elastic scatter: a completion record was withdrawn "
                    "with no live holder; re-entering the claim loop")
            if status == "ok":
                spec["spool_accept"] = sorted(
                    spool_name(u, recs[u]["epoch"], recs[u]["holder"])
                    for u in scatter_units)
            else:
                log("elastic: run already finalized by another host during "
                    "this host's scatter phase")
            gather_units = list(range(spec["ngroups"]))
            gather_prefix, gather_phase = _GROUP_PREFIX, "elastic gather"
            gather_task_pool, gather_sweep = _pool_gather_group, _sweep_gather

            def serial_gather(u, e, h, d=0.0):
                return _runner._run_group(
                    spec, process_bucket, u,
                    fence=_fence_for(out_dir, _GROUP_PREFIX, u, e, h,
                                     deadline=d))
        else:
            gather_units = list(range(spec["nbuckets"]))
            gather_prefix, gather_phase = _BLOCK_PREFIX, "elastic process"
            gather_task_pool, gather_sweep = _pool_block_bucket, _sweep_block

            def serial_gather(u, e, h, d=0.0):
                return _runner._run_block_bucket(
                    spec, process_bucket, u,
                    fence=_fence_for(out_dir, _BLOCK_PREFIX, u, e, h,
                                     deadline=d))

        # Overlapped gather: consume each unit's census record the moment
        # it is observed (journaled by us, or discovered on disk from
        # another host) instead of re-reading every record at a barrier
        # after the loop. Record content is plan-deterministic, so the
        # in-flight copy is what a barrier read would return; byte
        # identity is untouched. Disabled (empty hook) under
        # LDDL_TPU_COORD_LEGACY=1.
        census, consumed_at = {}, {}

        def on_gather_record(u, rec):
            consumed_at[u] = time.monotonic()
            if isinstance(rec, dict):
                census.update(rec)

        legacy = leases.legacy_coordination()
        factory = _pool_factory_for(process_bucket, spec, workers,
                                    len(gather_units))
        with obs.span("preprocess.gather", elastic=True, holder=holder):
            add_stats(claim_loop(
                spec, gather_phase, gather_prefix, gather_units,
                holder=holder, ttl=ttl, keeper=keeper,
                is_done=lambda u: _runner._ledger_read(out_dir, u),
                ledger_name=lambda u: "group-{}.json".format(u),
                on_record=None if legacy else on_gather_record,
                sweep=lambda u: gather_sweep(spec, u),
                task=gather_task_pool if factory else serial_gather,
                publish=lambda u, res, lease: _publish_gather_record(
                    out_dir, u, res, lease),
                executor_factory=factory, max_inflight=max(1, workers),
                log=log, progress_interval=progress_interval,
                poll=poll))

        # Merge the global census BEFORE finalize can delete the ledger;
        # only units the overlapped consume missed are read here. The
        # saved wall = how long each consumed record would have sat
        # waiting for this barrier.
        barrier_t = time.monotonic()
        # Gather census records are pure instance counts: no lease state
        # (only scatter records carry epoch/holder).
        written = _merge_census(out_dir, gather_units, census=census,
                                consumed=set(consumed_at))
        if consumed_at:
            obs.inc("gather_overlap_seconds_total",
                    sum(barrier_t - t for t in consumed_at.values()))
        log("elastic summary: holder={} units={} steals={} "
            "fence_rejects={}".format(holder, totals["completed"],
                                      totals["stolen"],
                                      totals["fence_rejects"]))
        # spec carries the adopted plan's block ranges (journaled-once
        # shared fact); the manifest lists shards whose bytes are
        # partition-independent — identity pinned across fixed/adaptive.
        _finalize(spec, holder, ttl, keeper, log, poll)
    finally:
        keeper.stop()

    elapsed = time.perf_counter() - t0  # log-only rates
    if obs.enabled():
        obs.set_gauge("preprocess_samples_per_second",
                      sum(written.values()) / max(elapsed, 1e-9))
        docs = obs.registry().counter("preprocess_docs_total").total()
        if docs:
            obs.set_gauge("preprocess_docs_per_second",
                          docs / max(elapsed, 1e-9))
    log("preprocess done in {:.1f}s, {} shards, {} samples (elastic, "
        "global census)".format(elapsed, len(written),
                                sum(written.values())))
    return written
