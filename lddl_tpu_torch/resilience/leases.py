"""Atomic-rename lease protocol for multi-host work stealing.

Counterpart of ``lddl_tpu/resilience/leases.py``. N independent host
processes share nothing but the output directory (NFS or a FUSE mount,
the medium the shards ride). Each work unit gets one lease file
``<out>/_leases/<unit>.json`` carrying ``(holder, epoch, deadline)``:

- **acquire**: a missing lease is claimed by writing a holder-unique temp
  file and hard-linking it into place (``os.link`` fails with EEXIST if
  someone else got there first, the NFS-safe exclusive create; mounts
  without hard links fall back to ``O_CREAT|O_EXCL``).
- **renew**: the holder republishes the lease with a later deadline
  (tmp + ``os.replace``, :func:`resilience.io.atomic_publish`), then
  reads it back; a mismatch means the lease was stolen (`LeaseLost`).
- **steal**: anyone may replace an EXPIRED lease, bumping the **epoch**.
  Replace + read-back does not serialize concurrent stealers perfectly:
  two may both believe they won for a moment. Mutual exclusion is an
  efficiency lever here, never the correctness mechanism.
- **fence**: correctness comes from epoch fencing at publish time. Before
  journaling a completed unit the holder re-reads the lease and publishes
  ONLY if ``(holder, epoch)`` still match; a stalled holder that wakes
  after a steal sees the bumped epoch and discards its late result
  (``lease_fence_rejects_total``). Unit outputs that cannot be replaced
  idempotently (scatter spool appends) also carry ``(epoch, holder)`` in
  their file names, so a loser's debris is never read.

Lease files are scheduling state, never data: nothing in them (holder,
epoch, wall-clock deadline) flows into shard bytes or ``.manifest.json``.
Deadlines are wall-clock on purpose (the one cross-host time base a
shared filesystem gives); this module is the one place the pipeline
reads the wall clock for control flow.

Fault sites: ``lease-acquire``, ``lease-renew`` and ``lease-release``
fire at the guarded operations; the ``stall`` kind freezes a renewal
past the deadline to force a steal (see ``faults.py``).

**CAS backends** (``LDDL_TPU_STORAGE_BACKEND=mock``): on a store with a
conditional put, acquire, renew and steal become compare-and-swap on the
lease object's generation instead of replace + read-back: create is
``put_if_match(..., None)``, renew and steal ``put_if_match(...,
gen_read)``, release ``delete_if_match``. A fenced loser's conditional
put FAILS (``CASConflict`` -> ``LeaseLost``), and concurrent stealers are
serialized (one conditional put per generation wins). Epochs, counters,
the deadline cache and every fault site are the same on both backends.

Each lease transition (claimed, stolen, renewed) is also recorded as a
fleet lifecycle event (``observability/fleet.py``), as the reference's
are.
"""


import json
import logging
import os
import re
import socket
import threading
import time
import uuid

from . import backend as storage
from . import faults
from . import io as rio
from ..observability import event as obs_event
from ..observability import fleet
from ..observability import inc as obs_inc

LEASE_DIR = "_leases"

_log = logging.getLogger("lddl_tpu_torch.resilience.leases")

_SAFE_RE = re.compile(r"[^A-Za-z0-9_.-]+")


def legacy_coordination():
    """True when ``LDDL_TPU_COORD_LEGACY=1`` pins the pre-batched
    coordination paths (per-lease keeper renewals with read-back,
    unsnapshotted claim-loop scans, barrier gather). Kept so benchmarks
    can measure the batched protocol against its ancestor honestly and
    tests can compare the two for byte identity."""
    return os.environ.get("LDDL_TPU_COORD_LEGACY", "") == "1"


def _op(kind):
    """Count one lease-file filesystem operation. ``lease_ops_total`` is
    the coordination-cost headline: every lease read, publish,
    exclusive create, unlink, and directory scan increments it exactly
    once, on the legacy and batched paths alike, so the ratio between the
    two is an apples-to-apples count of FS round trips."""
    obs_inc("lease_ops_total", op=kind)


class LeaseLost(RuntimeError):
    """The lease was stolen (epoch bumped / holder replaced) out from
    under its holder; the unit in flight must be self-terminated."""


class Lease(object):
    """One held lease. ``lost`` is flipped by the keeper thread when a
    renewal discovers the lease was stolen; the claim loop checks it (and
    re-verifies on disk) before publishing the unit. ``gen`` is the lease
    object's storage generation on CAS backends (None on the local
    atomic-rename protocol): every conditional renew chains off the
    generation the previous operation returned."""

    __slots__ = ("root", "unit", "holder", "epoch", "deadline", "lost",
                 "gen")

    def __init__(self, root, unit, holder, epoch, deadline, gen=None):
        self.root = root
        self.unit = unit
        self.holder = holder
        self.epoch = epoch
        self.deadline = deadline
        self.lost = False
        self.gen = gen

    @property
    def path(self):
        return lease_path(self.root, self.unit)

    def __repr__(self):
        return "Lease({}@{} epoch={})".format(self.unit, self.holder,
                                              self.epoch)


def default_holder():
    """Unique-per-process holder id: hostname + pid + a random tag (a
    respawned process recycling a pid must not mistake its dead
    predecessor's lease for its own). Lease-file state only — never data."""
    return sanitize_holder("{}-{}-{}".format(
        socket.gethostname(), os.getpid(), uuid.uuid4().hex[:6]))


def sanitize_holder(holder):
    """Holder ids land in file names (lease temps, scatter spool files);
    restrict them to a safe charset."""
    safe = _SAFE_RE.sub("-", str(holder)).strip("-")
    if not safe:
        raise ValueError("holder id {!r} is empty after sanitizing".format(
            holder))
    return safe


def lease_root(out_dir):
    return os.path.join(out_dir, LEASE_DIR)


def lease_path(root, unit):
    return os.path.join(root, "{}.json".format(unit))


def read_lease(root, unit):
    """The current lease record for ``unit``, or None when absent.

    Reads ride :func:`resilience.io.read_bytes` (transient-error retries +
    fault injection). A torn/empty record — possible only through storage
    misbehaviour, every writer publishes complete temp files — reads as an
    expired epoch-0 lease with a warning, so a flaky byte never wedges the
    scheduler; the fence still protects the ledger."""
    path = lease_path(root, unit)
    _op("read")
    rec, status = rio.read_json(path)
    if status == "missing":
        return None
    if status == "ok" and isinstance(rec, dict):
        return rec
    _log.warning("torn/unparseable lease file %s; treating as expired",
                 path)
    obs_inc("lease_torn_reads_total")
    return {"unit": unit, "holder": "", "epoch": 0, "deadline": 0.0,
            "torn": True}


def _record(unit, holder, epoch, deadline):
    return {"unit": unit, "holder": holder, "epoch": int(epoch),
            "deadline": float(deadline)}


def _write_tmp(path, rec, holder):
    """Fully write a holder-unique temp next to ``path`` (unique name: two
    hosts — or two threads — publishing the same lease can never interleave
    bytes in a shared temp the way a pid-keyed name could)."""
    tmp = "{}.tmp.{}".format(path, holder)
    # Pre-publish scratch with a holder-unique name, promoted only via
    # os.link / atomic_publish below; a torn temp is never trusted.
    with open(tmp, "wb") as f:  # lddl: disable=atomic-publish
        f.write(json.dumps(rec, sort_keys=True).encode("utf-8"))
        f.flush()
        os.fsync(f.fileno())
    return tmp


def _cleanup_tmp(tmp):
    try:
        os.unlink(tmp)
    except FileNotFoundError:
        pass


def _matches(rec, holder, epoch):
    return (rec is not None and rec.get("holder") == holder
            and rec.get("epoch") == epoch)


def _try_create(path, rec, holder):
    """Exclusive create of a fresh lease file. ``os.link`` is atomic and
    fails loudly on EEXIST even on NFS; filesystems that refuse hard links
    fall back to O_CREAT|O_EXCL (fine everywhere the fallback runs: a FUSE
    mount without link support is also not an NFSv2 mount)."""
    _op("create")
    tmp = _write_tmp(path, rec, holder)
    try:
        try:
            os.link(tmp, path)
            return True
        except FileExistsError:
            return False
        # EPERM/ENOTSUP: the mount refuses hard links; the O_EXCL path
        # below makes the same exclusive create. -- lddl: disable=swallowed-error
        except OSError:
            pass
        try:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            return False
        try:
            with open(tmp, "rb") as f:
                os.write(fd, f.read())
        finally:
            os.close(fd)
        return True
    finally:
        _cleanup_tmp(tmp)


def _publish(path, rec, holder):
    """Replace the lease file with a fully-written record (tmp + fsync +
    ``os.replace`` + dir fsync via resilience.io)."""
    _op("publish")
    tmp = _write_tmp(path, rec, holder)
    try:
        rio.atomic_publish(tmp, path)
    finally:
        _cleanup_tmp(tmp)


# ------------------------------------------------ CAS-backend primitives

def _cas_backend():
    """The active CAS-capable storage backend, or None when the default
    LocalBackend is active (the atomic-rename protocol below is the
    local path — unchanged, byte for byte)."""
    bk = storage.get_backend()
    return bk if bk.is_cas else None


def _read_lease_versioned(bk, root, unit):
    """CAS read: ``(record, generation)`` for the unit's lease object, or
    ``(None, None)`` when absent. Torn bytes map to the same expired
    epoch-0 record as :func:`read_lease` — but keep their generation, so
    the subsequent steal is still a conditional put."""
    path = lease_path(root, unit)
    _op("read")
    data, gen = rio.with_retries(lambda: bk.get_versioned(path),
                                 desc="lease get {}".format(path))
    if data is None:
        return None, None
    try:
        rec = json.loads(data)
    except ValueError:
        rec = None
    if isinstance(rec, dict):
        return rec, gen
    _log.warning("torn/unparseable lease object %s; treating as expired",
                 path)
    obs_inc("lease_torn_reads_total")
    return {"unit": unit, "holder": "", "epoch": 0, "deadline": 0.0,
            "torn": True}, gen


def _cas_put(bk, path, rec, expected_gen, kind):
    """One conditional lease put (create when ``expected_gen`` is None).
    Transient store errors retry through the classifier; a
    :class:`backend.CASConflict` propagates — precondition loss is the
    protocol signal, never a retry candidate."""
    _op(kind)
    data = json.dumps(rec, sort_keys=True).encode("utf-8")
    return rio.with_retries(
        lambda: bk.put_if_match(path, data, expected_gen),
        desc="lease cas-put {}".format(path))


def _try_acquire_cas(bk, root, unit, holder, ttl_s, now, held_cache,
                     known_missing):
    """CAS-backend claim: the same state machine as the local path below,
    with conditional puts serializing what replace + read-back only
    narrows. A conflict anywhere means another claimant won — count it
    and stand down (the next pass re-reads)."""
    path = lease_path(root, unit)
    if known_missing:
        cur, gen = None, None
    else:
        cur, gen = _read_lease_versioned(bk, root, unit)
    if cur is None:
        rec = _record(unit, holder, 0, now + ttl_s)
        try:
            g = _cas_put(bk, path, rec, None, "create")
        except storage.CASConflict:
            obs_inc("lease_acquire_conflicts_total")
            return None
        obs_inc("lease_acquires_total")
        fleet.record("unit.claimed", unit=str(unit), epoch=0,
                     holder=holder)
        return Lease(root, unit, holder, 0, rec["deadline"], gen=g)
    if float(cur.get("deadline", 0.0)) > now and not cur.get("torn"):
        if held_cache is not None:
            held_cache[unit] = float(cur.get("deadline", 0.0))
        obs_inc("lease_acquire_conflicts_total")
        return None
    new_epoch = int(cur.get("epoch", 0)) + 1
    rec = _record(unit, holder, new_epoch, now + ttl_s)
    try:
        g = _cas_put(bk, path, rec, gen, "publish")
    except storage.CASConflict:
        obs_inc("lease_acquire_conflicts_total")
        return None
    obs_inc("lease_acquires_total")
    obs_inc("lease_steals_total")
    obs_event("lease.steal", unit=str(unit), epoch=new_epoch,
              prev_holder=str(cur.get("holder", "")))
    fleet.record("unit.stolen", unit=str(unit), epoch=new_epoch,
                 holder=holder, prev_holder=str(cur.get("holder", "")))
    return Lease(root, unit, holder, new_epoch, rec["deadline"], gen=g)


def _renew_cas(bk, lease, ttl_s, now_fn):
    """CAS-backend renewal: read → fence-match → conditional put. No
    read-back on any path — the conditional put IS the read-back: a
    concurrent replace between our read and our put surfaces as
    :class:`backend.CASConflict`, i.e. the fence tripping as a
    precondition instead of after the fact."""
    cur, gen = _read_lease_versioned(bk, lease.root, lease.unit)
    if not _matches(cur, lease.holder, lease.epoch):
        lease.lost = True
        raise LeaseLost("lease for unit {} was stolen (now {})".format(
            lease.unit, cur))
    rec = _record(lease.unit, lease.holder, lease.epoch,
                  now_fn() + ttl_s)
    try:
        lease.gen = _cas_put(bk, lease.path, rec, gen, "publish")
    except storage.CASConflict:
        lease.lost = True
        raise LeaseLost("lease for unit {} lost during renewal "
                        "(CAS precondition)".format(lease.unit))
    lease.deadline = rec["deadline"]
    obs_inc("lease_renews_total")
    fleet.record("unit.renewed", unit=str(lease.unit), epoch=lease.epoch,
                 holder=lease.holder)
    return lease


def scan_units(root):
    """One directory scan of the lease root: the set of unit keys that
    currently have a lease file (tmp debris excluded), or None when the
    root itself is gone (finalized/absent). A single scan stands in for
    per-unit existence reads — the amortization both the batched keeper
    pass and the claim loop's per-pass snapshot ride."""
    _op("scan")
    bk = _cas_backend()
    if bk is not None:
        names = bk.list(root)
        if names is None:
            return None
        return {n[:-len(".json")] for n in names if n.endswith(".json")}
    try:
        names = sorted(os.listdir(root))
    except (FileNotFoundError, NotADirectoryError):
        return None
    return {n[:-len(".json")] for n in names
            if n.endswith(".json") and ".tmp." not in n}


def try_acquire(root, unit, holder, ttl_s, now_fn=time.time,
                known_missing=False, held_cache=None):
    """Claim ``unit``: returns a :class:`Lease` on success, None when the
    unit is validly held by someone else (or a race was lost).

    A missing lease is created exclusively at epoch 0. An expired (or
    torn) lease is **stolen**: the epoch is bumped and the record
    replaced, then read back — only the claimant whose bytes survived the
    replace race proceeds. The read-back does not make concurrent steals
    perfectly exclusive; the publish-time fence does (module docstring).

    Two amortization knobs (both safe to omit):

    - ``known_missing=True`` — the caller's per-pass :func:`scan_units`
      snapshot showed no lease file, so skip the initial read and go
      straight to the exclusive create; a racer who created one since the
      scan just fails the create and falls back to the read path.
    - ``held_cache`` — a ``{unit: deadline}`` dict the caller threads
      through its passes. A valid-held conflict records the observed
      deadline; later calls for the same unit return None without any
      filesystem read until that deadline has passed. The wall-clock
      comparison stays inside this module (the one allowlisted clock
      consumer); a cached skip is not an acquire attempt, so it counts
      neither ops nor conflicts.
    """
    now = now_fn()
    if held_cache is not None:
        cached = held_cache.get(unit)
        if cached is not None:
            if cached > now:
                return None
            held_cache.pop(unit, None)
    os.makedirs(root, exist_ok=True)
    path = lease_path(root, unit)
    faults.fault_point("lease-acquire", path)
    bk = _cas_backend()
    if bk is not None:
        return _try_acquire_cas(bk, root, unit, holder, ttl_s, now,
                                held_cache, known_missing)
    cur = None if known_missing else read_lease(root, unit)
    if cur is None:
        rec = _record(unit, holder, 0, now + ttl_s)
        if _try_create(path, rec, holder):
            if not legacy_coordination():
                # The exclusive create succeeded, so the bytes on disk are
                # ours and nobody may validly steal them before the fresh
                # deadline: the legacy read-back can only confirm that.
                # The one race it narrowed — a thief who read a stale
                # EXPIRED record, lost it to a release-unlink, and then
                # replaces our newborn file — leaves two hosts transiently
                # believing they won, which the module docstring already
                # declares fine by design: the publish-time fence picks
                # one winner, the loser's work is the only cost.
                obs_inc("lease_acquires_total")
                fleet.record("unit.claimed", unit=str(unit), epoch=0,
                             holder=holder)
                return Lease(root, unit, holder, 0, rec["deadline"])
            got = read_lease(root, unit)
            if _matches(got, holder, 0):
                obs_inc("lease_acquires_total")
                fleet.record("unit.claimed", unit=str(unit), epoch=0,
                             holder=holder)
                return Lease(root, unit, holder, 0, rec["deadline"])
            obs_inc("lease_acquire_conflicts_total")
            return None
        if not known_missing:
            obs_inc("lease_acquire_conflicts_total")
            return None
        # The snapshot was stale (someone created the lease since the
        # scan): re-enter through the normal read path.
        cur = read_lease(root, unit)
        if cur is None:
            # Created then already released/swept between our two looks;
            # treat as a lost race rather than spinning here.
            obs_inc("lease_acquire_conflicts_total")
            return None
    if float(cur.get("deadline", 0.0)) > now and not cur.get("torn"):
        # Validly held (possibly by a past incarnation of ourselves — a
        # claim loop never double-claims, so "held by my id" is equally
        # a conflict here).
        if held_cache is not None:
            held_cache[unit] = float(cur.get("deadline", 0.0))
        obs_inc("lease_acquire_conflicts_total")
        return None
    new_epoch = int(cur.get("epoch", 0)) + 1
    rec = _record(unit, holder, new_epoch, now + ttl_s)
    _publish(path, rec, holder)
    got = read_lease(root, unit)
    if _matches(got, holder, new_epoch):
        obs_inc("lease_acquires_total")
        obs_inc("lease_steals_total")
        obs_event("lease.steal", unit=str(unit), epoch=new_epoch,
                  prev_holder=str(cur.get("holder", "")))
        fleet.record("unit.stolen", unit=str(unit), epoch=new_epoch,
                     holder=holder, prev_holder=str(cur.get("holder", "")))
        return Lease(root, unit, holder, new_epoch, rec["deadline"])
    obs_inc("lease_acquire_conflicts_total")
    return None


def renew(lease, ttl_s, now_fn=time.time):
    """Push the deadline out by ``ttl_s``. Raises :class:`LeaseLost` when
    the on-disk record no longer names this holder+epoch (stolen while we
    stalled). The ``lease-renew`` fault site fires BEFORE the read, so an
    injected ``stall`` freezes the renewal long enough for the deadline to
    pass and a steal to land — exactly the scenario the fence exists for."""
    path = lease.path
    faults.fault_point("lease-renew", path)
    bk = _cas_backend()
    if bk is not None:
        return _renew_cas(bk, lease, ttl_s, now_fn)
    cur = read_lease(lease.root, lease.unit)
    if not _matches(cur, lease.holder, lease.epoch):
        lease.lost = True
        raise LeaseLost("lease for unit {} was stolen (now {})".format(
            lease.unit, cur))
    rec = _record(lease.unit, lease.holder, lease.epoch, now_fn() + ttl_s)
    _publish(path, rec, lease.holder)
    got = read_lease(lease.root, lease.unit)
    if not _matches(got, lease.holder, lease.epoch):
        lease.lost = True
        raise LeaseLost("lease for unit {} lost during renewal".format(
            lease.unit))
    lease.deadline = rec["deadline"]
    obs_inc("lease_renews_total")
    fleet.record("unit.renewed", unit=str(lease.unit), epoch=lease.epoch,
                 holder=lease.holder)
    return lease


def renew_fast(lease, ttl_s, now_fn=time.time):
    """Batched-keeper renewal: read → fence-match → publish, with NO
    read-back. The read-back in :func:`renew` only narrows (never closes)
    the replace race — the publish-time fence plus the next keeper pass's
    read give the same guarantee one FS round trip cheaper, which is the
    point of the batched pass. Counters and fleet events are identical to
    :func:`renew`; the ``lease-renew`` fault site still fires first, so
    the chaos suite's forced-stall steal scenario is unchanged. On a CAS
    backend renew and renew_fast are the same operation — the conditional
    put already carries the read-back's guarantee for free."""
    path = lease.path
    faults.fault_point("lease-renew", path)
    bk = _cas_backend()
    if bk is not None:
        return _renew_cas(bk, lease, ttl_s, now_fn)
    cur = read_lease(lease.root, lease.unit)
    if not _matches(cur, lease.holder, lease.epoch):
        lease.lost = True
        raise LeaseLost("lease for unit {} was stolen (now {})".format(
            lease.unit, cur))
    rec = _record(lease.unit, lease.holder, lease.epoch, now_fn() + ttl_s)
    _publish(path, rec, lease.holder)
    lease.deadline = rec["deadline"]
    obs_inc("lease_renews_total")
    fleet.record("unit.renewed", unit=str(lease.unit), epoch=lease.epoch,
                 holder=lease.holder)
    return lease


def verify(lease):
    """Fence check: True iff the on-disk lease still names this holder AND
    epoch. Run immediately before journaling a completed unit; False means
    the unit was reclaimed and this result must be discarded."""
    if lease.lost:
        return False
    return verify_at(lease.root, lease.unit, lease.holder, lease.epoch)


def is_live(root, unit, now_fn=time.time):
    """True while SOME host validly holds ``unit`` (unexpired, untorn
    lease) — i.e. the unit is actively being worked on. Used by the
    claim loop's failure-patience logic: a host must not declare the run
    failed while another live host is still redoing the unit (the
    wall-clock comparison lives here so steal.py stays clock-free)."""
    rec = read_lease(root, unit)
    return (rec is not None and not rec.get("torn")
            and float(rec.get("deadline", 0.0)) > now_fn())


def verify_at(root, unit, holder, epoch):
    """Stateless fence check for code that cannot carry a Lease object
    across a process boundary (pool workers): True iff the on-disk lease
    for ``unit`` names exactly (holder, epoch). Workers call this between
    sub-steps to self-terminate a stolen unit early instead of wasting
    work (and, crucially, instead of writing outputs derived from state a
    finalizer may already be deleting)."""
    return _matches(read_lease(root, unit), holder, epoch)


def fence_at(root, unit, holder, epoch, deadline=0.0, now_fn=time.time):
    """A deadline-cached fence closure over :func:`verify_at`, for unit
    bodies that re-check their lease between sub-steps.

    The protocol forbids stealing an unexpired lease (:func:`try_acquire`
    refuses a record whose deadline is ahead), so while the wall clock is
    strictly inside the last deadline this fence READ — seeded with the
    claim-time ``deadline`` when the caller knows it — the on-disk record
    provably still names ``(holder, epoch)`` and the closure answers True
    with no filesystem op. At/past the cached deadline it re-reads,
    refreshing the cache from the record the keeper's renewals have been
    pushing out; a mismatch is final (epochs never revert). A stall long
    enough to let a thief in necessarily carries the wall past the cached
    deadline too, so the first post-stall call is a real read and the
    fence trips exactly where an every-call read would have tripped it.
    Legacy coordination pins every call to a real read. The wall-clock
    comparison stays in this module (the allowlisted clock consumer)."""
    state = {"deadline": float(deadline), "ok": True}
    legacy = legacy_coordination()

    def check():
        if not state["ok"]:
            return False
        if not legacy and now_fn() < state["deadline"]:
            return True
        rec = read_lease(root, unit)
        if not _matches(rec, holder, epoch):
            state["ok"] = False
            return False
        state["deadline"] = float(rec.get("deadline", 0.0))
        return True

    return check


def still_held(lease, now_fn=time.time):
    """Deadline-aware pre-publish look at a held lease: False when the
    keeper already flagged it lost; True WITHOUT a filesystem read while
    the wall clock is strictly inside the last deadline this process
    acquired/renewed to (an unexpired lease cannot be validly stolen, so
    a read could only confirm ownership); a real :func:`verify` read past
    the deadline or under legacy coordination. Advisory only — the
    correctness fence is the post-publish re-verify inside the unit
    record publishers, which always reads."""
    if lease.lost:
        return False
    if not legacy_coordination() and now_fn() < lease.deadline:
        return True
    return verify(lease)


def release(lease, now_fn=time.time):
    """Drop a completed unit's lease (verified unlink; inside the deadline
    the verify read is skipped). Best-effort: the unit's ledger record is
    the durable completion signal — claim loops check the ledger before
    the lease — so a leftover lease file is inert and gets swept with the
    rest of ``_leases/`` at finalize."""
    faults.fault_point("lease-release", lease.path)
    if lease.lost:
        return
    bk = _cas_backend()
    if bk is not None:
        # Conditional delete chained off our last-known generation; a
        # conflict means a keeper renewal advanced it concurrently —
        # re-read once and retry, then give up (a leftover lease object
        # is inert, same as a leftover lease file).
        for _ in range(2):
            cur, gen = _read_lease_versioned(bk, lease.root, lease.unit)
            if not _matches(cur, lease.holder, lease.epoch):
                return
            _op("unlink")
            try:
                rio.with_retries(
                    lambda g=gen: bk.delete_if_match(lease.path, g),
                    desc="lease delete {}".format(lease.path))
            except storage.CASConflict:
                continue
            obs_inc("lease_releases_total")
            return
        return
    if not legacy_coordination() and now_fn() < lease.deadline:
        # An unexpired lease cannot have been validly stolen, so the
        # pre-unlink verify read could only confirm the record is ours.
        # Should a clock-skewed early thief have replaced it anyway, the
        # unlink drops the thief's lease: for a journaled unit (ledger
        # publishes BEFORE release) the thief's own post-acquire ledger
        # re-check retires the duplicate attempt; otherwise the thief
        # merely loses the efficiency lever and the publish-time fence
        # picks one winner, as for any concurrent-claim race.
        _op("unlink")
        try:
            os.unlink(lease.path)
        except FileNotFoundError:
            pass
        obs_inc("lease_releases_total")
        return
    if verify(lease):
        _op("unlink")
        try:
            os.unlink(lease.path)
        except FileNotFoundError:
            pass
        obs_inc("lease_releases_total")


class LeaseKeeper(object):
    """One background thread renewing every lease this host holds, at
    ``ttl/3``. A renewal that discovers a steal marks ``lease.lost`` (and
    stops renewing it); the claim loop's fence does the rest. Transient
    storage errors are retried inside the lease I/O; anything else is
    conservatively treated as lost — without renewals the lease expires
    anyway, and redoing a unit is always safe."""

    def __init__(self, ttl_s):
        self.ttl_s = ttl_s
        self._leases = set()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = None

    def add(self, lease):
        with self._lock:
            self._leases.add(lease)
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, name="lease-keeper", daemon=True)
                self._thread.start()

    def remove(self, lease):
        with self._lock:
            self._leases.discard(lease)

    def stop(self):
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)

    def _run(self):
        period = max(self.ttl_s / 3.0, 0.05)
        legacy = legacy_coordination()
        while not self._stop.wait(period):
            with self._lock:
                held = list(self._leases)
            if legacy:
                for lease in held:
                    if lease.lost:
                        continue
                    self._renew_one(lease, renew)
                continue
            # Batched pass: one directory scan per lease root answers
            # "does my file still exist" for every held lease at once; a
            # lease missing from the scan was stolen-then-released (or the
            # run finalized) — the same on-disk states a legacy renew()
            # would discover one read at a time. Survivors renew via
            # renew_fast (read + publish, no read-back): 1 + 2n FS ops per
            # pass instead of 3n.
            by_root = {}
            for lease in held:
                if not lease.lost:
                    by_root.setdefault(lease.root, []).append(lease)
            for root, group in by_root.items():
                try:
                    present = scan_units(root)
                except Exception as e:  # noqa: BLE001 - class docstring
                    _log.warning("lease scan of %s failed (%s: %s); "
                                 "renewing individually", root,
                                 type(e).__name__, e)
                    present = None
                    scan_failed = True
                else:
                    scan_failed = False
                for lease in group:
                    if (not scan_failed and (
                            present is None
                            or str(lease.unit) not in present)):
                        lease.lost = True
                        self._mark_lost(lease)
                        continue
                    self._renew_one(lease, renew_fast)

    def _renew_one(self, lease, renew_fn):
        try:
            renew_fn(lease, self.ttl_s)
        except LeaseLost:
            self._mark_lost(lease)
        except Exception as e:  # noqa: BLE001 - see class docstring
            lease.lost = True
            _log.warning("lease renewal for unit %s failed (%s: %s); "
                         "treating as lost", lease.unit,
                         type(e).__name__, e)

    @staticmethod
    def _mark_lost(lease):
        obs_event("lease.lost", unit=str(lease.unit), epoch=lease.epoch)
        fleet.record("unit.lost", unit=str(lease.unit), epoch=lease.epoch,
                     holder=lease.holder)
        _log.warning("lease for unit %s stolen at epoch %s; in-flight "
                     "result will be fenced off", lease.unit, lease.epoch)
