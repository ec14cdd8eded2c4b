"""The port's lease protocol (lddl_tpu_torch.resilience.leases) against
lddl_tpu's: every case runs on both packages, and a scripted sequence of
acquire, renew, steal, fence and release on a fake clock gives the same
epochs, holders and outcomes on both, on the local atomic-rename protocol
and on the mock object store's CAS protocol. Covered: exclusive create,
steals with epoch bumps, fences, fenced release, torn reads, the keeper
(renewing, marking a stolen or vanished lease lost), the fault sites and
the stall kind, the batched keeper's operation budget and the other
amortizations (``known_missing``, ``held_cache``, the deadline-cached
fence, ``still_held``, the unlink-only release), the legacy pin, and the
CAS primitives of both packages' ``MockObjectStore``. Pure filesystem
and threads; wall-clock TTLs of a few tenths of a second at most where
a real expiry is needed.
"""

import importlib
import json
import os
import threading
import time

import pytest


class Pkg:
    """One package's lease surface."""

    def __init__(self, name):
        self.name = name
        self.leases = importlib.import_module(name + ".resilience.leases")
        self.faults = importlib.import_module(name + ".resilience.faults")
        self.backend = importlib.import_module(name + ".resilience.backend")
        self.obs = importlib.import_module(name + ".observability")


REF, PORT = Pkg("lddl_tpu"), Pkg("lddl_tpu_torch")
BOTH = pytest.mark.parametrize("pkg", [REF, PORT], ids=["ref", "port"])

_ENV = ("LDDL_TPU_METRICS_DIR", "LDDL_TPU_FLEET_DIR", "LDDL_TPU_FLEET_HOLDER",
        "LDDL_TPU_FLEET_INTERVAL_S", "LDDL_TPU_FLEET_TTL_S",
        "LDDL_TPU_FAULTS", "LDDL_TPU_COORD_LEGACY",
        "LDDL_TPU_STORAGE_BACKEND")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    """Telemetry, fleet spools, faults, the legacy pin and the backend
    off unless a test sets them: a test of another file that ran before
    on this worker may have left any of them set."""
    for name in _ENV:
        monkeypatch.delenv(name, raising=False)
    for pkg in (REF, PORT):
        pkg.faults.disarm()
    yield
    for pkg in (REF, PORT):
        pkg.faults.disarm()


@pytest.fixture
def root(tmp_path):
    return str(tmp_path / "leases")


def _thief_record(pkg, root, unit, holder, epoch, deadline):
    pkg.leases._publish(pkg.leases.lease_path(root, unit),
                        pkg.leases._record(unit, holder, epoch, deadline),
                        holder)


def _wait_lost(lease, seconds=3.0):
    deadline = time.time() + seconds
    while not lease.lost and time.time() < deadline:
        time.sleep(0.02)
    return lease.lost


# ------------------------------------------------- the state machine


class Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def _script(pkg, root):
    """One scripted run of the protocol on a fake clock; returns each
    step's outcome as plain values."""
    L = pkg.leases
    clock = Clock()
    trace = []

    def acquire(unit, holder, ttl=10.0, **kw):
        got = L.try_acquire(root, unit, holder, ttl, now_fn=clock, **kw)
        trace.append(("acquire", unit, holder, None if got is None
                      else (got.holder, got.epoch, got.deadline - clock.t)))
        return got

    def renew(lease, ttl=10.0, fast=False):
        try:
            (L.renew_fast if fast else L.renew)(lease, ttl, now_fn=clock)
            trace.append(("renew", lease.unit, lease.holder, lease.epoch,
                          lease.deadline - clock.t))
        except L.LeaseLost:
            trace.append(("renew", lease.unit, lease.holder, "lost",
                          lease.lost))

    def look(unit):
        rec = L.read_lease(root, unit)
        trace.append(("record", unit, None if rec is None else
                      (rec["holder"], rec["epoch"],
                       rec["deadline"] - clock.t)))

    a = acquire("u0", "hA")
    acquire("u0", "hB")                    # validly held: refused
    acquire("u0", "hA")                    # even to its own holder id
    renew(a)
    clock.t += 5.0
    renew(a, fast=True)
    look("u0")
    clock.t += 11.0                        # hA stops renewing: expired
    b = acquire("u0", "hB")                # steal: epoch 1
    trace.append(("verify", L.verify(a), L.verify(b),
                  L.verify_at(root, "u0", "hA", 0)))
    renew(a)                               # the stalled holder wakes
    fence = L.fence_at(root, "u0", "hB", 1, deadline=b.deadline,
                       now_fn=clock)
    trace.append(("fence", fence()))
    L.release(a, now_fn=clock)             # fenced: no unlink
    look("u0")
    L.release(b, now_fn=clock)
    look("u0")
    c = acquire("u0", "hC", known_missing=True)
    cache = {}
    acquire("u0", "hD", held_cache=cache)
    trace.append(("cache", {k: v - clock.t for k, v in cache.items()}))
    acquire("u0", "hD", held_cache=cache)  # answered by the cache
    clock.t += 30.0
    d = acquire("u0", "hD", held_cache=cache)
    trace.append(("still_held", L.still_held(c, now_fn=clock),
                  L.still_held(d, now_fn=clock)))
    acquire("u1", "hA")
    trace.append(("scan", sorted(L.scan_units(root))))
    return trace


@BOTH
def test_state_machine_matches_the_reference(root, tmp_path, pkg):
    """The scripted sequence gives the reference's trace step for step,
    on the local protocol."""
    want = _script(REF, str(tmp_path / "ref_leases"))
    got = _script(pkg, root)
    assert got == want
    assert ("acquire", "u0", "hB", ("hB", 1, 10.0)) in got


@BOTH
def test_cas_state_machine_matches_the_reference(tmp_path, monkeypatch,
                                                 pkg):
    """The same script on the mock object store's CAS protocol gives the
    local protocol's trace on both packages."""
    want = _script(REF, str(tmp_path / "local_leases"))
    monkeypatch.setenv("LDDL_TPU_STORAGE_BACKEND", "mock")
    assert pkg.backend.get_backend().is_cas
    got = _script(pkg, str(tmp_path / "cas_leases"))
    assert got == want


@BOTH
def test_fresh_acquire_and_live_conflicts(root, pkg):
    L = pkg.leases
    lease = L.try_acquire(root, "u0", "hostA", ttl_s=10.0)
    assert lease is not None and (lease.holder, lease.epoch) == ("hostA", 0)
    rec = L.read_lease(root, "u0")
    assert rec["holder"] == "hostA" and rec["epoch"] == 0
    assert rec["deadline"] > time.time()
    assert set(rec) == {"unit", "holder", "epoch", "deadline"}
    assert L.try_acquire(root, "u0", "hostB", ttl_s=10.0) is None
    assert L.try_acquire(root, "u0", "hostA", ttl_s=10.0) is None


@BOTH
@pytest.mark.parametrize("backend", ["local", "mock"])
def test_concurrent_acquire_exactly_one_winner(root, monkeypatch, pkg,
                                               backend):
    """Eight threads race the exclusive create (``os.link`` locally, a
    conditional create on the mock store): one winner."""
    monkeypatch.setenv("LDDL_TPU_STORAGE_BACKEND", backend)
    winners, barrier = [], threading.Barrier(8)

    def claim(i):
        barrier.wait()
        got = pkg.leases.try_acquire(root, "u0", "host{}".format(i),
                                     ttl_s=10.0)
        if got is not None:
            winners.append(got)

    threads = [threading.Thread(target=claim, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(winners) == 1 and winners[0].epoch == 0


@BOTH
def test_expired_lease_stolen_and_zombie_fenced(root, pkg):
    L = pkg.leases
    zombie = L.try_acquire(root, "u0", "zombie", ttl_s=0.05)
    time.sleep(0.1)
    thief = L.try_acquire(root, "u0", "thief", ttl_s=10.0)
    assert thief is not None and thief.epoch == zombie.epoch + 1 == 1
    assert L.verify(thief) and not L.verify(zombie)
    assert not L.verify_at(root, "u0", "zombie", 0)
    with pytest.raises(L.LeaseLost):
        L.renew(zombie, ttl_s=10.0)
    assert zombie.lost
    L.release(zombie)  # lost: never unlinks the thief's lease
    assert L.verify(thief)
    L.release(thief)
    assert L.read_lease(root, "u0") is None
    fresh = L.try_acquire(root, "u0", "hostB", ttl_s=10.0)
    assert fresh is not None and fresh.epoch == 0


@BOTH
def test_same_epoch_replace_race_has_one_winner(root, pkg):
    """Two stealers at the same bump: the last replace wins and exactly
    one fence check passes."""
    L = pkg.leases
    assert L.try_acquire(root, "u0", "old", ttl_s=0.05) is not None
    time.sleep(0.1)
    lease_a = L.try_acquire(root, "u0", "hostA", ttl_s=10.0)
    assert lease_a is not None and lease_a.epoch == 1
    _thief_record(pkg, root, "u0", "hostB", 1, time.time() + 10.0)
    assert not L.verify(lease_a)
    with pytest.raises(L.LeaseLost):
        L.renew(lease_a, ttl_s=10.0)
    assert lease_a.lost


@BOTH
def test_torn_lease_reads_as_expired_and_is_stolen(root, monkeypatch,
                                                   tmp_path, pkg):
    monkeypatch.setenv("LDDL_TPU_METRICS_DIR", str(tmp_path / "metrics"))
    pkg.obs.registry().reset()
    os.makedirs(root)
    with open(pkg.leases.lease_path(root, "u0"), "w") as f:
        f.write('{"holder": "hostA", "ep')
    rec = pkg.leases.read_lease(root, "u0")
    assert rec["torn"] and rec["deadline"] == 0.0 and rec["epoch"] == 0
    lease = pkg.leases.try_acquire(root, "u0", "hostB", ttl_s=10.0)
    assert lease is not None and lease.epoch == 1
    assert pkg.obs.registry().counter(
        "lease_torn_reads_total").total() >= 1


# ----------------------------------------------------------- the keeper


@BOTH
@pytest.mark.parametrize("legacy", [False, True], ids=["batched", "legacy"])
def test_keeper_renews_until_stopped(root, monkeypatch, pkg, legacy):
    if legacy:
        monkeypatch.setenv("LDDL_TPU_COORD_LEGACY", "1")
    assert pkg.leases.legacy_coordination() == legacy
    lease = pkg.leases.try_acquire(root, "u0", "hostA", ttl_s=0.4)
    keeper = pkg.leases.LeaseKeeper(0.4)
    keeper.add(lease)
    try:
        time.sleep(1.0)  # several TTLs: only renewals keep it alive
        assert pkg.leases.verify(lease) and not lease.lost
    finally:
        keeper.stop()


@BOTH
@pytest.mark.parametrize("how", ["stolen", "vanished"])
def test_keeper_marks_lost_leases(root, pkg, how):
    """A thief's record landing between renewals (still present in the
    pass's scan: the fence inside the renewal catches it) or a lease file
    gone from the scan (stolen then released, or finalized) marks the
    lease lost; the other held lease stays alive, and the loser never
    republishes over the thief."""
    L = pkg.leases
    victim = L.try_acquire(root, "u0", "hostA", ttl_s=0.4)
    other = L.try_acquire(root, "u1", "hostA", ttl_s=0.4)
    keeper = L.LeaseKeeper(0.4)
    try:
        keeper.add(victim)
        keeper.add(other)
        if how == "stolen":
            _thief_record(pkg, root, "u0", "thief", victim.epoch + 1,
                          time.time() + 30.0)
        else:
            os.unlink(victim.path)
        assert _wait_lost(victim)
        rec = L.read_lease(root, "u0")
        if how == "stolen":
            assert rec["holder"] == "thief"
        else:
            assert rec is None
        assert L.verify(other) and not other.lost
    finally:
        keeper.stop()


# ------------------------------------------------------- fault sites


@BOTH
def test_lease_fault_sites_inject(root, pkg):
    L, faults = pkg.leases, pkg.faults
    faults.arm("lease-acquire:eio:nth=1")
    with pytest.raises(OSError):
        L.try_acquire(root, "u0", "hostA", ttl_s=10.0)
    faults.disarm()
    lease = L.try_acquire(root, "u0", "hostA", ttl_s=10.0)
    assert lease is not None
    faults.arm("lease-release:eio:nth=1")
    with pytest.raises(OSError):
        L.release(lease)
    faults.disarm()
    assert L.verify(lease)  # the failed release left the lease in place
    faults.arm("lease-renew:eio:nth=1")
    with pytest.raises(OSError):
        L.renew(lease, ttl_s=10.0)
    faults.disarm()
    L.release(lease)
    assert L.read_lease(root, "u0") is None


@BOTH
def test_stall_fault_freezes_renewal_past_deadline(root, pkg):
    """A stall at the lease-renew site outlives the TTL, a thief steals,
    and the stalled holder's renewal comes back LeaseLost."""
    L = pkg.leases
    lease = L.try_acquire(root, "u0", "hostA", ttl_s=0.3)
    pkg.faults.arm("lease-renew:stall:nth=1:delay=0.5")
    stolen = {}

    def thief():
        deadline = time.time() + 3.0
        while time.time() < deadline:
            got = L.try_acquire(root, "u0", "thief", ttl_s=10.0)
            if got is not None:
                stolen["lease"] = got
                return
            time.sleep(0.02)

    t = threading.Thread(target=thief)
    t.start()
    try:
        with pytest.raises(L.LeaseLost):
            L.renew(lease, ttl_s=0.3)
    finally:
        t.join()
    assert stolen["lease"].epoch == lease.epoch + 1


@BOTH
def test_stall_kind_parses_with_long_default_delay(pkg):
    clause = pkg.faults._parse_clause("lease-renew:stall:nth=1", 0)
    assert clause["kind"] == "stall" and clause["delay"] == 30.0
    clause = pkg.faults._parse_clause("lease-renew:stall:nth=1:delay=2.5", 0)
    assert clause["delay"] == 2.5


# ------------------------------------------- operation budget, legacy pin


@pytest.fixture
def ops(monkeypatch, tmp_path):
    """Telemetry on in the test's own directory, both registries reset;
    returns a reader of a package's ``lease_ops_total``."""
    monkeypatch.setenv("LDDL_TPU_METRICS_DIR", str(tmp_path / "metrics"))
    for pkg in (REF, PORT):
        pkg.obs.registry().reset()

    def read(pkg, op=None):
        c = pkg.obs.registry().counter("lease_ops_total")
        return c.total() if op is None else c.value(op=op)

    return read


@BOTH
def test_amortized_paths_op_counts(root, ops, pkg):
    """scan_units is one op; renew_fast is one read and one publish; a
    known-missing acquire skips every read; a held_cache hit costs
    nothing; a seeded fence reads nothing inside its deadline and an
    unseeded one reads once; still_held and release read nothing inside
    the deadline."""
    L = pkg.leases
    for u in ("u0", "u1", "group-2"):
        assert L.try_acquire(root, u, "hostA", ttl_s=10.0) is not None
    with open(os.path.join(root, "u9.json.tmp.123"), "w") as f:
        f.write("debris")
    s0 = ops(pkg, "scan")
    assert L.scan_units(root) == {"u0", "u1", "group-2"}
    assert ops(pkg, "scan") == s0 + 1
    assert L.scan_units(root + ".gone") is None

    lease = L.try_acquire(root, "u3", "hostA", ttl_s=10.0,
                          known_missing=True)
    r0 = ops(pkg, "read")
    assert lease is not None and ops(pkg, "read") == r0
    assert L.try_acquire(root, "u3", "hostB", ttl_s=10.0,
                         known_missing=True) is None
    r0, p0 = ops(pkg, "read"), ops(pkg, "publish")
    L.renew_fast(lease, ttl_s=10.0)
    assert (ops(pkg, "read"), ops(pkg, "publish")) == (r0 + 1, p0 + 1)

    cache = {}
    assert L.try_acquire(root, "u0", "hostB", ttl_s=10.0,
                         held_cache=cache) is None
    assert cache["u0"] > time.time()
    t0 = ops(pkg)
    conflicts = pkg.obs.registry().counter("lease_acquire_conflicts_total")
    c0 = conflicts.total()
    assert L.try_acquire(root, "u0", "hostB", ttl_s=10.0,
                         held_cache=cache) is None
    assert ops(pkg) == t0 and conflicts.total() == c0

    r0 = ops(pkg, "read")
    fence = L.fence_at(root, "u3", "hostA", 0, deadline=lease.deadline)
    assert fence() and fence() and fence()
    assert ops(pkg, "read") == r0
    cold = L.fence_at(root, "u3", "hostA", 0)
    assert cold() and cold()
    assert ops(pkg, "read") == r0 + 1
    t0 = ops(pkg)
    assert L.still_held(lease)
    assert ops(pkg) == t0
    u0 = ops(pkg, "unlink")
    L.release(lease)
    assert ops(pkg, "read") == r0 + 1 and ops(pkg, "unlink") == u0 + 1
    assert L.read_lease(root, "u3") is None


@BOTH
def test_fence_at_trips_past_its_deadline_for_good(root, pkg):
    L = pkg.leases
    victim = L.try_acquire(root, "u0", "hostA", ttl_s=0.05)
    fence = L.fence_at(root, "u0", "hostA", 0, deadline=victim.deadline)
    assert fence()
    time.sleep(0.1)  # the stall: the deadline passes, nobody renews
    thief = L.try_acquire(root, "u0", "thief", ttl_s=10.0)
    assert thief is not None and thief.epoch == 1
    assert not fence()
    _thief_record(pkg, root, "u0", "hostA", 0, time.time() + 30.0)
    assert not fence()  # a tripped fence never recovers


@BOTH
def test_legacy_pin_restores_read_backed_paths(root, ops, monkeypatch, pkg):
    """LDDL_TPU_COORD_LEGACY=1: acquire reads back, every fence call and
    still_held read, release verifies before its unlink."""
    monkeypatch.setenv("LDDL_TPU_COORD_LEGACY", "1")
    L = pkg.leases
    r0 = ops(pkg, "read")
    lease = L.try_acquire(root, "u0", "hostA", ttl_s=10.0,
                          known_missing=True)
    assert lease is not None and ops(pkg, "read") == r0 + 1
    fence = L.fence_at(root, "u0", "hostA", 0, deadline=lease.deadline)
    r1 = ops(pkg, "read")
    assert fence() and fence()
    assert ops(pkg, "read") == r1 + 2
    assert L.still_held(lease) and ops(pkg, "read") == r1 + 3
    L.release(lease)
    assert ops(pkg, "read") == r1 + 4


@BOTH
def test_batched_keeper_pass_op_budget(root, ops, pkg):
    """One keeper pass over n held leases costs at most 1 scan + 2n ops,
    and keeps them alive."""
    L = pkg.leases
    held = [L.try_acquire(root, "u{}".format(i), "hostA", ttl_s=0.4)
            for i in range(4)]
    assert all(held)
    t0 = ops(pkg)
    keeper = L.LeaseKeeper(0.4)
    try:
        for lease in held:
            keeper.add(lease)
        time.sleep(1.0)
        assert all(L.verify(x) and not x.lost for x in held)
    finally:
        keeper.stop()
    passes = ops(pkg, "scan")
    assert passes >= 1
    assert ops(pkg) - t0 - len(held) <= passes * (1 + 2 * len(held))


@BOTH
def test_holder_sanitization(pkg):
    L = pkg.leases
    assert L.sanitize_holder("host a/b:1") == "host-a-b-1"
    with pytest.raises(ValueError):
        L.sanitize_holder("///")
    h = L.default_holder()
    assert h == L.sanitize_holder(h)


# ------------------------------------------------------ the CAS protocol


@BOTH
def test_cas_backend_primitives(tmp_path, pkg):
    """``is_cas`` on both backends; the mock store's conditional create,
    chained put, versioned read and conditional delete; the local
    backend's create-only put."""
    mock = pkg.backend.MockObjectStore()
    local = pkg.backend.LocalBackend()
    assert mock.is_cas and not local.is_cas
    path = str(tmp_path / "obj.json")
    g1 = mock.put_if_match(path, b"one", None)
    with pytest.raises(pkg.backend.CASConflict):
        mock.put_if_match(path, b"again", None)
    g2 = mock.put_if_match(path, b"two", g1)
    with pytest.raises(pkg.backend.CASConflict):
        mock.put_if_match(path, b"stale", g1)
    assert mock.get_versioned(path) == (b"two", g2)
    with pytest.raises(pkg.backend.CASConflict):
        mock.delete_if_match(path, g1)
    assert mock.delete_if_match(path, g2)
    assert mock.get_versioned(path) == (None, None)
    lpath = str(tmp_path / "local.json")
    assert local.put_if_match(lpath, "x", None) == 1
    with pytest.raises(pkg.backend.CASConflict):
        local.put_if_match(lpath, "y", None)
    with pytest.raises(NotImplementedError):
        local.put_if_match(lpath, "y", 1)
    data, version = local.get_versioned(lpath)
    assert data == b"x" and version[0] == 1
    assert local.delete_if_match(lpath, version)
    assert local.get_versioned(lpath) == (None, None)


@BOTH
def test_cas_steal_fences_the_loser_and_release_deletes(tmp_path,
                                                        monkeypatch, pkg):
    """On the mock store a fenced loser's renewal fails its conditional
    put (LeaseLost), the thief's release is a conditional delete, and a
    conflict is never retried."""
    monkeypatch.setenv("LDDL_TPU_STORAGE_BACKEND", "mock")
    monkeypatch.setenv("LDDL_TPU_METRICS_DIR", str(tmp_path / "metrics"))
    pkg.obs.registry().reset()
    L = pkg.leases
    root = str(tmp_path / "leases")
    zombie = L.try_acquire(root, "u0", "zombie", ttl_s=0.05)
    assert zombie is not None and zombie.gen is not None
    time.sleep(0.1)
    thief = L.try_acquire(root, "u0", "thief", ttl_s=10.0)
    assert thief is not None and thief.epoch == 1 and thief.gen != zombie.gen
    with pytest.raises(L.LeaseLost):
        L.renew(zombie, ttl_s=10.0)
    gen = thief.gen
    L.renew_fast(thief, ttl_s=10.0)
    assert thief.gen != gen and L.verify(thief)
    assert L.scan_units(root) == {"u0"}
    L.release(thief)
    assert L.read_lease(root, "u0") is None
    assert L.scan_units(root) == set()
    reg = pkg.obs.registry()
    assert reg.counter("lease_steals_total").total() == 1
    assert reg.counter("resilience_retry_attempts_total").total() == 0


@BOTH
def test_cas_injected_conflict_is_a_lost_race(tmp_path, monkeypatch, pkg):
    """An injected ``cas-put`` conflict makes the acquire a lost race
    (None), not an error; the next acquire wins."""
    monkeypatch.setenv("LDDL_TPU_STORAGE_BACKEND", "mock")
    root = str(tmp_path / "leases")
    pkg.faults.arm("cas-put:conflict:nth=1")
    assert pkg.leases.try_acquire(root, "u0", "hostA", ttl_s=10.0) is None
    pkg.faults.disarm()
    lease = pkg.leases.try_acquire(root, "u0", "hostA", ttl_s=10.0)
    assert lease is not None and lease.epoch == 0


def test_lease_records_are_the_references(tmp_path):
    """The bytes of a lease record written by the port parse to the
    reference's record shape, and each package reads the other's."""
    root = str(tmp_path / "leases")
    lease = PORT.leases.try_acquire(root, "u0", "hostA", ttl_s=10.0)
    with open(lease.path) as f:
        rec = json.load(f)
    assert rec == REF.leases.read_lease(root, "u0")
    assert REF.leases.verify_at(root, "u0", "hostA", 0)
    assert REF.leases.try_acquire(root, "u0", "hostB", ttl_s=10.0) is None
