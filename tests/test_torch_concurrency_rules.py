"""The port's concurrency invariant analyzer
(lddl_tpu_torch/analysis/concurrency) against lddl_tpu's, and the port's
counterparts of the regression pins for the races it surfaced; one
counterpart per test of ``tests/test_concurrency_rules.py``.

Layers:

1. Fixture corpus — for EACH of the four rules: at least one
   interprocedural true positive (the racy/unsafe effect lives in a
   different function or file than the boundary that makes it unsafe)
   and at least one locked/sanitized negative that must stay silent.
   Every fixture tree is written in the port's terms and mirrored, paths
   and names mapped, for lddl_tpu's analyzer
   (``tests/_torch_analysis_common.py``): both reports must agree.
2. Engine exemptions — the observability registry allow-list, the
   flush-on-TERM blocking sanction (locks stay unsanctioned), and the
   env-source exemption.
3. Integration — suppressions and the content-hash cache apply to the
   concurrency findings exactly as to the dataflow ones (cfacts ride
   the same cache entries).
4. Regression pins, on the port's modules: fleet._hb / fleet._ev_segment
   / series._segment writes under their RLocks, backend._instances_lock
   reentrant, faults._state behind a lock — concurrent functional
   smokes plus the full-tree gate staying at zero. Each pin scrubs the
   fleet variables with a plain ``os.environ.pop`` before and after
   (``_torch_fleet_common.reset_both``): ``fleet.configure`` sets
   ``LDDL_TPU_METRICS_DIR`` and the fleet variables, which would arm
   telemetry for every later test of the worker.
"""

import json
import os
import textwrap
import threading

import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import _torch_fleet_common as fc  # noqa: E402
from _torch_analysis_common import analysis  # noqa: E402
from lddl_tpu_torch.analysis import concurrency  # noqa: E402


def write_tree(root, files):
    for rel, src in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))


def run_tree(tmp_path, files, rules=None, cache=False, **kw):
    write_tree(tmp_path, files)
    top = sorted({rel.split("/")[0] for rel in files})
    return analysis.run_check(
        top, root=str(tmp_path), baseline_path=kw.pop("baseline_path", ""),
        rules=analysis.get_rules(rules) if rules else None,
        cache_path=str(tmp_path / "cache.json") if cache else None, **kw)


def findings(report, rule):
    return [f for f in report.new if f.rule == rule]


# ----------------------------------------------------------- thread-escape


THREAD_ESCAPE_TP = {
    "app/state.py": """\
        CACHE = {}
        """,
    "app/worker.py": """\
        import threading

        from app import state

        def start():
            t = threading.Thread(
                target=lambda: state.CACHE.update({"k": 1}))
            t.start()
            return t

        def record(v):
            state.CACHE["x"] = v
        """,
}


def test_thread_escape_through_lambda(tmp_path):
    """The boundary is a lambda handed to Thread(target=); the other
    side's write lives in a different function — neither alone is a
    finding, the cross-thread pair is."""
    report = run_tree(tmp_path, THREAD_ESCAPE_TP, rules=["thread-escape"])
    hits = findings(report, "thread-escape")
    assert len(hits) == 2, [f.format() for f in report.new]
    # Line 7: the lambda's .update() on the thread side; line 12: the
    # main-side subscript write in record().
    assert {(f.path, f.line) for f in hits} == {
        ("app/worker.py", 7), ("app/worker.py", 12)}
    assert "app.state.CACHE" in hits[0].message


def test_thread_escape_locked_negative(tmp_path):
    files = {
        "app/state.py": """\
            import threading
            CACHE = {}
            LOCK = threading.Lock()
            """,
        "app/worker.py": """\
            import threading

            from app import state

            def start():
                t = threading.Thread(target=_loop)
                t.start()

            def _loop():
                with state.LOCK:
                    state.CACHE.update({"k": 1})

            def record(v):
                with state.LOCK:
                    state.CACHE["x"] = v
            """,
    }
    report = run_tree(tmp_path, files, rules=["thread-escape"])
    assert findings(report, "thread-escape") == []


def test_thread_escape_through_param_mutation(tmp_path):
    """The fleet.rotating_path bug class: the global is passed INTO a
    helper that mutates its parameter — the write happens two frames
    away from the global's name."""
    files = {
        "app/seg.py": """\
            import threading

            STATE = {}

            def bump(d):
                d["n"] = 1

            def on_thread():
                bump(STATE)

            def start():
                threading.Thread(target=on_thread).start()

            def main_side():
                bump(STATE)
            """,
    }
    report = run_tree(tmp_path, files, rules=["thread-escape"])
    hits = findings(report, "thread-escape")
    assert {(f.path, f.line) for f in hits} == {
        ("app/seg.py", 9), ("app/seg.py", 15)}


def test_thread_escape_entry_lock_negative(tmp_path):
    """A helper only ever CALLED with the lock held counts as guarded
    (must-hold entry analysis) — the write itself has no lexical
    ``with``."""
    files = {
        "app/seg.py": """\
            import threading

            STATE = {}
            LOCK = threading.Lock()

            def bump():
                STATE["n"] = 1

            def on_thread():
                with LOCK:
                    bump()

            def start():
                threading.Thread(target=on_thread).start()

            def main_side():
                with LOCK:
                    bump()
            """,
    }
    report = run_tree(tmp_path, files, rules=["thread-escape"])
    assert findings(report, "thread-escape") == []


def test_thread_escape_registry_exempt(tmp_path):
    """The sanctioned observability registry is the one shared-state
    surface allowed to manage its own discipline (allow-listed)."""
    files = {
        "lddl_tpu_torch/observability/registry.py":
            THREAD_ESCAPE_TP["app/worker.py"],
        "app/state.py": THREAD_ESCAPE_TP["app/state.py"],
        "app/worker.py": THREAD_ESCAPE_TP["app/worker.py"],
    }
    report = run_tree(tmp_path, files, rules=["thread-escape"])
    hits = findings(report, "thread-escape")
    # The same racy code fires in app/worker.py but NOT in the
    # allow-listed registry path.
    assert hits and all(f.path == "app/worker.py" for f in hits)


def test_thread_escape_immutable_global_negative(tmp_path):
    """Rebinding-style scalars and tuples are not escaped MUTABLE
    state; only shared containers fire."""
    files = {
        "app/state.py": """\
            LIMIT = (1, 2)
            """,
        "app/worker.py": """\
            import threading

            from app import state

            def start():
                threading.Thread(target=_loop).start()

            def _loop():
                return state.LIMIT
            """,
    }
    report = run_tree(tmp_path, files, rules=["thread-escape"])
    assert findings(report, "thread-escape") == []


# -------------------------------------------------------------- lock-order


def test_lock_order_inversion_across_functions(tmp_path):
    """A takes B through one call chain, B takes A through another —
    neither function alone shows both locks."""
    files = {
        "app/sync.py": """\
            import threading

            A = threading.Lock()
            B = threading.Lock()

            def ab():
                with A:
                    take_b()

            def take_b():
                with B:
                    pass

            def ba():
                with B:
                    take_a()

            def take_a():
                with A:
                    pass
            """,
    }
    report = run_tree(tmp_path, files, rules=["lock-order"])
    hits = findings(report, "lock-order")
    assert len(hits) == 1, [f.format() for f in report.new]
    assert "both orders" in hits[0].message
    assert "app.sync.A" in hits[0].message
    assert "app.sync.B" in hits[0].message


def test_lock_order_consistent_negative(tmp_path):
    files = {
        "app/sync.py": """\
            import threading

            A = threading.Lock()
            B = threading.Lock()

            def one():
                with A:
                    with B:
                        pass

            def two():
                with A:
                    inner()

            def inner():
                with B:
                    pass
            """,
    }
    report = run_tree(tmp_path, files, rules=["lock-order"])
    assert findings(report, "lock-order") == []


def test_lock_order_self_deadlock(tmp_path):
    """A non-reentrant Lock re-acquired down the call chain deadlocks;
    the RLock twin stays silent."""
    files = {
        "app/sync.py": """\
            import threading

            A = threading.Lock()
            R = threading.RLock()

            def outer():
                with A:
                    inner()

            def inner():
                with A:
                    pass

            def outer_r():
                with R:
                    inner_r()

            def inner_r():
                with R:
                    pass
            """,
    }
    report = run_tree(tmp_path, files, rules=["lock-order"])
    hits = findings(report, "lock-order")
    assert len(hits) == 1
    assert "app.sync.A" in hits[0].message
    assert "re-acquired" in hits[0].message or "already" in \
        hits[0].message


# ----------------------------------------------------------- signal-safety


def test_signal_handler_blocking_call(tmp_path):
    """The blocking write lives two calls below the handler, and the
    handler itself is a nested def (the exporters.install_signal_flush
    shape)."""
    files = {
        "svc/handlers.py": """\
            import signal

            def install():
                def _on_term(signum, frame):
                    save()
                signal.signal(signal.SIGTERM, _on_term)

            def save():
                flush_to_disk()

            def flush_to_disk():
                with open("/tmp/x", "w") as f:
                    f.write("bye")
            """,
    }
    report = run_tree(tmp_path, files, rules=["signal-safety"])
    hits = findings(report, "signal-safety")
    assert len(hits) == 1, [f.format() for f in report.new]
    assert hits[0].path == "svc/handlers.py" and hits[0].line == 12
    assert "write-mode open()" in hits[0].message


def test_signal_handler_nonreentrant_lock(tmp_path):
    files = {
        "svc/handlers.py": """\
            import signal
            import threading

            L = threading.Lock()
            R = threading.RLock()

            def install():
                signal.signal(signal.SIGTERM, _on_term)

            def _on_term(signum, frame):
                finish()

            def finish():
                with L:
                    pass
                with R:
                    pass
            """,
    }
    report = run_tree(tmp_path, files, rules=["signal-safety"])
    hits = findings(report, "signal-safety")
    # The Lock fires, the RLock (the registries' idiom) does not.
    assert len(hits) == 1
    assert "svc.handlers.L" in hits[0].message
    assert "RLock" in hits[0].message


def test_signal_safety_not_on_handler_path_negative(tmp_path):
    """The identical blocking/locking code with no signal registration
    reaching it stays silent."""
    files = {
        "svc/handlers.py": """\
            import threading

            L = threading.Lock()

            def finish():
                with L:
                    with open("/tmp/x", "w") as f:
                        f.write("bye")
            """,
    }
    report = run_tree(tmp_path, files, rules=["signal-safety"])
    assert findings(report, "signal-safety") == []


def test_signal_safety_observability_sanction_is_blocking_only(tmp_path):
    """Inside the observability package the flush-on-TERM blocking I/O
    is sanctioned — but a non-reentrant lock still fires (that class is
    never sanctioned)."""
    files = {
        "lddl_tpu_torch/observability/exp.py": """\
            import signal
            import threading

            L = threading.Lock()

            def install():
                signal.signal(signal.SIGTERM, _on_term)

            def _on_term(signum, frame):
                with L:
                    with open("/tmp/x", "w") as f:
                        f.write("bye")
            """,
    }
    report = run_tree(tmp_path, files, rules=["signal-safety"])
    hits = findings(report, "signal-safety")
    assert len(hits) == 1
    assert "Lock" in hits[0].message
    assert "open" not in hits[0].message


# ---------------------------------------------------- env-read-after-spawn


def test_env_read_after_spawn_interprocedural(tmp_path):
    """The spawn hides inside a helper; the late read is in the caller
    — only the cross-function view shows read-follows-spawn."""
    files = {
        "run/pool.py": """\
            import concurrent.futures as cf
            import os

            def spawn_pool():
                return cf.ProcessPoolExecutor(2)

            def main():
                pool = spawn_pool()
                n = os.environ.get("LDDL_TPU_WORKERS", "1")
                return pool, n
            """,
    }
    report = run_tree(tmp_path, files, rules=["env-read-after-spawn"])
    hits = findings(report, "env-read-after-spawn")
    assert len(hits) == 1, [f.format() for f in report.new]
    assert hits[0].path == "run/pool.py" and hits[0].line == 9
    assert "LDDL_TPU_WORKERS" in hits[0].message


def test_env_read_before_spawn_negative(tmp_path):
    """The runner idiom — pin config, then spawn — is the
    sanctioned order."""
    files = {
        "run/pool.py": """\
            import concurrent.futures as cf
            import os

            def main():
                n = os.environ.get("LDDL_TPU_WORKERS", "1")
                os.environ.setdefault("LDDL_TPU_NATIVE_THREADS", n)
                pool = cf.ProcessPoolExecutor(int(n))
                return pool
            """,
    }
    report = run_tree(tmp_path, files, rules=["env-read-after-spawn"])
    assert findings(report, "env-read-after-spawn") == []


def test_env_read_exempt_source_negative(tmp_path):
    """Observability gating reads (enabled()-style, re-read per hook by
    design) do not count as sources even via calls."""
    files = {
        "run/pool.py": """\
            import concurrent.futures as cf

            from lddl_tpu_torch.observability import gate

            def main():
                pool = cf.ProcessPoolExecutor(2)
                if gate.enabled():
                    return pool
            """,
        "lddl_tpu_torch/observability/gate.py": """\
            import os

            def enabled():
                return bool(os.environ.get("LDDL_TPU_FLEET_DIR"))
            """,
    }
    report = run_tree(tmp_path, files, rules=["env-read-after-spawn"])
    assert findings(report, "env-read-after-spawn") == []


# ------------------------------------------------------------- integration


def test_suppression_applies_to_concurrency_findings(tmp_path):
    files = dict(THREAD_ESCAPE_TP)
    files["app/worker.py"] = files["app/worker.py"].replace(
        'state.CACHE["x"] = v',
        'state.CACHE["x"] = v  # lddl: disable=thread-escape')
    report = run_tree(tmp_path, files, rules=["thread-escape"])
    hits = findings(report, "thread-escape")
    assert len(hits) == 1 and hits[0].line == 7
    assert any(f.rule == "thread-escape" and f.line == 12
               for f in report.suppressed)


def test_concurrency_facts_ride_the_cache(tmp_path):
    """Second run serves every file from cache (cfacts round-trip) and
    reproduces the identical findings."""
    cold = run_tree(tmp_path, THREAD_ESCAPE_TP, rules=["thread-escape"],
                    cache=True)
    warm = run_tree(tmp_path, THREAD_ESCAPE_TP, rules=["thread-escape"],
                    cache=True)
    assert warm.files_cached == warm.files == cold.files
    assert [(f.path, f.line, f.rule) for f in warm.new] == \
        [(f.path, f.line, f.rule) for f in cold.new]
    blob = json.loads((tmp_path / "cache.json").read_text())
    assert all("cfacts" in entry for entry in blob["files"].values())


def test_rule_ids_registered():
    assert set(concurrency.CONCURRENCY_RULE_IDS) <= set(analysis.RULE_IDS)


# ------------------------------------- regression pins for real-tree fixes


def test_concurrent_flush_events_loses_nothing(tmp_path):
    """fleet.flush_events raced the heartbeat thread on the shared
    _ev_segment dict (rotating_path mutates it outside _lock before the
    fix); N threads flushing while events stream in must land every
    event exactly once."""
    from lddl_tpu_torch.observability import fleet

    fc.reset_both()
    try:
        fleet.configure(str(tmp_path), holder_id="hA", ttl=5,
                        interval=60)
        n_events = 120
        for i in range(n_events):
            fleet.record("unit.claimed", unit="u{}".format(i), epoch=0)
        errors = []

        def flusher():
            try:
                for _ in range(10):
                    fleet.flush_events()
            except Exception as e:  # noqa: BLE001 - the assertion
                errors.append(e)

        threads = [threading.Thread(target=flusher) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        fleet.flush_events()
        assert errors == []
        spool = fleet.spool_dir()
        got = []
        for name in sorted(os.listdir(spool)):
            if name.startswith("events-pid"):
                events, torn = fleet.read_jsonl(
                    os.path.join(spool, name))
                assert torn == 0
                got.extend(ev["args"]["unit"] for ev in events
                           if ev.get("kind") == "unit.claimed")
        assert sorted(got) == sorted("u{}".format(i)
                                     for i in range(n_events))
    finally:
        fc.reset_both()


def test_concurrent_series_flush_loses_nothing(tmp_path):
    """series.flush raced the sampler thread on _segment the same way;
    concurrent flushes must persist every point exactly once."""
    from lddl_tpu_torch.observability import fleet, series

    fc.reset_both()
    try:
        fleet.configure(str(tmp_path), holder_id="hA", ttl=5,
                        interval=60)
        n_points = 80
        for _ in range(n_points):
            assert series.sample() is not None
        errors = []

        def flusher():
            try:
                for _ in range(10):
                    series.flush()
            except Exception as e:  # noqa: BLE001 - the assertion
                errors.append(e)

        threads = [threading.Thread(target=flusher) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        series.flush()
        assert errors == []
        spool = fleet.spool_dir()
        got = 0
        for name in sorted(os.listdir(spool)):
            if name.startswith(series.SEGMENT_PREFIX):
                points, torn = fleet.read_jsonl(
                    os.path.join(spool, name))
                assert torn == 0
                got += len(points)
        assert got == n_points
    finally:
        fc.reset_both()


def test_hb_handles_published_under_lock(tmp_path):
    """ensure_started publishes the heartbeat thread/stop handles under
    _lock now; the analyzer gate below enforces it statically, this
    pins the functional behavior (start + reset race-free)."""
    from lddl_tpu_torch.observability import fleet

    fc.reset_both()
    try:
        os.environ["LDDL_TPU_FLEET_DIR"] = str(tmp_path)
        os.environ["LDDL_TPU_FLEET_HEARTBEAT_S"] = "30"
        fleet.ensure_started()
        with fleet._lock:
            t = fleet._hb["thread"]
        assert t is not None and t.daemon
        fleet._reset_for_tests()
        assert fleet._hb["thread"] is None
        assert not t.is_alive() or t.join(5) is None
    finally:
        fc.reset_both()
        os.environ.pop("LDDL_TPU_FLEET_HEARTBEAT_S", None)


def test_backend_instances_lock_is_reentrant():
    """get_backend sits on the SIGTERM flush path: a signal interrupting
    a frame that holds the instances lock must be able to re-enter
    (a threading.Lock here would deadlock the dying process)."""
    from lddl_tpu_torch.resilience import backend

    assert backend._instances_lock.acquire(blocking=False)
    try:
        # Reentrant: a second acquire from the same thread succeeds.
        assert backend._instances_lock.acquire(blocking=False)
        backend._instances_lock.release()
    finally:
        backend._instances_lock.release()


def test_faults_state_refresh_is_locked():
    """faults._refresh mutates the shared clause state from whatever
    thread hits a hook; concurrent arm/refresh churn must never corrupt
    it or raise."""
    from lddl_tpu_torch.resilience import faults

    faults.disarm()
    try:
        errors = []

        def churn(spec):
            try:
                for _ in range(50):
                    faults.arm(spec)
                    faults._refresh()
            except Exception as e:  # noqa: BLE001 - the assertion
                errors.append(e)

        threads = [
            threading.Thread(target=churn, args=(spec,))
            for spec in ("sink-write:eio:p=0.0",
                         "journal-read:eio:p=0.0")]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert errors == []
        assert faults._refresh() is not None
        # The same thread can refresh while holding the lock (reentrant
        # — a signal-interrupted hook must not deadlock its own state).
        with faults._state_lock:
            faults._refresh()
    finally:
        faults.disarm()
