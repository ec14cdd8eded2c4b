"""Process-wide fault injector for chaos tests and resilience validation.

Counterpart of ``lddl_tpu/resilience/faults.py``. The resilient I/O layer
(``resilience/io.py``), the mock object store and the loader's process
workers call ``fault_point(op, path)`` at every guarded operation; when
the injector is armed, matching calls raise transient ``OSError``s,
truncate reads, sleep, or SIGKILL the calling process. Disarmed (the
default), a fault point is one dict lookup.

Arming is the ``LDDL_TPU_FAULTS`` environment variable, so spawned loader
workers inherit it; ``arm()``/``disarm()`` set/clear it and re-parse.

Spec grammar: comma-separated clauses of colon-separated fields::

    <op>:<kind>[:p=<float>][:nth=<int>][:max=<int>][:seed=<int>]
               [:path=<substr>][:delay=<float>][:flag=<file>]

    op    site name: open | read | replace | worker | lease-acquire |
          lease-renew | lease-release | journal-read | journal-publish |
          sink-write | cas-put | range-read | multipart-commit | list
          (or * for any site; the last four fire only on the mock
          object store, the journal sites at the ingest journal, the
          lease sites in ``leases.py``, ``sink-write`` on the shard
          writer's thread right before each deferred publish)
    kind  eio | estale | truncate | slow | stall | kill | conflict | stale
    p     per-call injection probability (seeded per process)
    nth   inject on exactly the Nth matching call of this process
    max   cap on injections per process (default: 1 for nth, unlimited
          for p)
    path  only calls whose path/tag contains this substring match
    delay sleep seconds for kind=slow (default 0.2) and stall (30)
    flag  cross-process once-latch: inject only while <file> does not
          exist, and create it upon injection (survives respawned
          workers)

Examples::

    LDDL_TPU_FAULTS="read:eio:p=0.2:seed=7"           # flaky shard reads
    LDDL_TPU_FAULTS="worker:kill:nth=5:path=w1:flag=/tmp/k"  # worker death

The loader's process workers tag their fault point ``w<index>`` and fire
it once per batch, before the batch is sent.
"""

import errno
import os
import random
import threading
import time

ENV_VAR = "LDDL_TPU_FAULTS"

KINDS = ("eio", "estale", "truncate", "slow", "stall", "kill", "conflict",
         "stale")

_ERRNO_OF = {
    "eio": errno.EIO,
    "estale": getattr(errno, "ESTALE", errno.EIO),
}

# Parsed state: the raw spec and its clause dicts; counters are
# per-process and per-clause, reset whenever the spec changes.
_state = {"raw": None, "clauses": []}
_state_lock = threading.RLock()


class FaultSpecError(ValueError):
    pass


_OPTIONS = {"p": float, "nth": int, "max": int, "seed": int, "path": str,
            "delay": float, "flag": str}


def _parse_clause(text, index):
    fields = text.strip().split(":")
    if len(fields) < 2:
        raise FaultSpecError(
            "fault clause {!r} needs at least <op>:<kind>".format(text))
    op, kind = fields[0].strip(), fields[1].strip()
    if kind not in KINDS:
        raise FaultSpecError("unknown fault kind {!r} in {!r}".format(
            kind, text))
    clause = {"op": op, "kind": kind, "p": None, "nth": None, "max": None,
              "seed": 0, "path": None,
              "delay": 30.0 if kind == "stall" else 0.2, "flag": None,
              "index": index}
    for field in fields[2:]:
        if "=" not in field:
            raise FaultSpecError("malformed option {!r} in {!r}".format(
                field, text))
        key, value = field.split("=", 1)
        if key not in _OPTIONS:
            raise FaultSpecError("unknown option {!r} in {!r}".format(
                key, text))
        clause[key] = _OPTIONS[key](value)
    if (clause["p"] is None) == (clause["nth"] is None):
        raise FaultSpecError(
            "fault clause {!r} needs exactly one of p= or nth=".format(text))
    if clause["max"] is None and clause["nth"] is not None:
        clause["max"] = 1
    return clause


def _parse(raw):
    if not raw:
        return []
    return [_parse_clause(part, i)
            for i, part in enumerate(raw.split(",")) if part.strip()]


def _refresh():
    raw = os.environ.get(ENV_VAR) or None
    with _state_lock:
        if raw != _state["raw"]:
            _state["raw"] = raw
            _state["clauses"] = _parse(raw)
            for c in _state["clauses"]:
                c["_calls"] = 0
                c["_injected"] = 0
                c["_rng"] = random.Random(c["seed"] * 1000003 + os.getpid())
        return _state["clauses"]


def arm(spec):
    """Arm the injector for this process and future child processes.
    Re-arming (even with the same spec) resets the call counters."""
    os.environ[ENV_VAR] = spec
    with _state_lock:
        _state["raw"] = None
        _refresh()


def disarm():
    os.environ.pop(ENV_VAR, None)
    _refresh()


def armed():
    return bool(_refresh())


def _should_inject(clause, op, path):
    if clause["op"] not in ("*", op):
        return False
    if clause["path"] is not None and clause["path"] not in (path or ""):
        return False
    if clause["flag"] is not None and os.path.exists(clause["flag"]):
        return False
    if clause["max"] is not None and clause["_injected"] >= clause["max"]:
        return False
    clause["_calls"] += 1
    if clause["nth"] is not None:
        return clause["_calls"] == clause["nth"]
    return clause["_rng"].random() < clause["p"]


def _latch(clause, op):
    clause["_injected"] += 1
    from ..observability import event, inc
    inc("resilience_faults_injected_total", op=op, kind=clause["kind"])
    event("resilience.fault_injected", op=op, kind=clause["kind"])
    if clause["flag"] is not None:
        try:
            with open(clause["flag"], "x") as f:
                f.write("injected\n")
        except OSError:
            pass


def fault_point(op, path=None):
    """Guarded-operation hook. Returns None (no fault) or an action the
    caller must honour: ``"truncate"`` (chop the bytes just read),
    ``"conflict"`` (mock store: raise an injected CASConflict) or
    ``"stale"`` (mock store: serve the previous listing). Raises OSError,
    sleeps or SIGKILLs the process for the other kinds."""
    clauses = _refresh()
    if not clauses:
        return None
    action = None
    with _state_lock:
        hits = [c for c in clauses if _should_inject(c, op, path)]
    for clause in hits:
        kind = clause["kind"]
        _latch(clause, op)
        if kind in ("slow", "stall"):
            time.sleep(clause["delay"])
        elif kind == "kill":
            # SIGKILL runs no atexit hook: write the telemetry first, or
            # the kill is invisible in the record it exists to make. The
            # fleet snapshot stays un-closed: the host dies abnormally,
            # and the aggregator's stall verdict keys on exactly that.
            try:
                from ..observability import exporters, fleet, tracing
                tracing.flush()
                exporters.export_jsonl()
                fleet.heartbeat(closed=False)
            except Exception:  # noqa: BLE001 - the kill must still fire
                pass
            import signal
            os.kill(os.getpid(), signal.SIGKILL)
        elif kind in ("truncate", "conflict", "stale"):
            action = kind
        else:
            raise OSError(_ERRNO_OF[kind], "injected fault [{}] at {}".format(
                kind, op), path)
    return action
