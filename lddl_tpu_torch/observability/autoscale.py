"""Telemetry-driven autoscaling for the elastic ingest fleet.

Counterpart of ``lddl_tpu/observability/autoscale.py``. An
:class:`Autoscaler` reads ``fleet.aggregate``'s report and spawns or
retires local helper host processes (callables supplied by the caller:
``ingest_watch --autoscale`` wires them to subprocesses that join the
pending generation's elastic claim loop) to hold an ingest backlog SLO.

Decision policy (deliberately boring — a thermostat, not a controller):

- **scale up** one helper per observation while the max backlog gauge is
  at/above ``backlog_slo_docs`` — or the service is WEDGED (live hosts,
  pending work, no progress: a stuck claim loop wants more claimants) —
  and fewer than ``max_helpers`` run;
- **scale down** one helper per observation after ``drain_rounds``
  consecutive calm observations (no backlog, not wedged, no pending
  work) with more than ``min_helpers`` running.

Every decision is journaled as a fleet lifecycle event
(``autoscale.scale_up`` / ``autoscale.scale_down`` — they surface in
``pipeline_status``'s event table automatically) and counted in
``autoscale_decisions_total{action=...}``.

This module is intentionally **clock-free**: decisions derive only from
the aggregate report and observation counting; pacing belongs to the
caller's loop, and every wall-clock read stays inside
``fleet.aggregate``.
"""

import logging

from . import fleet
from . import inc as obs_inc

_log = logging.getLogger("lddl_tpu_torch.observability.autoscale")


def backlog_of(report):
    """The fleet's worst ingest backlog (docs): the max of every host's
    ``ingest_backlog_docs`` gauge — max, not sum, because hosts observe
    the same landing directory (the gauge is a fleet-wide fact each host
    reports, not a per-host share)."""
    worst = 0
    for st in report.get("hosts", {}).values():
        v = st.get("gauges", {}).get("ingest_backlog_docs")
        if v is not None:
            worst = max(worst, int(v))
    return worst


class Autoscaler(object):
    """Spawn/retire helper processes to hold a backlog SLO.

    ``spawn()`` must start one helper and return an opaque handle;
    ``retire(handle)`` must stop it. Handles are retired LIFO (the most
    recently added helper leaves first). The autoscaler never inspects a
    handle — process management stays with the caller."""

    def __init__(self, root, spawn, retire, *, backlog_slo_docs,
                 max_helpers, min_helpers=0, drain_rounds=3,
                 stall_ttl=None, wedge_window=None, log=None):
        if backlog_slo_docs <= 0:
            raise ValueError("backlog_slo_docs must be > 0, got {}".format(
                backlog_slo_docs))
        if max_helpers < min_helpers:
            raise ValueError("max_helpers {} < min_helpers {}".format(
                max_helpers, min_helpers))
        self.root = root
        self._spawn = spawn
        self._retire = retire
        self.backlog_slo_docs = int(backlog_slo_docs)
        self.max_helpers = int(max_helpers)
        self.min_helpers = int(min_helpers)
        self.drain_rounds = max(1, int(drain_rounds))
        self.stall_ttl = stall_ttl
        self.wedge_window = wedge_window
        self._log_fn = log or (lambda msg: _log.info("%s", msg))
        self._helpers = []
        self._calm = 0
        self.decisions = []  # (action, reason) history, for callers/tests

    @property
    def helper_count(self):
        return len(self._helpers)

    def step(self):
        """One control round: aggregate the fleet spools, then decide.
        Returns the observation dict (see :meth:`observe`)."""
        report = fleet.aggregate(self.root, stall_ttl=self.stall_ttl,
                                 wedge_window=self.wedge_window)
        return self.observe(report)

    def observe(self, report):
        """Decide from one aggregate report. Split from :meth:`step` so
        tests (and other controllers) can feed synthetic reports."""
        backlog = backlog_of(report)
        health = report.get("health", {})
        wedged = bool(health.get("wedged"))
        pending = report.get("pending_work")
        obs = {"backlog_docs": backlog, "wedged": wedged,
               "pending_work": pending, "helpers": len(self._helpers),
               "decision": None}
        if (backlog >= self.backlog_slo_docs or wedged) \
                and len(self._helpers) < self.max_helpers:
            reason = ("wedged" if wedged and backlog < self.backlog_slo_docs
                      else "backlog {} >= slo {}".format(
                          backlog, self.backlog_slo_docs))
            self._calm = 0
            obs["decision"] = self._scale_up(reason, backlog)
        elif backlog == 0 and not wedged and pending is None:
            self._calm += 1
            if self._calm >= self.drain_rounds \
                    and len(self._helpers) > self.min_helpers:
                obs["decision"] = self._scale_down(
                    "drained for {} round(s)".format(self._calm), backlog)
        else:
            self._calm = 0
        obs["helpers"] = len(self._helpers)
        return obs

    def _scale_up(self, reason, backlog):
        handle = self._spawn()
        self._helpers.append(handle)
        self._journal("scale_up", reason, backlog)
        return "scale_up"

    def _scale_down(self, reason, backlog):
        handle = self._helpers.pop()
        try:
            self._retire(handle)
        finally:
            self._journal("scale_down", reason, backlog)
        return "scale_down"

    def _journal(self, action, reason, backlog):
        self.decisions.append((action, reason))
        obs_inc("autoscale_decisions_total", action=action)
        fleet.record("autoscale.{}".format(action), reason=reason,
                     backlog_docs=backlog, helpers=len(self._helpers),
                     slo_docs=self.backlog_slo_docs)
        self._log_fn("autoscale: {} ({}); {} helper(s) now running".format(
            action, reason, len(self._helpers)))

    def shutdown(self):
        """Retire every helper (service stopping). Each retirement is
        journaled like a drain-driven scale-down."""
        while self._helpers:
            self._scale_down("service shutdown", 0)
