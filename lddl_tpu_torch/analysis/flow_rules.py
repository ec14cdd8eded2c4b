"""The interprocedural flow rules.

Counterpart of ``lddl_tpu/analysis/flow_rules.py`` with every path scope
on the port's own modules (``lddl_tpu_torch/...``).

Each subsumes a syntactic ancestor in :mod:`.rules` by catching the
*helper-laundered* variant the ancestor cannot see: the syntactic rules
fire when a guarded pattern appears inside one function; the flow rules
fire when the pattern's **value or effect crosses a function (or
module-global) boundary** before reaching a sink. Same-function flows are
deliberately NOT reported here — that keeps the two rule families
non-overlapping, so one violation produces one finding.

These are ``scope = "project"`` rules: :func:`core.run_check` builds the
whole-tree :mod:`.project` model, extracts per-file dataflow facts
(cached by content hash), runs the :mod:`.dataflow` fixpoint once, and
routes each emitted finding through the rule whose id it carries — so
``allow`` lists, ``--rules`` filters, inline suppressions, and the
baseline all behave exactly as they do for syntactic rules.
"""

from .core import Rule, _match_any, register
from . import dataflow

# Shard-publishing packages (mirrors rules._SHARD_PKGS): call sites here
# must only publish through resilience.io.
SHARD_PKGS = ("lddl_tpu_torch/preprocess/*", "lddl_tpu_torch/balance/*",
              "lddl_tpu_torch/loader/*", "lddl_tpu_torch/resilience/*",
              "lddl_tpu_torch/ingest/*", "lddl_tpu_torch/utils/fs.py")

# The sanctioned atomic publishers: io.py's internals ARE the
# tmp+fsync+replace dance and backend.py's ARE the object-store
# multipart-upload-then-commit dance; effects never propagate out of
# them. A raw write laundered AROUND the backend is a finding.
SANCTIONED = ("lddl_tpu_torch/resilience/io.py",
              "lddl_tpu_torch/resilience/backend.py")

# Files whose raw writes never land in shard directories by construction
# (trace/metrics files and the fleet-telemetry spools under .telemetry/,
# generated C++ build trees, pre-pipeline downloads, the analyzer's own
# cache, test-only fault latches, merged-trace/report artifacts from the
# status tools) — excluded as publish-path effect SOURCES so a
# shard-package call into them is not a publish violation. A raw shard
# write anywhere else on a shard-package call path is still caught
# (fixture-pinned in tests/test_torch_dataflow.py).
PUBLISH_SOURCE_EXEMPT = (
    "lddl_tpu_torch/observability/*", "lddl_tpu_torch/analysis/*",
    "lddl_tpu_torch/native/*",
    "lddl_tpu_torch/download/*", "lddl_tpu_torch/resilience/faults.py",
    "lddl_tpu_torch/tools/pipeline_status.py",
    "lddl_tpu_torch/tools/trace_summary.py",
    "lddl_tpu_torch/tools/bench_trajectory.py",
)


class FlowRule(Rule):
    """Base for project-scope rules: run via the dataflow engine, not per
    file. ``run`` is unused; ``applies_to`` still gates findings by the
    finding's path."""

    scope = "project"

    def run(self, ctx):  # pragma: no cover - project rules don't run here
        return ()


@register
class WallClockFlowRule(FlowRule):
    id = "wall-clock-flow"
    doc = ("flow-aware wall-clock: clock/pid/uuid/hostname values that "
           "reach manifest/ledger content or publish arguments through "
           "any helper chain (subsumes wall-clock across functions)")
    # Observability files are allowlisted INDIVIDUALLY — autoscale.py is
    # deliberately absent so the analyzer proves scale decisions are
    # clock-free (derived from the fleet aggregate only).
    allow = ("lddl_tpu_torch/observability/registry.py",
             "lddl_tpu_torch/observability/tracing.py",
             "lddl_tpu_torch/observability/exporters.py",
             "lddl_tpu_torch/observability/fleet.py",
             "lddl_tpu_torch/observability/__init__.py",
             "lddl_tpu_torch/benchmarks/*",
             # tmp-file names embed the pid on purpose: the pre-publish
             # scratch name is never part of the published state (same
             # for backend.py's upload ids and part names — staging
             # identity, never object content).
             "lddl_tpu_torch/resilience/io.py",
             "lddl_tpu_torch/resilience/backend.py",
             # Lease deadlines/holder ids are wall-clock BY DESIGN (the
             # one cross-host time base a shared FS offers); the
             # lease-isolation rule — not this one — guards the boundary
             # that matters: lease state never reaches shard bytes.
             "lddl_tpu_torch/resilience/leases.py")


@register
class RngFlowRule(FlowRule):
    id = "rng-flow"
    doc = ("flow-aware RNG: draws on unkeyed generators "
           "(np.random.default_rng() / random.Random() with no key) that "
           "were laundered through helpers or module globals before "
           "shaping data (subsumes global-rng across functions)")
    allow = ("lddl_tpu_torch/testing.py",)


@register
class FsOrderFlowRule(FlowRule):
    id = "fs-order-flow"
    doc = ("flow-aware FS order: listdir/glob/walk results that cross a "
           "function boundary and are then iterated, indexed, or rendered "
           "into strings/error text without an intervening sorted() "
           "(subsumes unsorted-iteration across functions)")
    allow = ()


@register
class PublishPathFlowRule(FlowRule):
    id = "publish-path-flow"
    doc = ("flow-aware atomic publish: shard-package call paths that "
           "reach a raw write (write-mode open, pq.write_table) in a "
           "helper OUTSIDE the shard packages without passing through "
           "resilience.io (subsumes atomic-publish across functions). "
           "Models the async-sink writer-thread boundary: a callable "
           "enqueued via preprocess/sink.py is treated as called at the "
           "enqueue site (dataflow.DEFERRED_CALL_MODULE_SUFFIXES), so "
           "deferring a raw write cannot launder it past the rule")
    allow = ("lddl_tpu_torch/resilience/io.py",
             "lddl_tpu_torch/resilience/backend.py")


@register
class LeaseIsolationRule(FlowRule):
    id = "lease-isolation"
    doc = ("lease state (holder id, epoch, deadline) returned by "
           "resilience.leases must never flow into shard bytes or "
           ".manifest.json content — lease files themselves and the "
           "_done fence records are the only sanctioned sinks (the "
           "latter carry inline suppressions)")
    # No blanket allowances: the lease module's internal writes are
    # exempted at the engine level (dataflow.LEASE_MODULE), and the one
    # legitimate epoch-into-record flow in preprocess/steal.py is a
    # why-commented inline suppression.
    allow = ()


FLOW_RULE_IDS = ("wall-clock-flow", "rng-flow", "fs-order-flow",
                 "publish-path-flow", "lease-isolation")


def run_flow_analysis(module_facts):
    """Phase B over cached/extracted per-file facts. Returns
    ``[(rule_id, path, lineno, message)]`` BEFORE allow-list, suppression
    and baseline filtering (core.run_check applies those)."""
    return dataflow.analyze_modules(
        module_facts,
        shard_pkg=lambda p: _match_any(p, SHARD_PKGS),
        publish_source_ok=lambda p: not _match_any(
            p, PUBLISH_SOURCE_EXEMPT),
        sanctioned=lambda p: _match_any(p, SANCTIONED),
    ).findings
