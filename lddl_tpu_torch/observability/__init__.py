"""Pipeline telemetry: metrics registry, span tracing, loader attribution.

Counterpart of the subset of ``lddl_tpu/observability`` that the loader
reports into: ``registry`` (counters, gauges, histograms and the
per-process export under ``LDDL_TPU_METRICS_DIR``), ``tracing`` (spans
and instant events) and ``attribution`` (the loader's stage seconds and
bound verdict). Inert by contract: instrumentation never raises into the
pipeline, touches no RNG stream and writes nothing into a shard
directory; when disabled (the default) every hook is one env-dict
lookup. Arm it with ``LDDL_TPU_METRICS_DIR=/path`` (inherited by worker
processes). The reference's fleet telemetry, exporters, series, alerts
and autoscaler are not part of the port.
"""

from . import attribution
from .registry import (Counter, Gauge, Histogram, Registry, enabled,
                       export_jsonl, inc, metrics_dir, observe, rank,
                       registry, set_gauge)
from .tracing import event, flush, span, trace_path

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "attribution",
    "enabled",
    "event",
    "export_jsonl",
    "flush",
    "inc",
    "metrics_dir",
    "observe",
    "rank",
    "registry",
    "set_gauge",
    "span",
    "trace_path",
]
