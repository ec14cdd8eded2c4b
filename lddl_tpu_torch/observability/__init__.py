"""Pipeline-wide telemetry: metrics registry, span tracing, exporters,
fleet spools, time series, alert rules and the autoscaler.

Counterpart of ``lddl_tpu/observability``: the layer every stage
(preprocess, balance, ingest, loader, resilience) reports into. Inert by
contract: instrumentation never raises into the pipeline, touches no
RNG stream and writes nothing into a shard directory; when disabled (the
default) every hook is one env-dict lookup.

Arm it with ``LDDL_TPU_METRICS_DIR=/path`` (inherited by worker
processes) or ``observability.configure(dir=...)``; arm the fleet spools
with ``LDDL_TPU_FLEET_DIR=<output dir>`` or a CLI's
``--fleet-telemetry``, and read them with ``python -m
lddl_tpu_torch.tools.pipeline_status <output dir>``. Metric names are
the reference's (the README's catalog)::

    from lddl_tpu_torch import observability as obs

    obs.configure(dir="/tmp/metrics", periodic=True)
    with obs.span("preprocess.scatter", shard=3):
        ...
    obs.inc("preprocess_docs_total", 128)
    obs.set_gauge("loader_padding_efficiency", 0.87)
    print(obs.summary()["padding_efficiency"])
    obs.write_summary()          # summary-*.json + trace flush
"""

from . import alerts, attribution, fleet, series
from .exporters import (
    configure,
    disable,
    export_jsonl,
    export_prom,
    install_signal_flush,
    start_periodic_export,
    stop_periodic_export,
    summary,
    write_summary,
)
from .registry import (
    Counter,
    Gauge,
    Histogram,
    Registry,
    enabled,
    inc,
    metrics_dir,
    observe,
    rank,
    registry,
    set_gauge,
)
from .tracing import event, flush, span, trace_path

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "alerts",
    "attribution",
    "configure",
    "disable",
    "enabled",
    "event",
    "export_jsonl",
    "export_prom",
    "fleet",
    "flush",
    "install_signal_flush",
    "inc",
    "metrics_dir",
    "observe",
    "rank",
    "registry",
    "series",
    "set_gauge",
    "span",
    "start_periodic_export",
    "stop_periodic_export",
    "summary",
    "trace_path",
    "write_summary",
]
