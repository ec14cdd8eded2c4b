"""Loader critical-path attribution: where does batch wall time go?

Counterpart of ``lddl_tpu/observability/attribution.py``: the stage
vocabulary, the accumulation metric and the verdict rule. The
instrumentation sites are in ``loader/dataloader.py``,
``loader/datasets.py`` and ``loader/shardcache.py``, each behind
``registry.enabled()``.

Stages (``loader_stage_seconds_total{stage=...}``):

- self-time stages, mostly overlapped by worker threads or processes:
  ``shard_fetch`` (shard bytes fetched on the read-ahead threads),
  ``shard_read`` (the consumer's blocking wait for the next shard
  table), ``decode`` (record batch -> samples), ``collate`` (samples ->
  batch), ``ipc`` (process mode: the payload decode of a batch from a
  worker), ``h2d`` (the prefetcher's host side of a transfer to the
  device: the pinned copy and the dispatch of the asynchronous copy);
- boundary stages, which partition the consumer's wall exactly:
  ``batch_wait``/``step_gap`` (consumer blocked in the loader's
  ``__next__`` / away between batches) and ``prefetch_wait``/
  ``prefetch_gap``, the same pair at the device prefetcher, preferred
  when present because it is the outermost iterator.

Verdict: with ``wall = wait + gap`` at the outermost boundary,
``input_share = wait / wall``; ``input-bound`` at >= 0.40,
``compute-bound`` at <= 0.15, ``balanced`` between. Shares partition the
wall: the gap is ``consumer_step``, and the wait is split over the
self-time stages in proportion to their seconds (``queue_wait`` takes it
when none was observed, e.g. all of it ran in worker processes).

On a CUDA device the gap is only the step's time if the step ends in a
synchronisation (``float(loss)``, ``torch.cuda.synchronize()``): a step
that returns after dispatching its kernels makes the gap the launch time
and moves the device's time into the next ``prefetch_wait``, which then
reads as input time. Consumers that want a verdict synchronise every step.
"""

from .registry import enabled, registry, set_gauge

STAGE_METRIC = "loader_stage_seconds_total"
VERDICT_GAUGE = "loader_bound_verdict"
INPUT_SHARE_GAUGE = "loader_input_share"

# Self-time stages, in the order a batch visits them.
STAGES = ("shard_fetch", "shard_read", "decode", "collate", "ipc", "h2d")

INPUT_BOUND_SHARE = 0.40
COMPUTE_BOUND_SHARE = 0.15

# Gauge encoding of the verdict: +1 input-bound, 0 balanced, -1
# compute-bound.
VERDICT_VALUE = {"input-bound": 1.0, "balanced": 0.0, "compute-bound": -1.0}


def stage_counter():
    """The shared per-stage accumulator (sites cache the handle and
    ``inc(dt, stage=...)`` into it)."""
    return registry().counter(
        STAGE_METRIC, help="accumulated loader self-time per stage (s)")


def stage_seconds():
    """{stage: seconds} accumulated so far in this process's registry."""
    m = registry().get(STAGE_METRIC)
    if m is None or m.kind != "counter":
        return {}
    out = {}
    for label_str, v in m.snapshot()["values"].items():
        for part in label_str.split(","):
            k, _, stage = part.partition("=")
            if k == "stage" and stage:
                out[stage] = out.get(stage, 0.0) + v
    return out


def from_stage_seconds(stages):
    """The attribution report for ``{stage: seconds}``, or None when no
    boundary pair was observed. A pure function of its argument."""
    try:
        wait = float(stages.get("prefetch_wait", 0.0))
        gap = float(stages.get("prefetch_gap", 0.0))
        boundary = "prefetch"
        if wait + gap <= 0.0:
            wait = float(stages.get("batch_wait", 0.0))
            gap = float(stages.get("step_gap", 0.0))
            boundary = "loader"
        wall = wait + gap
        if wall <= 0.0:
            return None
        input_share = wait / wall
        if input_share >= INPUT_BOUND_SHARE:
            verdict = "input-bound"
        elif input_share <= COMPUTE_BOUND_SHARE:
            verdict = "compute-bound"
        else:
            verdict = "balanced"
        self_times = {s: float(stages.get(s, 0.0)) for s in STAGES
                      if float(stages.get(s, 0.0)) > 0.0}
        self_total = sum(self_times.values())
        shares = {"consumer_step": gap / wall}
        if self_total > 0.0:
            for s, v in self_times.items():
                shares[s] = input_share * (v / self_total)
        elif wait > 0.0:
            shares["queue_wait"] = input_share
        top = max(((s, sh) for s, sh in shares.items()
                   if s != "consumer_step"),
                  key=lambda kv: kv[1], default=(None, 0.0))
        return {
            "verdict": verdict,
            "input_share": input_share,
            "wall_seconds": wall,
            "boundary": boundary,
            "stages_seconds": {s: float(v) for s, v in stages.items()
                               if float(v) > 0.0},
            "shares": shares,
            "top_stage": {"stage": top[0], "share": top[1]},
        }
    except (TypeError, ValueError):
        return None


def snapshot():
    """Attribution off the live registry; also publishes the verdict and
    input-share gauges. None when telemetry is off or nothing iterated."""
    if not enabled():
        return None
    report = from_stage_seconds(stage_seconds())
    if report is None:
        return None
    set_gauge(VERDICT_GAUGE, VERDICT_VALUE[report["verdict"]])
    set_gauge(INPUT_SHARE_GAUGE, report["input_share"])
    return report


def format_report(report, indent=""):
    """Human-readable attribution block."""
    if not report:
        return indent + "loader attribution: no batches observed"
    lines = [indent + "loader bound verdict: {} (input share {:.1%} of "
             "{:.2f}s observed wall, {} boundary)".format(
                 report["verdict"], report["input_share"],
                 report["wall_seconds"], report["boundary"])]
    top = report.get("top_stage") or {}
    if top.get("stage"):
        lines.append(indent + "top contributing stage: {} ({:.1%})"
                     .format(top["stage"], top["share"]))
    gap = "prefetch_gap" if report["boundary"] == "prefetch" else "step_gap"
    for stage, share in sorted(report["shares"].items(),
                               key=lambda kv: -kv[1]):
        lines.append(indent + "  {:<14s} {:6.1%}  ({:.3f}s)".format(
            stage, share, report["stages_seconds"].get(
                gap if stage == "consumer_step" else stage, 0.0)))
    return "\n".join(lines)
