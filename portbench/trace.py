"""Reduction of a ``torch.profiler`` trace of the traced steps (the card's
activity): device time by kernel, the card's busy time (the union of its
operations' intervals), the optimizer's device time, and the longest idle
gaps named by what the host was doing when the card went idle.

After ``chip_smoke.py``'s ``profile_window``: the records of a warm-up
step are dropped by the profiler's schedule (a kernel of the first
profiled step goes unrecorded), and kernels are grouped by name.
"""

# The kernel of ``torch.cuda._sleep``, the benchmark's clock marker.
MARKER = "spin_kernel"
# The optimizer's kernels in the train step: the clip's norms (foreach
# norms and their global norm) and the foreach updates of the clip and of
# AdamW.
OPTIMIZER_KERNELS = ("multi_tensor_apply", "lpnorm", "NormTwoOps")
TOP = 10


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def summarize(prof, t_mark, window_s, host_spans, launches, batch_indices):
    """The traced steps' summary: ``kernels`` {name: [device s, launches]},
    ``busy_s``, ``window_s``, ``optimizer_s``, the port's ``launches`` a
    step, the steps' ``batch_indices`` and ``breakdown``. ``t_mark`` is the
    host time (``perf_counter``) at which the marker kernel was launched on
    the idle card; ``host_spans`` {name: [(start, end)]} on that clock."""
    kernels = {}
    for e in prof.key_averages():
        us = e.self_device_time_total
        if us > 0 and e.device_type.name == "CUDA" and MARKER not in e.key:
            kernels[e.key] = [us / 1e6, e.count]
    optimizer_s = sum(v[0] for k, v in kernels.items()
                      if any(p in k for p in OPTIMIZER_KERNELS))
    device, mark = [], None
    for e in prof.events():
        if e.device_type.name != "CUDA":
            continue
        if MARKER in e.name:
            mark = e.time_range.start
        else:
            device.append((e.time_range.start, e.time_range.end))
    # The profiler records the traced steps alone (the warm-up step's
    # records are dropped), so every interval belongs to them.
    busy = _union(device)
    gaps = []
    for (_, end), (nxt, _) in zip(busy, busy[1:]):
        # Without the marker, the host's spans cannot be placed.
        name = ("unplaced" if mark is None else
                _host_span(host_spans, (end - mark) / 1e6 + t_mark))
        gaps.append((nxt - end, name))
    gaps.sort(reverse=True)
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:TOP]
    short = [(_short(name), v) for name, v in top]
    return {
        "kernels": kernels,
        "busy_s": sum(b - a for a, b in busy) / 1e6,
        "device_events": len(device), "marker": mark is not None,
        "window_s": window_s,
        "optimizer_s": optimizer_s,
        "launches": launches,
        "batch_indices": batch_indices,
        "breakdown": {
            "device_ops": [[name, v[0]] for name, v in short],
            "idle_gaps": [[name, us / 1e6] for us, name in gaps[:TOP]]},
    }


def _short(name, width=96):
    """A kernel's name without its return type and namespaces, cut to
    ``width``."""
    name = name[5:] if name.startswith("void ") else name
    for ns in ("at::native::", "at::cuda::", "at::", "c10::",
               "(anonymous namespace)::"):
        name = name.replace(ns, "")
    return name if len(name) <= width else name[:width - 3] + "..."


def _host_span(spans, t):
    for name, ranges in spans.items():
        if any(a <= t <= b for a, b in ranges):
            return name
    return "other"
