"""A kernel family's share of its roofline over traced steps."""

from . import flops


def share(trace, wrappers, kernel_prefix):
    """100 x (sum over the traced steps' launches of each launch's bound) /
    (device time of the kernels whose name holds ``kernel_prefix``), or
    None when none ran. ``trace``: the summary of ``trace.summarize`` with
    ``step_stats``."""
    bound = 0.0
    for launches, stats in zip(trace["launches"], trace["step_stats"]):
        for w in wrappers:
            if launches[w]:
                nbytes, ops = flops.kernel_work(w, stats["lens"],
                                                stats["heads"],
                                                stats["head_dim"])
                bound += launches[w] * flops.bound_s(nbytes, ops)[0]
    device = sum(s for name, (s, _) in trace["kernels"].items()
                 if kernel_prefix in name and "_f32" not in name)
    if bound <= 0 or device <= 0:
        return None
    return 100.0 * bound / device
