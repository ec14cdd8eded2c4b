"""Mean ms of the host side of a batch's copy to the card (tensor wrap,
pinned copy, dispatch of the asynchronous copy) over the window: the
program's ``loader_stage_seconds_total{stage="h2d"}`` over
``loader_prefetch_batches_total``."""


def read(ctx):
    before, after = ctx["counters"]
    batches = after["prefetch_batches"] - before["prefetch_batches"]
    seconds = (after["stage_s"].get("h2d", 0.0)
               - before["stage_s"].get("h2d", 0.0))
    if batches <= 0 or seconds <= 0:
        return None
    return 1e3 * seconds / batches
