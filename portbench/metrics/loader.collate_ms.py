"""Mean ms of the loader's collate a batch over the window: the program's
``loader_stage_seconds_total{stage="collate"}`` over
``loader_batches_total``, both as they grew in the window."""


def read(ctx):
    before, after = ctx["counters"]
    batches = after["loader_batches"] - before["loader_batches"]
    seconds = (after["stage_s"].get("collate", 0.0)
               - before["stage_s"].get("collate", 0.0))
    if batches <= 0 or seconds <= 0:
        return None
    return 1e3 * seconds / batches
