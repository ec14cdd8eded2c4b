"""Share (%) of the window's host time the training loop spent blocked in
``next()`` on the prefetcher, waiting for the loader (benchmark span)."""


def read(ctx):
    spans = ctx["spans"]
    return 100.0 * sum(spans["loader_wait"]) / spans["wall"]
