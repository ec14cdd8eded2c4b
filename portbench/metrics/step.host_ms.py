"""Mean host ms for ``step(batch)`` to return in the window (benchmark
span): the dispatch of a step's forward, backward and optimizer."""


def read(ctx):
    spans = ctx["spans"]["step"]
    return 1e3 * sum(spans) / len(spans) if spans else None
