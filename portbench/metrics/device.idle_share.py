"""Share (%) of the traced window in which no operation ran on the card:
1 - the union of the kernels' device intervals over the window's length."""


def read(ctx):
    trace = ctx["trace"]
    if trace["window_s"] <= 0 or trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
