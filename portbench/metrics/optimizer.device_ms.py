"""Device ms a traced step of the optimizer's kernels: the global-norm
clip's norms and the foreach updates of the clip and of AdamW
(``multi_tensor_apply``, ``lpnorm`` and the two-norm reduction), grouped
by name as ``chip_smoke.py``'s ``profile_window`` groups them."""


def read(ctx):
    trace = ctx["trace"]
    n = len(trace["launches"])
    if not n or trace["optimizer_s"] <= 0:
        return None
    return 1e3 * trace["optimizer_s"] / n
