"""Share (%) of their roofline the online-softmax attention kernels reach
in the traced steps: the least time the card needs for the work of every
``online_fwd``, ``online_bwd_dq`` and ``online_bwd_dkv`` launch over their
profiler device time."""

from portbench.roofline import share


def read(ctx):
    return share(ctx["trace"], ("online_fwd", "online_bwd_dq",
                                "online_bwd_dkv"), "online_")
