"""Share (%) of their roofline the single-block attention kernels reach
in the traced steps: the least time the card needs for the work of every
``onekv_fwd`` and ``onekv_bwd`` launch (counted by the program's launch
counters, each at its step's valid row lengths) over the profiler's device
time of ``onekv_fwd``, ``onekv_bwd_dkv`` and ``onekv_bwd_dq``."""

from portbench.roofline import share


def read(ctx):
    return share(ctx["trace"], ("onekv_fwd", "onekv_bwd"), "onekv_")
