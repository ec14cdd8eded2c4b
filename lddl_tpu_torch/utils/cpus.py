"""CPU-count detection that respects cgroup/affinity limits.

Counterpart of ``lddl_tpu/utils/cpus.py``. ``os.cpu_count()`` reports the
machine's cores, not this process's allowance: inside a cgroup-limited
container or after ``sched_setaffinity`` it overcounts, so every pool
sized from it oversubscribes the host. The reference's
``loader_io_threads`` has no counterpart: the port's loader reads shards
synchronously and starts no shard-I/O threads to reserve cores for.
"""

import os


def usable_cpu_count():
    """Number of CPUs THIS process may run on: the scheduling-affinity
    set where the platform exposes it (Linux), else ``os.cpu_count()``.
    Never returns less than 1."""
    try:
        return max(1, len(os.sched_getaffinity(0)))
    except (AttributeError, OSError):  # non-Linux / restricted proc
        return max(1, os.cpu_count() or 1)


def pool_cpu_budget(reserve=0):
    """:func:`usable_cpu_count` minus ``reserve`` helper threads, floored
    at 1."""
    return max(1, usable_cpu_count() - max(0, reserve))
