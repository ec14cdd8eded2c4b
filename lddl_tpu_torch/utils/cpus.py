"""CPU-count detection that respects cgroup/affinity limits.

Counterpart of ``lddl_tpu/utils/cpus.py``. ``os.cpu_count()`` reports the
machine's cores, not this process's allowance: inside a cgroup-limited
container or after ``sched_setaffinity`` it overcounts, so every pool
sized from it oversubscribes the host.
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


def loader_io_threads():
    """Threads ONE loader worker stream adds for shard I/O when the
    read-ahead pipeline is on (fetchers + decode-ahead, see
    ``loader/shardcache.py``); 0 with ``LDDL_TPU_LOADER_PREFETCH_SHARDS=0``.
    Pool sizing subtracts it through :func:`pool_cpu_budget`."""
    from ..loader.shardcache import io_thread_count
    return io_thread_count()


def pool_cpu_budget(reserve=0):
    """:func:`usable_cpu_count` minus ``reserve`` helper threads, floored
    at 1."""
    return max(1, usable_cpu_count() - max(0, reserve))
