"""Host-level collectives and the process-group init.

Counterpart of ``lddl_tpu/parallel/distributed.py`` (``Communicator``,
``LocalCommunicator``, ``ThreadGroupCommunicator``, ``get_communicator``,
``node_info``) and of the ``--multihost`` wiring of
``lddl_tpu/cli/common.py`` (``communicator_of``). The only collectives
the pipeline's host side needs are a sum and a max over small int64
vectors and a barrier: metadata, never tensor transport.

Backends:

- ``LocalCommunicator``: a world of 1; every op is the identity.
- ``TorchCommunicator``: the default ``torch.distributed`` process group
  (NCCL on the GPUs, gloo on CPUs), the counterpart of the reference's
  ``JaxCommunicator``.
- ``ThreadGroupCommunicator``: N SPMD ranks as threads in one process
  with real barrier semantics, for tests of lockstep algorithms (the
  port's own copy; no JAX in it).

``init_distributed`` joins the process group that ``torchrun`` describes
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``) or one given by explicit address, world size and rank;
``run_world`` starts a world of local processes and runs a function on
each rank (the multi-rank tests and ``entry.dryrun_multichip`` use it).
"""

import os
import queue
import socket
import threading
import time
import traceback

import numpy as np
import torch

from ..device import resolve_device
from ..utils.comm import Communicator, LocalCommunicator

# Seconds ``run_world`` waits for every rank's result before it gives up.
WORLD_TIMEOUT = 600


class TorchCommunicator(Communicator):
    """Collectives over the default ``torch.distributed`` process group.

    Requires a group of more than one rank (``init_distributed``). The
    vector travels as an int64 tensor on the backend's device (the
    current CUDA device under NCCL, the CPU under gloo), so counts of
    2^31 and more stay exact."""

    def __init__(self):
        import torch.distributed as dist
        self._dist = dist
        if not dist.is_initialized() or dist.get_world_size() <= 1:
            raise RuntimeError(
                "TorchCommunicator requires torch.distributed with >1 "
                "process; use LocalCommunicator for single-process runs")
        self._device = (torch.device("cuda", torch.cuda.current_device())
                        if dist.get_backend() == "nccl"
                        else torch.device("cpu"))

    @property
    def rank(self):
        return self._dist.get_rank()

    @property
    def world_size(self):
        return self._dist.get_world_size()

    def barrier(self):
        self._dist.barrier()

    def _allreduce(self, values, op):
        t = torch.from_numpy(np.array(values, dtype=np.int64, copy=True))
        t = t.to(self._device)
        self._dist.all_reduce(t, op=op)
        return t.cpu().numpy()

    def allreduce_sum(self, values):
        return self._allreduce(values, self._dist.ReduceOp.SUM)

    def allreduce_max(self, values):
        return self._allreduce(values, self._dist.ReduceOp.MAX)


class ThreadGroupCommunicator(Communicator):
    """N SPMD ranks as threads with real barrier/allreduce semantics.

    Test harness for lockstep algorithms (balancer, censuses). Create the
    group with :meth:`spawn`, which runs ``fn(comm)`` on every rank-thread
    and re-raises the first failure.
    """

    class _Shared:

        def __init__(self, world_size):
            self.barrier = threading.Barrier(world_size)
            self.lock = threading.Lock()
            self.reduce_buf = None
            self.reduce_result = None

    def __init__(self, rank, world_size, shared):
        self._rank = rank
        self._world_size = world_size
        self._shared = shared

    @property
    def rank(self):
        return self._rank

    @property
    def world_size(self):
        return self._world_size

    def barrier(self):
        self._shared.barrier.wait()

    def _allreduce(self, values, op):
        values = np.asarray(values, dtype=np.int64)
        with self._shared.lock:
            if self._shared.reduce_buf is None:
                self._shared.reduce_buf = []
            self._shared.reduce_buf.append(values)
        self._shared.barrier.wait()
        if self._rank == 0:
            self._shared.reduce_result = op(
                np.stack(self._shared.reduce_buf), axis=0).astype(np.int64)
            self._shared.reduce_buf = None
        self._shared.barrier.wait()
        # Copy: every rank owns its result, so an in-place change on one
        # rank-thread cannot show on another.
        result = self._shared.reduce_result.copy()
        self._shared.barrier.wait()
        return result

    def allreduce_sum(self, values):
        return self._allreduce(values, np.sum)

    def allreduce_max(self, values):
        return self._allreduce(values, np.max)

    @classmethod
    def spawn(cls, world_size, fn):
        """Run ``fn(comm)`` on ``world_size`` rank-threads; returns the list
        of per-rank return values; re-raises the first exception."""
        shared = cls._Shared(world_size)
        results = [None] * world_size
        errors = [None] * world_size

        def run(rank):
            try:
                results[rank] = fn(cls(rank, world_size, shared))
            except BaseException as e:  # noqa: BLE001 - re-raised below
                errors[rank] = e
                # Break the barrier so peers don't deadlock.
                shared.barrier.abort()

        threads = [
            threading.Thread(target=run, args=(r,)) for r in range(world_size)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for e in errors:
            if e is not None and not isinstance(e,
                                                threading.BrokenBarrierError):
                raise e
        for e in errors:
            if e is not None:
                raise e
        return results


def rotate(tensors, group, shift=1):
    """Send each tensor ``shift`` ranks on around ``group``'s ring and
    receive the tensor of the rank ``shift`` back: 1 hands to the next
    rank, -1 to the previous one. One batch of p2p ops, which every rank
    of the group must issue in the same order."""
    import torch.distributed as dist
    n = dist.get_world_size(group)
    r = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (r + shift) % n)
    prv = dist.get_global_rank(group, (r - shift) % n)
    outs = [torch.empty_like(t) for t in tensors]
    ops = []
    for t, out in zip(tensors, outs):
        ops.append(dist.P2POp(dist.isend, t.contiguous(), nxt, group))
        ops.append(dist.P2POp(dist.irecv, out, prv, group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return outs


def _group_is_up():
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def get_communicator():
    """``TorchCommunicator`` when a process group of more than one rank is
    up, else ``LocalCommunicator``."""
    import torch.distributed as dist
    if _group_is_up() and dist.get_world_size() > 1:
        return TorchCommunicator()
    return LocalCommunicator()


def node_info():
    """(node_rank, num_nodes) of this host, from the variables torchrun
    sets (``GROUP_RANK``, ``WORLD_SIZE``, ``LOCAL_WORLD_SIZE``) once the
    process group is up; (0, 1) before that."""
    if not _group_is_up():
        return 0, 1
    env = os.environ
    world = int(env.get("WORLD_SIZE", 1))
    per_node = int(env.get("LOCAL_WORLD_SIZE", world))
    return int(env.get("GROUP_RANK", 0)), max(1, world // max(per_node, 1))


def init_distributed(device=None, init_method=None, world_size=None,
                     rank=None):
    """Join the default process group and return this rank's device.

    The group comes from ``env://`` (torchrun's ``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``) unless ``init_method`` (e.g.
    ``"tcp://10.0.0.1:29500"``), ``world_size`` and ``rank`` are given,
    which go together or not at all. NCCL on ``cuda:LOCAL_RANK`` (made
    the current device) by default; gloo on the CPU only when the caller
    passes ``device="cpu"``. Raises, as ``resolve_device`` does, when no
    card is present and the CPU was not asked for."""
    import torch.distributed as dist
    wiring = (init_method, world_size, rank)
    if any(v is not None for v in wiring) and None in wiring:
        raise ValueError("init_method, world_size and rank must be given "
                         "together (or none, for torchrun's env://)")
    if _group_is_up():
        raise RuntimeError("the default process group is already up")
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            local = os.environ.get("LOCAL_RANK")
            index = (int(local) if local is not None
                     else int(rank or 0) % torch.cuda.device_count())
            dev = torch.device("cuda", index)
        torch.cuda.set_device(dev)
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError("init_distributed runs on cuda or cpu, not "
                         "{}".format(dev))
    kwargs = {}
    if init_method is not None:
        kwargs = dict(init_method=init_method, world_size=int(world_size),
                      rank=int(rank))
    if backend == "nccl":
        kwargs["device_id"] = dev
    dist.init_process_group(backend=backend, **kwargs)
    return dev


def _free_port():
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, world_size, port, device, fn, args, results):
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world_size),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world_size),
                      GROUP_RANK="0")
    import torch.distributed as dist
    if device == "cpu":
        torch.set_num_threads(1)
    try:
        init_distributed(device=device)
        results.put((rank, True, fn(*args)))
    except BaseException:  # noqa: BLE001 - reported to the parent
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_world(world_size, fn, *args, device=None):
    """Run ``fn(*args)`` on every rank of a fresh world of ``world_size``
    local processes (the ``spawn`` start method) joined on localhost by
    ``init_distributed(device)``: NCCL, one card each, by default; gloo
    with ``device="cpu"``. ``fn`` must be importable by name. Returns the
    results in rank order; raises with a failing rank's traceback, and
    when a rank ends without a result or ``WORLD_TIMEOUT`` seconds pass;
    every process is ended before it returns."""
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world_size, port, device, fn, args,
                               results),
                         daemon=True) for r in range(world_size)]
    for p in procs:
        p.start()
    out = [None] * world_size
    done = set()
    deadline = time.monotonic() + WORLD_TIMEOUT
    try:
        while len(done) < world_size:
            try:
                rank, ok, payload = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in done and p.exitcode is not None]
                if dead or time.monotonic() > deadline:
                    raise RuntimeError("ranks {} of {} ended without a "
                                       "result".format(
                                           dead or "all", world_size))
                continue
            if not ok:
                raise RuntimeError("rank {} of {} failed:\n{}".format(
                    rank, world_size, payload))
            out[rank] = payload
            done.add(rank)
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
                p.join()
    return out
