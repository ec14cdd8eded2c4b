"""Shared CLI plumbing: corpus path flags, the multihost process group,
and the storage, elastic and fleet flags.

Counterpart of the argument helpers of ``lddl_tpu/cli/common.py``.
``--multihost`` joins a ``torch.distributed`` gloo group
(``parallel.init_distributed(device="cpu")``): the host-side collectives
of the preprocess and the balancer are small int64 vectors, and gloo
serves a CPU-only preprocess cluster, as the reference's gloo CPU
collectives do. ``--storage-backend`` selects the storage backend as
the reference's does. The elastic flags parse as the reference's do and
run the lease-based work-stealing schedule (``preprocess/steal.py``);
``--elastic`` with ``--multihost`` is refused. ``--fleet-telemetry``
arms the fleet telemetry spools under ``<sink>/.telemetry/<holder>/``
(``observability/fleet.py``), as the reference's does.
"""

import argparse
import contextlib


def attach_corpus_args(parser):
    parser.add_argument("--wikipedia", default=None,
                        help="path to the wikipedia corpus (dir with "
                             "source/*.txt)")
    parser.add_argument("--books", default=None)
    parser.add_argument("--common-crawl", default=None)
    parser.add_argument("--open-webtext", default=None)


def corpus_paths_of(args):
    paths = {
        "wikipedia": args.wikipedia,
        "books": args.books,
        "common_crawl": args.common_crawl,
        "open_webtext": args.open_webtext,
    }
    if all(v is None for v in paths.values()):
        raise SystemExit(
            "give at least one corpus: --wikipedia/--books/--common-crawl/"
            "--open-webtext")
    return paths


def attach_multihost_arg(parser):
    parser.add_argument(
        "--multihost", action="store_true",
        help="join a torch.distributed gloo group and split the work "
             "across its ranks; without the flags below, the group comes "
             "from torchrun's environment (RANK, WORLD_SIZE, MASTER_ADDR, "
             "MASTER_PORT)")
    parser.add_argument(
        "--coordinator-address", default=None, metavar="HOST:PORT",
        help="rank 0's address when no launcher environment provides it")
    parser.add_argument("--num-processes", type=int, default=None,
                        help="world size (with --coordinator-address)")
    parser.add_argument("--process-id", type=int, default=None,
                        help="this host's rank (with --coordinator-address)")


def attach_elastic_args(parser):
    parser.add_argument(
        "--elastic", action="store_true",
        help="lease-based work-stealing multi-host mode: launch this SAME "
             "command on N independent hosts sharing --sink (no "
             "coordinator, no barriers); hosts claim scatter/gather units "
             "via lease files, any host may die mid-unit and be reclaimed "
             "by the survivors, output is byte-identical to a single-host "
             "run. Mutually exclusive with --multihost")
    parser.add_argument(
        "--lease-ttl", type=float, default=30.0, metavar="SECONDS",
        help="elastic lease TTL: a dead host's in-flight unit is stolen "
             "after at most this long; must exceed the renewal round-trip "
             "on your shared filesystem (renewals run at ttl/3)")
    parser.add_argument(
        "--elastic-host-id", default=None,
        help="stable holder id for lease files (default: auto "
             "hostname-pid-nonce)")
    parser.add_argument(
        "--scatter-units", type=int, default=None,
        help="fixed elastic scatter work-unit count (block slices). "
             "Default: ADAPTIVE — a few probe slices measure per-block "
             "wall, then a journaled plan sizes the remaining units "
             "toward a target wall of ~64x the measured lease overhead; "
             "give an explicit count to pin the classic fixed stride "
             "(the unit plan rides the resume fingerprint either way)")


def elastic_kwargs_of(args):
    if getattr(args, "elastic", False) and getattr(args, "multihost", False):
        raise SystemExit(
            "--elastic and --multihost are mutually exclusive: elastic "
            "hosts coordinate through lease files in the output dir, not "
            "torch.distributed")
    return {
        "elastic": getattr(args, "elastic", False),
        "lease_ttl": args.lease_ttl,
        "holder_id": args.elastic_host_id,
        "scatter_units": args.scatter_units,
    }


def attach_storage_arg(parser):
    parser.add_argument(
        "--storage-backend", choices=("local", "mock"), default=None,
        help="durable-IO/coordination backend (resilience/backend.py): "
             "'local' = the POSIX shared filesystem (default; atomic-"
             "rename leases, rename publishes), 'mock' = the in-process "
             "object store with CAS leases and multipart-upload-then-"
             "commit publishes (chaos/CI validation only). Equivalent to "
             "LDDL_TPU_STORAGE_BACKEND; inherited by worker processes")


def apply_storage_backend(args):
    """Pin the selected backend into the environment before any run
    kwargs are taken or workers spawn (spawned children inherit it)."""
    name = getattr(args, "storage_backend", None)
    if name:
        from ..resilience import backend as storage
        storage.set_backend(name)


def attach_fleet_arg(parser):
    parser.add_argument(
        "--fleet-telemetry", action="store_true",
        help="publish per-host telemetry spools (registry snapshots + "
             "unit/generation lifecycle event logs + traces) under "
             "<sink>/.telemetry/<holder>/ for cross-host aggregation; "
             "inspect with `python -m lddl_tpu_torch.tools.pipeline_status "
             "<sink>` (equivalent to LDDL_TPU_FLEET_DIR=<sink>)")


def arm_fleet_if_requested(args, sink):
    """Arm fleet telemetry into the run's output dir when requested. The
    elastic holder id doubles as the spool name, so lease events and
    spool dirs name the same host; when an elastic run got no
    ``--elastic-host-id``, ONE auto-generated lease holder is pinned into
    ``args`` here, so the spool and the lease files still share a name
    (``configure()`` would otherwise pin a hostname-pid default that the
    runner's later ``adopt_holder()`` could no longer override)."""
    if not getattr(args, "fleet_telemetry", False):
        return
    holder = getattr(args, "elastic_host_id", None)
    if holder is None and getattr(args, "elastic", False):
        from ..resilience import leases
        holder = leases.default_holder()
        args.elastic_host_id = holder
    from ..observability import fleet
    fleet.configure(sink, holder_id=holder,
                    ttl=getattr(args, "lease_ttl", None))


@contextlib.contextmanager
def communicator_of(args):
    """The run's communicator: a gloo group's ``TorchCommunicator`` under
    ``--multihost`` (the group is destroyed on exit), else a
    ``LocalCommunicator``. Only ``--multihost`` imports torch: a
    one-host CLI process (and the workers it spawns) loads none, and so
    never maps the CUDA driver."""
    if not getattr(args, "multihost", False):
        from ..utils.comm import LocalCommunicator
        yield LocalCommunicator()
        return
    from ..parallel.distributed import get_communicator, init_distributed
    wiring = (args.coordinator_address, args.num_processes, args.process_id)
    if any(v is not None for v in wiring) and None in wiring:
        raise SystemExit(
            "--coordinator-address, --num-processes and --process-id must "
            "be given together (or none, for torchrun's environment)")
    kwargs = {}
    if args.coordinator_address is not None:
        kwargs = dict(init_method="tcp://" + args.coordinator_address,
                      world_size=args.num_processes, rank=args.process_id)
    import torch.distributed as dist
    init_distributed(device="cpu", **kwargs)
    try:
        yield get_communicator()
    finally:
        dist.destroy_process_group()


def make_parser(description):
    return argparse.ArgumentParser(
        description=description,
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
