"""Shared CLI plumbing: corpus path flags and the multihost process group.

Counterpart of the argument helpers of ``lddl_tpu/cli/common.py`` that
the preprocess and balance CLIs need. Storage, fleet and elastic flags
are not offered. ``--multihost`` joins a ``torch.distributed`` gloo group
(``parallel.init_distributed(device="cpu")``): the host-side collectives
of the preprocess and the balancer are small int64 vectors, and gloo
serves a CPU-only preprocess cluster, as the reference's gloo CPU
collectives do.
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


@contextlib.contextmanager
def communicator_of(args):
    """The run's communicator: a gloo group's ``TorchCommunicator`` under
    ``--multihost`` (the group is destroyed on exit), else a
    ``LocalCommunicator``."""
    from ..parallel.distributed import get_communicator, init_distributed
    if not getattr(args, "multihost", False):
        yield get_communicator()
        return
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
