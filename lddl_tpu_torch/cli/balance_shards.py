"""CLI: balance preprocessor output into equal-count shards.

Counterpart of ``lddl_tpu/cli/balance_shards.py``; run as
``python -m lddl_tpu_torch.cli.balance_shards --indir <pre> --outdir
<bal> --num-shards N``.
"""

from ..balance import balance_shards
from .common import (apply_storage_backend, arm_fleet_if_requested,
                     attach_fleet_arg, attach_multihost_arg,
                     attach_storage_arg, communicator_of, make_parser)


def attach_args(parser=None):
    parser = parser or make_parser(__doc__)
    parser.add_argument("--indir", required=True,
                        help="preprocessor output directory")
    parser.add_argument("--outdir", required=True)
    parser.add_argument("--num-shards", type=int, required=True,
                        help="shard count; choose a multiple of "
                             "(num data-parallel groups x loader workers)")
    attach_multihost_arg(parser)
    attach_storage_arg(parser)
    attach_fleet_arg(parser)
    return parser


def main(args=None):
    args = args if args is not None else attach_args().parse_args()
    apply_storage_backend(args)
    arm_fleet_if_requested(args, args.outdir)
    with communicator_of(args) as comm:
        counts = balance_shards(args.indir, args.outdir, args.num_shards,
                                comm=comm, log=print)
    print("balanced {} shards, {} samples total".format(
        len(counts), sum(counts.values())))


if __name__ == "__main__":
    main()
