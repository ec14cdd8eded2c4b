"""CLI: (re)generate the .num_samples.json cache for a shard directory.

Counterpart of ``lddl_tpu/cli/generate_num_samples_cache.py``; run as
``python -m lddl_tpu_torch.cli.generate_num_samples_cache --path <dir>``.
"""

from ..balance import generate_num_samples_cache
from .common import attach_multihost_arg, communicator_of, make_parser


def attach_args(parser=None):
    parser = parser or make_parser(__doc__)
    parser.add_argument("--path", required=True)
    attach_multihost_arg(parser)
    return parser


def main(args=None):
    args = args if args is not None else attach_args().parse_args()
    with communicator_of(args) as comm:
        counts = generate_num_samples_cache(args.path, comm=comm)
    print("cached counts for {} shards".format(len(counts)))


if __name__ == "__main__":
    main()
