"""CLI: BART pretraining preprocessor.

Counterpart of ``lddl_tpu/cli/preprocess_bart_pretrain.py``; run as
``python -m lddl_tpu_torch.cli.preprocess_bart_pretrain --wikipedia
<corpus> --sink <out> [--vocab-file <vocab.txt>] ...``. With
``--vocab-file`` (or ``--tokenizer``, a local directory holding
``vocab.txt``) the shards are schema v2, tokenized by the native engine;
without, text-only schema v1. ``--elastic`` runs the lease-based
work-stealing schedule, as the BERT CLI's does; ``--fleet-telemetry``
publishes per-host telemetry spools under ``<sink>/.telemetry/``.
"""

from ..preprocess import BartPretrainConfig, run_bart_preprocess
from ..utils.args import attach_bool_arg
from ..utils.cpus import usable_cpu_count
from .common import (apply_storage_backend, arm_fleet_if_requested,
                     attach_corpus_args, attach_elastic_args,
                     attach_fleet_arg, attach_multihost_arg,
                     attach_storage_arg, communicator_of,
                     corpus_paths_of, elastic_kwargs_of, make_parser)


def attach_args(parser=None):
    parser = parser or make_parser(__doc__)
    attach_corpus_args(parser)
    attach_multihost_arg(parser)
    attach_elastic_args(parser)
    attach_fleet_arg(parser)
    attach_storage_arg(parser)
    parser.add_argument("--sink", "--outdir", dest="sink", required=True)
    parser.add_argument("--vocab-file", default=None,
                        help="emit schema-v2 token-id columns "
                             "(sentence_ids/sentence_lens) tokenized with "
                             "this vocab; the loader must use the same "
                             "vocab (default: text-only v1 shards)")
    parser.add_argument("--tokenizer", default=None,
                        help="a local directory holding vocab.txt "
                             "(alternative to --vocab-file) for schema-v2 "
                             "shards")
    parser.add_argument("--target-seq-length", type=int, default=128)
    parser.add_argument("--short-seq-prob", type=float, default=0.1)
    parser.add_argument("--sample-ratio", type=float, default=0.9)
    parser.add_argument("--seed", type=int, default=12345)
    parser.add_argument("--num-blocks", type=int, default=64)
    parser.add_argument("--spool-groups", type=int, default=None,
                        help="coarse radix width of the shuffle spool")
    parser.add_argument("--local-workers", type=int, default=0,
                        help="process-pool size per host "
                             "(0 = one per CPU core)")
    parser.add_argument("--splitter", choices=("rules", "learned"),
                        default="rules",
                        help="sentence splitter (see preprocess_bert_"
                             "pretrain --splitter)")
    parser.add_argument("--output-format", choices=("parquet", "txt"),
                        default="parquet")
    attach_bool_arg(parser, "resume", default=False,
                    help_str="continue a crashed/failed run from its unit "
                             "ledger (skips completed spool groups)")
    attach_bool_arg(parser, "global-shuffle", default=True)
    return parser


def main(args=None):
    args = args if args is not None else attach_args().parse_args()
    apply_storage_backend(args)
    arm_fleet_if_requested(args, args.sink)
    elastic_kwargs = elastic_kwargs_of(args)
    tokenizer = None
    if args.vocab_file or args.tokenizer:
        from ..preprocess import get_tokenizer
        tokenizer = get_tokenizer(vocab_file=args.vocab_file,
                                  pretrained_model_name=args.tokenizer)
    with communicator_of(args) as comm:
        run_bart_preprocess(
            corpus_paths_of(args),
            args.sink,
            config=BartPretrainConfig(
                target_seq_length=args.target_seq_length,
                short_seq_prob=args.short_seq_prob,
                splitter=args.splitter,
            ),
            num_workers=args.local_workers or usable_cpu_count(),
            num_blocks=args.num_blocks,
            sample_ratio=args.sample_ratio,
            seed=args.seed,
            global_shuffle=args.global_shuffle,
            output_format=args.output_format,
            comm=comm,
            log=print,
            spool_groups=args.spool_groups,
            resume=args.resume,
            tokenizer=tokenizer,
            **elastic_kwargs,
        )


if __name__ == "__main__":
    main()
