"""CLI: BERT pretraining preprocessor.

Counterpart of ``lddl_tpu/cli/preprocess_bert_pretrain.py``; run as
``python -m lddl_tpu_torch.cli.preprocess_bert_pretrain --wikipedia
<corpus> --sink <out> --vocab-file <vocab.txt> ...`` (or ``--tokenizer
<dir>``, a local ``save_pretrained`` tokenizer directory). ``--engine``
picks the static-masking engine (``numpy``: the native Philox replay, the
reference's shard bytes; ``torch``: the torch maskers on ``--device``,
the card unless ``cpu``). ``--tokenizer-engine`` picks the tokenizer
engine: ``native`` (the C++ one-pass kernel), ``hf`` (the Python splitter
plus the fast tokenizer's backend; needs the ``tokenizers`` package) or
``auto`` (native when the tokenizer's semantics are the native engine's,
else hf). ``--elastic`` runs the lease-based
work-stealing schedule: launch the same command on several hosts sharing
``--sink`` (each with its own ``--elastic-host-id``); the shards equal a
one-host static run's. ``--fleet-telemetry`` publishes per-host
telemetry spools under ``<sink>/.telemetry/`` (read them with ``python -m
lddl_tpu_torch.tools.pipeline_status <sink>``).
"""

from ..preprocess import BertPretrainConfig, get_tokenizer, run_bert_preprocess
from ..utils.args import attach_bool_arg
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
    parser.add_argument("--sink", "--outdir", dest="sink", required=True,
                        help="output directory for the parquet shards")
    parser.add_argument("--vocab-file", default=None)
    parser.add_argument("--tokenizer", default=None,
                        help="local tokenizer directory (alternative to "
                             "--vocab-file; nothing is downloaded)")
    parser.add_argument("--target-seq-length", type=int, default=128)
    parser.add_argument("--short-seq-prob", type=float, default=0.1)
    attach_bool_arg(parser, "masking", default=False,
                    help_str="static masking (default: dynamic at load time)")
    parser.add_argument("--masked-lm-ratio", type=float, default=0.15)
    parser.add_argument("--max-predictions-per-seq", type=int, default=None)
    attach_bool_arg(parser, "whole-word-masking", default=False)
    parser.add_argument("--duplicate-factor", type=int, default=5)
    parser.add_argument("--sample-ratio", type=float, default=0.9)
    parser.add_argument("--seed", type=int, default=12345)
    parser.add_argument("--bin-size", type=int, default=None)
    parser.add_argument("--pack-seq-length", type=int, default=None,
                        help="OFFLINE sequence packing: FFD-pack each "
                             "bucket's instances into fixed-budget "
                             "schema-v2 rows (exclusive with --bin-size; "
                             "requires --schema-version 2)")
    parser.add_argument("--pack-max-per-row", type=int, default=8,
                        help="samples-per-row cap of the offline packer")
    parser.add_argument("--num-blocks", type=int, default=64)
    parser.add_argument("--spool-groups", type=int, default=None,
                        help="coarse radix width of the shuffle spool "
                             "(default min(blocks, max(64, blocks/8)))")
    parser.add_argument("--local-workers", type=int, default=0,
                        help="process-pool size per host for bucket "
                             "processing (0 = one per usable CPU core)")
    parser.add_argument("--engine", choices=("numpy", "torch"),
                        default="numpy",
                        help="static-masking engine (torch = the torch "
                             "maskers on --device)")
    parser.add_argument("--device", default=None,
                        help="device of --engine torch (default: the card)")
    parser.add_argument("--tokenizer-engine",
                        choices=("auto", "hf", "native"), default="auto",
                        help="sentence-split + tokenize backend (native = "
                             "the C++ one-pass kernel)")
    parser.add_argument("--splitter", choices=("rules", "learned"),
                        default="rules",
                        help="sentence splitter: rules = static rules; "
                             "learned = corpus-trained punkt parameters "
                             "(needs nltk to train)")
    parser.add_argument("--output-format", choices=("parquet", "txt"),
                        default="parquet")
    parser.add_argument("--schema-version", type=int, choices=(1, 2),
                        default=2,
                        help="parquet shard schema: 2 adds the token-id "
                             "list columns; 1 = text-only shards")
    attach_bool_arg(parser, "resume", default=False,
                    help_str="continue a crashed/failed run from its unit "
                             "ledger (skips completed spool groups)")
    attach_bool_arg(parser, "global-shuffle", default=True,
                    help_str="two-pass global document shuffle")
    return parser


def main(args=None):
    args = args if args is not None else attach_args().parse_args()
    if args.vocab_file is None and args.tokenizer is None:
        raise SystemExit("need --vocab-file or --tokenizer")
    apply_storage_backend(args)
    arm_fleet_if_requested(args, args.sink)
    elastic_kwargs = elastic_kwargs_of(args)
    config = BertPretrainConfig(
        max_seq_length=args.target_seq_length,
        short_seq_prob=args.short_seq_prob,
        masking=args.masking,
        masked_lm_ratio=args.masked_lm_ratio,
        max_predictions_per_seq=args.max_predictions_per_seq,
        whole_word_masking=args.whole_word_masking,
        duplicate_factor=args.duplicate_factor,
        engine=args.engine,
        tokenizer_engine=args.tokenizer_engine,
        splitter=args.splitter,
        schema_version=args.schema_version,
        device=args.device,
    )
    from ..utils.cpus import usable_cpu_count
    with communicator_of(args) as comm:
        run_bert_preprocess(
            corpus_paths_of(args),
            args.sink,
            get_tokenizer(vocab_file=args.vocab_file,
                          pretrained_model_name=args.tokenizer),
            config=config,
            num_workers=args.local_workers or usable_cpu_count(),
            num_blocks=args.num_blocks,
            sample_ratio=args.sample_ratio,
            seed=args.seed,
            bin_size=args.bin_size,
            pack_seq_length=args.pack_seq_length,
            pack_max_per_row=args.pack_max_per_row,
            global_shuffle=args.global_shuffle,
            output_format=args.output_format,
            comm=comm,
            log=print,
            spool_groups=args.spool_groups,
            resume=args.resume,
            **elastic_kwargs,
        )


if __name__ == "__main__":
    main()
