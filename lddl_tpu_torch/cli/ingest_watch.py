"""CLI: streaming ingestion service: watch a landing directory and
incrementally preprocess + delta-balance new documents into a growing,
generation-structured shard directory (see lddl_tpu_torch/ingest/).

Counterpart of ``lddl_tpu/cli/ingest_watch.py``; run as ``python -m
lddl_tpu_torch.cli.ingest_watch --landing <dir> --sink <root>
--vocab-file <vocab.txt> [--once] ...`` (or ``--tokenizer <dir>``, with
``--tokenizer-engine auto|hf|native`` as the BERT CLI's). ``--once`` diffs and ingests a
single generation; the default is a polling watch loop. Safe to kill at
any point and re-run: an in-flight generation resumes from its intake
record, and the journal commit is atomic. ``--elastic`` runs each
round's preprocess on the lease-based work-stealing schedule, and
``--join-pending`` runs a helper host that joins the in-flight
generation's elastic preprocess. ``--fleet-telemetry`` publishes the
service's telemetry spool under ``<sink>/.telemetry/``, and
``--autoscale`` (with ``--elastic`` and ``--fleet-telemetry``) runs a
control thread that reads the fleet aggregate and spawns or retires
local ``--join-pending`` helper processes to hold ``--backlog-slo-docs``.
"""

from ..preprocess import BertPretrainConfig, get_tokenizer
from ..utils.args import attach_bool_arg
from .common import (apply_storage_backend, arm_fleet_if_requested,
                     attach_elastic_args, attach_fleet_arg,
                     attach_storage_arg, elastic_kwargs_of, make_parser)


def attach_args(parser=None):
    parser = parser or make_parser(__doc__)
    parser.add_argument("--landing", required=True,
                        help="landing directory of downloader-contract "
                             ".txt files (or a dir containing source/); "
                             "scanned every round and diffed against the "
                             "journal by document content hash")
    parser.add_argument("--sink", "--outdir", dest="sink", required=True,
                        help="dataset root: generation 0 lands here as "
                             "classic balanced shards, later generations "
                             "under gen-<NNNN>/; service state lives in "
                             "<sink>/.ingest/")
    parser.add_argument("--vocab-file", default=None)
    parser.add_argument("--tokenizer", default=None,
                        help="a local directory holding vocab.txt "
                             "(alternative to --vocab-file)")
    parser.add_argument("--num-shards", type=int, default=8,
                        help="generation-0 shard count per bin — this "
                             "fixes the per-shard row budget every later "
                             "generation appends at")
    parser.add_argument("--target-seq-length", type=int, default=128)
    parser.add_argument("--short-seq-prob", type=float, default=0.1)
    attach_bool_arg(parser, "masking", default=False,
                    help_str="static masking (default: dynamic at load "
                             "time)")
    parser.add_argument("--masked-lm-ratio", type=float, default=0.15)
    parser.add_argument("--duplicate-factor", type=int, default=5)
    parser.add_argument("--seed", type=int, default=12345)
    parser.add_argument("--bin-size", type=int, default=None)
    parser.add_argument("--pack-seq-length", type=int, default=None,
                        help="grow an OFFLINE-PACKED corpus: every "
                             "delta's instances are FFD-packed into "
                             "fixed-budget schema-v2 rows (exclusive "
                             "with --bin-size; the shape rides the "
                             "journal fingerprint, so drift refuses)")
    parser.add_argument("--pack-max-per-row", type=int, default=8,
                        help="samples-per-row cap of the offline packer")
    parser.add_argument("--num-blocks", type=int, default=None,
                        help="blocks per delta preprocess (default: "
                             "scaled to the delta's document count)")
    parser.add_argument("--local-workers", type=int, default=1,
                        help="process-pool size for the delta preprocess")
    parser.add_argument("--schema-version", type=int, choices=(1, 2),
                        default=2)
    parser.add_argument("--tokenizer-engine",
                        choices=("auto", "hf", "native"), default="auto",
                        help="sentence-split + tokenize backend (native = "
                             "the C++ one-pass kernel; it enters the "
                             "journal fingerprint)")
    attach_bool_arg(parser, "once", default=False,
                    help_str="diff-and-ingest a single round, then exit "
                             "(default: poll forever)")
    parser.add_argument("--interval", type=float, default=30.0,
                        metavar="SECONDS",
                        help="watch-loop poll interval")
    parser.add_argument("--max-rounds", type=int, default=0,
                        help="stop the watch loop after this many rounds "
                             "(0 = forever)")
    attach_bool_arg(parser, "flush-tail", default=False,
                    help_str="fold the carryover remainder into the "
                             "prior tail instead of deferring it; "
                             "touches prior shards, so only for "
                             "maintenance windows — not while a loader "
                             "streams the directory mid-epoch")
    attach_bool_arg(parser, "autoscale", default=False,
                    help_str="telemetry-driven autoscaling: a control "
                             "thread reads the fleet aggregate every "
                             "half interval and spawns/retires local "
                             "helper processes (--join-pending mode) to "
                             "hold --backlog-slo-docs; requires "
                             "--elastic and --fleet-telemetry")
    parser.add_argument("--backlog-slo-docs", type=int, default=512,
                        help="autoscale SLO: spawn a helper while the "
                             "fleet's ingest backlog gauge is at/above "
                             "this many documents (or the service is "
                             "wedged)")
    parser.add_argument("--max-helpers", type=int, default=2,
                        help="autoscale ceiling on concurrently running "
                             "helper processes")
    parser.add_argument("--drain-rounds", type=int, default=2,
                        help="consecutive calm control rounds (no "
                             "backlog, no pending work) before one "
                             "helper is retired")
    attach_bool_arg(parser, "join-pending", default=False,
                    help_str="helper mode (what --autoscale spawns): "
                             "join the in-flight generation's elastic "
                             "preprocess from its frozen intake record, "
                             "then poll for the next one; never scans "
                             "the landing dir or commits the journal")
    attach_elastic_args(parser)
    attach_fleet_arg(parser)
    attach_storage_arg(parser)
    return parser


def _helper_argv(args):
    """The command line ``--autoscale`` spawns: this same CLI in
    ``--join-pending`` mode, carrying every processor-config flag (the
    helper recomputes the intake fingerprint and refuses on drift) but
    none of the landing-scan knobs (frozen in the intake record)."""
    import sys
    argv = [sys.executable, "-m", "lddl_tpu_torch.cli.ingest_watch",
            "--landing", args.landing, "--sink", args.sink,
            "--join-pending", "--elastic",
            "--local-workers", str(args.local_workers),
            "--lease-ttl", str(args.lease_ttl),
            "--interval", str(args.interval),
            "--num-shards", str(args.num_shards),
            "--target-seq-length", str(args.target_seq_length),
            "--short-seq-prob", str(args.short_seq_prob),
            "--masked-lm-ratio", str(args.masked_lm_ratio),
            "--duplicate-factor", str(args.duplicate_factor),
            "--seed", str(args.seed),
            "--schema-version", str(args.schema_version),
            "--tokenizer-engine", args.tokenizer_engine]
    if args.vocab_file:
        argv += ["--vocab-file", args.vocab_file]
    if args.tokenizer:
        argv += ["--tokenizer", args.tokenizer]
    if args.masking:
        argv += ["--masking"]
    if args.scatter_units is not None:
        argv += ["--scatter-units", str(args.scatter_units)]
    if args.fleet_telemetry:
        argv += ["--fleet-telemetry"]
    return argv


def main(args=None):
    args = args if args is not None else attach_args().parse_args()
    if args.vocab_file is None and args.tokenizer is None:
        raise SystemExit("need --vocab-file or --tokenizer")
    # Pin the storage backend into the env first (workers and helper
    # subprocesses inherit it), then arm fleet BEFORE the elastic kwargs
    # are taken (see arm_fleet_if_requested).
    apply_storage_backend(args)
    arm_fleet_if_requested(args, args.sink)
    elastic_kwargs = elastic_kwargs_of(args)
    tokenizer = get_tokenizer(vocab_file=args.vocab_file,
                              pretrained_model_name=args.tokenizer)
    config = BertPretrainConfig(
        max_seq_length=args.target_seq_length,
        short_seq_prob=args.short_seq_prob,
        masking=args.masking,
        masked_lm_ratio=args.masked_lm_ratio,
        duplicate_factor=args.duplicate_factor,
        tokenizer_engine=args.tokenizer_engine,
        schema_version=args.schema_version,
    )
    from ..ingest import ingest_once, join_pending_generation, watch
    if args.join_pending:
        # Helper mode: poll the journal for an in-flight generation and
        # join its elastic claim loop. Retirement is a plain SIGTERM from
        # the autoscaler, converted to a normal exit so the atexit hook
        # closes the telemetry spool (pipeline_status then reads a clean
        # shutdown, not a stalled host). A helper that dies mid-unit
        # anyway just stops renewing its leases and the survivors steal.
        import signal
        import time

        def _retired(signum, frame):
            raise SystemExit(0)

        signal.signal(signal.SIGTERM, _retired)
        while True:
            report = join_pending_generation(
                args.sink, tokenizer, config=config,
                num_workers=args.local_workers,
                lease_ttl=args.lease_ttl,
                holder_id=args.elastic_host_id,
                scatter_units=args.scatter_units,
                log=print)
            print("ingest helper: {}".format(report))
            if args.once:
                return
            time.sleep(max(1.0, args.interval / 3.0))
    kwargs = dict(
        config=config,
        num_shards=args.num_shards,
        bin_size=args.bin_size,
        seed=args.seed,
        num_blocks=args.num_blocks,
        num_workers=args.local_workers,
        flush_tail=args.flush_tail,
        pack_seq_length=args.pack_seq_length,
        pack_max_per_row=args.pack_max_per_row,
        **elastic_kwargs,
    )
    if args.autoscale:
        if args.once:
            raise SystemExit("--autoscale requires the watch loop (it "
                             "decides across rounds); drop --once")
        if not args.elastic:
            raise SystemExit("--autoscale needs --elastic: helpers join "
                             "the preprocess through the lease claim loop")
        if not args.fleet_telemetry:
            raise SystemExit("--autoscale needs --fleet-telemetry: scale "
                             "decisions read the fleet aggregate")
        _watch_with_autoscaler(args, tokenizer, kwargs)
        return
    if args.once:
        report = ingest_once(args.sink, tokenizer, landing=args.landing,
                             log=print, **kwargs)
        print("ingest report: {}".format(report))
        return
    watch(args.sink, tokenizer, args.landing, interval_s=args.interval,
          max_rounds=args.max_rounds, log=print, **kwargs)



def _watch_with_autoscaler(args, tokenizer, kwargs):
    """The watch loop with the autoscaler's control thread beside it;
    every helper is retired (SIGTERM, then SIGKILL after 30 s) before
    this returns."""
    import subprocess
    import threading

    from ..ingest import watch
    from ..observability.autoscale import Autoscaler

    def spawn():
        return subprocess.Popen(_helper_argv(args))

    def retire(proc):
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=10)

    scaler = Autoscaler(args.sink, spawn, retire,
                        backlog_slo_docs=args.backlog_slo_docs,
                        max_helpers=args.max_helpers,
                        drain_rounds=args.drain_rounds,
                        stall_ttl=args.lease_ttl, log=print)
    stop = threading.Event()

    def control_loop():
        # Half the watch interval, so a backlog spike seen at scan time
        # scales up while the round's preprocess still runs, when a
        # helper is actually useful.
        while not stop.wait(max(1.0, args.interval / 2.0)):
            try:
                scaler.step()
            except Exception as e:  # noqa: BLE001 - keep controlling
                print("autoscale: control round failed ({}: {})".format(
                    type(e).__name__, e))

    thread = threading.Thread(target=control_loop, name="autoscale",
                              daemon=True)
    thread.start()
    try:
        watch(args.sink, tokenizer, args.landing, interval_s=args.interval,
              max_rounds=args.max_rounds, log=print, **kwargs)
    finally:
        stop.set()
        thread.join(timeout=5.0)
        scaler.shutdown()


if __name__ == "__main__":
    main()
