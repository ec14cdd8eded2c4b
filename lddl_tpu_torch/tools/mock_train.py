"""Mock training loop: the loader's harness and correctness probe.

Counterpart of ``benchmarks/mock_train.py``: throughput and latency
meters, per-iteration sequence-length and padded-zero stats, batch-shape
asserts, ``--debug`` raw-sample inspection with the de-masking round
trip, per-rank ``lens_<dp_rank>.npz`` dumps for
``lddl_tpu_torch.tools.validate_seqlen``, and ``--with-model tiny|base``,
which runs a real BERT (binned or packed) or BART train step on every
batch, so the harness measures the step end to end, not the loader
alone. Run from the repository root::

    python -m lddl_tpu_torch.tools.mock_train --path <balanced dir> \\
        --vocab-file <vocab.txt> [--with-model base]

One process runs one dp rank's loader exactly as it would run in the full
job (``--dp-rank``/``--num-dp-groups``).

Without ``--with-model`` nothing touches a device: the harness imports no
torch, so a model-less run opens no CUDA context. With it, ``--device``
names the device, the card by default (``device.resolve_device``, which
raises when no card is present); ``--device cpu`` runs on the CPU. The
train step is the unsharded ``models.make_train_step`` with one device
and no ``--mesh``: the reference's mesh of one device computes the same
step, and the sharded step at world 1 costs several times the unsharded
one, which would misstate the step time printed. With ``--mesh`` (e.g.
``dp=2,tp=2``), or under a process group of more than one rank, it is
``parallel.make_mesh`` + ``models.create_train_state`` +
``models.make_sharded_train_step``; a process outside a process group
then joins a world of one on localhost.

``run(args)`` prints what the reference prints and returns a summary
dict (the loss of every step among it) for programs that drive the
harness.
"""

import argparse
import collections
import os
import time

import numpy as np


class AverageMeter:

    def __init__(self, warmup=2, keep=False):
        self.warmup = warmup
        self.keep = keep
        self.reset()

    def reset(self):
        self.val = 0
        self.avg = 0
        self.max = float("-inf")
        self.min = float("inf")
        self.sum = 0
        self.count = 0
        self.iters = 0
        self.vals = []

    def update(self, val, n=1):
        self.iters += 1
        self.val = val
        if self.iters > self.warmup:
            self.sum += val * n
            self.max = max(val, self.max)
            self.min = min(val, self.min)
            self.count += n
            self.avg = self.sum / self.count
            if self.keep:
                self.vals.append(val)


class Histogram:

    def __init__(self):
        self.counts = {}

    def update(self, key, n=1):
        self.counts[key] = self.counts.get(key, 0) + n


def attach_args():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--path", required=True, help="balanced shard dir")
    p.add_argument("--vocab-file", required=True)
    p.add_argument("--family", choices=("bert", "bart"), default="bert",
                   help="which loader/model contract to drive")
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--start-epoch", type=int, default=0)
    p.add_argument("--num-workers", type=int, default=1)
    p.add_argument("--worker-mode", choices=("thread", "process"),
                   default="thread")
    p.add_argument("--log-freq", type=int, default=100)
    p.add_argument("--seed", type=int, default=12345)
    p.add_argument("--dp-rank", type=int, default=0)
    p.add_argument("--num-dp-groups", type=int, default=1)
    p.add_argument("--fixed-seq-lengths", type=int, nargs="*", default=None)
    p.add_argument("--pack-seq-length", type=int, default=None,
                   help="sequence packing row budget: on an UNPACKED dir "
                        "this enables the greedy load-time packer (needs "
                        "--pack-rows); offline-packed dirs are detected "
                        "automatically and this only validates the budget")
    p.add_argument("--pack-rows", type=int, default=None,
                   help="packed rows per batch (load-time packer: "
                        "required with --pack-seq-length; offline-packed "
                        "dirs default to --batch-size)")
    p.add_argument("--pack-max-per-row", type=int, default=8)
    p.add_argument("--seq-len-dir", default=None,
                   help="dump lens_<dp_rank>.npz here for validate_seqlen")
    p.add_argument("--debug", action="store_true")
    p.add_argument("--with-model", choices=("tiny", "base"), default=None,
                   help="run a real train step per batch")
    p.add_argument("--mesh", default=None,
                   help="axes for --with-model, e.g. dp=2,tp=2,sp=2 "
                        "(default: one device, the unsharded step)")
    p.add_argument("--attention-impl",
                   choices=("auto", "dense", "ring", "flash"),
                   default="auto", help="for --with-model (auto = measured "
                   "per-seq-length dense/flash selection)")
    p.add_argument("--remat", action="store_true",
                   help="rematerialize layers (--with-model)")
    p.add_argument("--on-corrupt", choices=("fail", "quarantine"),
                   default=None,
                   help="startup shard-integrity policy against the "
                        ".manifest.json: fail = refuse to start naming the "
                        "corrupt shard(s); quarantine = exclude them "
                        "loudly and run on the survivors (default: "
                        "$LDDL_TPU_ON_CORRUPT, then fail)")
    p.add_argument("--storage-backend", choices=("local", "mock"),
                   default=None,
                   help="route shard I/O through this StorageBackend "
                        "(default: inherit LDDL_TPU_STORAGE_BACKEND)")
    p.add_argument("--backend-latency-ms", type=float, default=None,
                   help="inject this per-operation latency into the mock "
                        "object store (LDDL_TPU_MOCK_LATENCY_MS)")
    p.add_argument("--prefetch-shards", type=int, default=None,
                   help="loader shard read-ahead depth "
                        "(LDDL_TPU_LOADER_PREFETCH_SHARDS; 0 disables "
                        "the shard I/O pipeline)")
    p.add_argument("--cache-bytes", type=int, default=None,
                   help="loader shard-cache byte budget "
                        "(LDDL_TPU_LOADER_CACHE_BYTES; 0 disables "
                        "caching)")
    p.add_argument("--metrics-dir", default=None,
                   help="arm lddl_tpu_torch.observability and write metric "
                        "snapshots (.jsonl), a Prometheus textfile, "
                        "Chrome-trace JSONL (Perfetto) and an end-of-run "
                        "summary-*.json here; also prints the telemetry "
                        "report (padding efficiency, resilience activity) "
                        "after the run")
    p.add_argument("--device", default=None,
                   help="device of --with-model's step (default: the "
                        "card, which must be present; 'cpu' runs there)")
    return p


def _debug_print(loader, tokenizer):
    from ..utils.fs import deserialize_np_array

    def toks(v):
        # v1 raw samples carry space-joined token strings; schema-v2
        # carries int32 id arrays: render both as token lists.
        if isinstance(v, str):
            return v.split()
        return tokenizer.convert_ids_to_tokens([int(i) for i in v])

    for i, batch in enumerate(loader):
        for sample in batch[:2]:
            if len(sample) == 5:
                a, b, rn, pos_b, labels = sample
                seq = ["[CLS]"] + toks(a) + ["[SEP]"] + toks(b) + ["[SEP]"]
                pos = (deserialize_np_array(pos_b)
                       if isinstance(pos_b, (bytes, bytearray)) else pos_b)
                labs = toks(labels)
                print("is_random_next:", rn)
                print("masked:", " ".join(seq))
                for p, lab in zip(pos, labs):
                    seq[int(p)] = lab
                print("demasked:", " ".join(seq))
            else:
                print("is_random_next:", sample[2])
                print("[CLS] {} [SEP] {} [SEP]".format(
                    " ".join(toks(sample[0])), " ".join(toks(sample[1]))))
        if i >= 2:
            return


def _telemetry_report(obs):
    """End-of-run telemetry: headline numbers on stdout + summary json,
    prom textfile and trace flush in the metrics dir."""
    s = obs.summary()
    print("telemetry: padding efficiency {} ({} real tokens / {} slots)"
          .format("{:.4f}".format(s["padding_efficiency"])
                  if s["padding_efficiency"] is not None else "n/a",
                  s["real_tokens"], s["padded_slots"]))
    print("telemetry: resilience activity: {} retries, {} faults "
          "injected, {} worker restarts, {} quarantined shards".format(
              s["retries"], s["faults_injected"], s["worker_restarts"],
              s["quarantined_shards"]))
    reg = obs.registry()
    hist = reg.get("loader_batch_latency_seconds")
    if hist is not None:
        st = hist.stats()
        if st:
            print("telemetry: batch latency mean {:.2f} ms over {} "
                  "batches (max {:.2f} ms)".format(
                      1e3 * st["sum"] / max(st["count"], 1), st["count"],
                      1e3 * st["max"]))
    bins = reg.get("loader_bin_choice_total")
    if bins is not None:
        print("telemetry: bin choices {}".format(bins.snapshot()["values"]))
    # Critical-path attribution: where did the batch wall go, and is the
    # step input-bound? (snapshot() also publishes the verdict gauges so
    # the fleet rollup carries them.)
    report = obs.attribution.snapshot()
    if report is not None:
        print(obs.attribution.format_report(report, indent="telemetry: "))
    obs.export_prom()
    obs.export_jsonl()
    path = obs.write_summary()
    if path:
        print("telemetry: wrote {}".format(path))


def _warm_parquet_reader():
    """The first pyarrow.parquet use in a process pays for lazy imports
    and its IO thread pool's spin-up; pay it on a throwaway in-memory
    table before the timed loop, so the 'sustained' meter measures the
    loader, not pyarrow's one-time start."""
    import io
    import pyarrow as pa
    import pyarrow.parquet as pq
    buf = io.BytesIO()   # in memory: no file is published
    pq.write_table(pa.table({"x": [0]}), buf)  # lddl: disable=atomic-publish
    buf.seek(0)
    pq.read_table(buf)


def _queue_cost(loader):
    """(bytes, batches) shipped over process-worker queues, summed over
    the wrapped DataLoaders (Binned holds one per bin; packed mode wraps
    an inner raw-sample loader). Zero in thread mode."""
    dls = [loader]
    if getattr(loader, "_dataloaders", None) is not None:
        dls = loader._dataloaders
    elif getattr(loader, "_inner", None) is not None:
        dls = [loader._inner]
    return (sum(getattr(d, "queue_bytes", 0) for d in dls),
            sum(getattr(d, "queue_batches", 0) for d in dls))


class _HostLens:
    """The loader, re-iterable as it is, noting each batch's per-row
    lengths (the attention mask's sums, on the host) before the batch
    goes on to ``prefetch_to_device``. The prefetcher keeps the order, so
    the consumer takes the lengths of the batch it was handed from the
    front of ``lens``: no device copy is summed, which would sync the
    device before every step, and nothing extra is copied to it."""

    def __init__(self, loader):
        self._loader = loader
        self.lens = collections.deque()

    def __len__(self):
        return len(self._loader)

    def __iter__(self):
        self.lens.clear()
        it = iter(self._loader)
        try:
            for batch in it:
                self.lens.append(batch["attention_mask"].sum(axis=1))
                yield batch
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()


def _join_world(device):
    """This process's process group: the launcher's (torchrun's env://)
    when it set ``WORLD_SIZE``, else a world of one on localhost."""
    import socket
    from ..parallel import init_distributed
    if os.environ.get("WORLD_SIZE"):
        return init_distributed(device=device)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    return init_distributed(device=device,
                            init_method="tcp://127.0.0.1:{}".format(port),
                            world_size=1, rank=0)


def _model_step(args, packed, offline_shape):
    """``(step, device, mesh shape, joined)`` of ``--with-model``:
    ``step(batch)`` -> metrics on a batch of tensors on ``device``;
    ``joined`` is True when this call brought the process group up."""
    import torch
    import torch.distributed as dist
    from ..device import resolve_device
    from ..models import (BartConfig, BartForPreTraining, BertConfig,
                          BertForPreTraining, BertForPreTrainingPacked,
                          bart_batch_loss)
    from .. import testing

    group_up = dist.is_available() and dist.is_initialized()
    sharded = args.mesh is not None or (group_up
                                        and dist.get_world_size() > 1)
    joined = sharded and not group_up
    if joined:
        device = _join_world(args.device)
    else:
        device = resolve_device(args.device)
    # The model's inputs must be the batch contract's: checked on a
    # synthetic batch, since pulling one from the loader would advance
    # its epoch counter and skip the first epoch's data.
    init_len = args.fixed_seq_lengths[0] if args.fixed_seq_lengths else 128
    batch_loss = None
    cfg_kw = dict(attention_impl=args.attention_impl, remat=args.remat)
    if args.family == "bart":
        cfg = (BartConfig.tiny if args.with_model == "tiny"
               else BartConfig.bart_base)(**cfg_kw)
        model_cls, batch_loss = BartForPreTraining, bart_batch_loss
        sample = testing.fake_bart_batch(cfg.vocab_size, args.batch_size,
                                         init_len, seed=args.seed)
    elif packed:
        # Packed batches (load-time or offline) feed the packed model:
        # block-diagonal attention over segments, per-slot [CLS] pooling,
        # [R, P] NSP labels.
        L = args.pack_seq_length or offline_shape[0]
        P = offline_shape[1] if offline_shape else args.pack_max_per_row
        rows = args.pack_rows or args.batch_size
        make_cfg = (BertConfig.tiny if args.with_model == "tiny"
                    else BertConfig.bert_base)
        if make_cfg(**cfg_kw).max_position_embeddings < L:
            # Packed rows are L wide; size the position table to fit.
            cfg_kw["max_position_embeddings"] = L
        cfg = make_cfg(**cfg_kw)
        model_cls = BertForPreTrainingPacked
        sample = testing.fake_packed_pretrain_batch(cfg.vocab_size, rows, L,
                                                    P, seed=args.seed)
    else:
        cfg = (BertConfig.tiny if args.with_model == "tiny"
               else BertConfig.bert_base)(**cfg_kw)
        model_cls = BertForPreTraining
        sample = testing.fake_pretrain_batch(cfg.vocab_size,
                                             args.batch_size, init_len,
                                             seed=args.seed)
    missing = [k for k in model_cls.BATCH_INPUTS + ("labels",)
               if k not in sample]
    if missing:
        raise ValueError("{} takes {} the loader does not give".format(
            model_cls.__name__, missing))
    # Seed 0 as the reference's create_train_state; the forked state
    # leaves the global generators as they were.
    with torch.random.fork_rng(
            devices=[device] if device.type == "cuda" else [],
            device_type=device.type):
        torch.manual_seed(0)
        with device:
            model = model_cls(cfg)
    if sharded:
        from ..models import create_train_state, make_sharded_train_step
        from ..parallel import make_mesh
        axes = {"dp": -1}
        if args.mesh:
            axes = {k: int(v) for k, v in
                    (kv.split("=") for kv in args.mesh.split(","))}
        mesh = make_mesh(axes)
        model, opt = create_train_state(cfg, mesh, model=model)
        step_fn = make_sharded_train_step(mesh, model, opt,
                                          batch_loss=batch_loss)
        shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
    else:
        from ..models import make_optimizer, make_train_step
        step_fn = make_train_step(model, make_optimizer(model.parameters()),
                                  batch_loss=batch_loss)
        shape = {"dp": 1}

    def step(batch):
        return step_fn(batch, seed=args.seed)

    return step, device, shape, joined


def run(args):
    """The harness on parsed ``attach_args()`` arguments: prints the
    reference's lines and returns a summary dict (``samples``,
    ``wall_s``, ``sustained`` samples/s, ``batch_lens``,
    ``pad``/``slots``, and with a model ``losses``, ``step_ms`` (the
    meter's average), ``step_ms_each`` (every step, host clock) and
    ``mesh``)."""
    from ..loader import get_bert_pretrain_data_loader, prefetch_to_device
    # The observability hooks are inert no-ops unless armed, so no
    # conditional plumbing: configure() is the only gated call.
    from .. import observability as obs

    if args.metrics_dir:
        obs.configure(dir=args.metrics_dir, periodic=True)

    # Shard I/O knobs resolve to the env BEFORE any loader (and so any
    # backend instance or prefetch thread) is built: the mock store
    # reads its latency knob when it is made, and the shard pipeline
    # resolves its depth/budget per stream.
    if args.storage_backend:
        os.environ["LDDL_TPU_STORAGE_BACKEND"] = args.storage_backend
    if args.backend_latency_ms is not None:
        os.environ["LDDL_TPU_MOCK_LATENCY_MS"] = str(args.backend_latency_ms)
    if args.prefetch_shards is not None:
        os.environ["LDDL_TPU_LOADER_PREFETCH_SHARDS"] = \
            str(args.prefetch_shards)
    if args.cache_bytes is not None:
        os.environ["LDDL_TPU_LOADER_CACHE_BYTES"] = str(args.cache_bytes)

    offline_shape = None
    packed = False
    if args.family == "bart":
        from ..loader.bart import get_bart_pretrain_data_loader
        if args.debug:
            raise SystemExit("--debug is a BERT raw-sample inspector; "
                             "the BART loader has no debug formatter")
        if args.fixed_seq_lengths and len(args.fixed_seq_lengths) != 1:
            raise SystemExit("--family bart takes a single "
                             "--fixed-seq-lengths value (BART shards are "
                             "unbinned)")
        fixed = (args.fixed_seq_lengths[0] if args.fixed_seq_lengths
                 else None)
        loader = get_bart_pretrain_data_loader(
            args.path,
            dp_rank=args.dp_rank,
            num_dp_groups=args.num_dp_groups,
            batch_size=args.batch_size,
            num_workers=args.num_workers,
            worker_mode=args.worker_mode,
            vocab_file=args.vocab_file,
            max_seq_length=fixed or 128,
            fixed_seq_length=fixed,
            base_seed=args.seed,
            start_epoch=args.start_epoch,
            return_raw_samples=args.debug,
            on_corrupt=args.on_corrupt,
        )
    else:
        # Packed mode: explicit flags (load-time packer on unpacked
        # shards) or auto-detected offline-packed shards; either way the
        # batch contract below is the packed one.
        from ..loader.bert import packed_shape_of_dir
        offline_shape = packed_shape_of_dir(args.path)
        packed = args.pack_seq_length is not None or offline_shape
        loader = get_bert_pretrain_data_loader(
            args.path,
            dp_rank=args.dp_rank,
            num_dp_groups=args.num_dp_groups,
            batch_size=args.batch_size,
            num_workers=args.num_workers,
            worker_mode=args.worker_mode,
            vocab_file=args.vocab_file,
            fixed_seq_lengths=args.fixed_seq_lengths,
            pack_seq_length=args.pack_seq_length,
            pack_rows=args.pack_rows,
            pack_max_per_row=args.pack_max_per_row,
            base_seed=args.seed,
            start_epoch=args.start_epoch,
            return_raw_samples=args.debug,
            on_corrupt=args.on_corrupt,
        )
    if args.debug:
        from ..preprocess import get_tokenizer
        _debug_print(loader, get_tokenizer(vocab_file=args.vocab_file))
        return {"debug": True}

    step = None
    mesh_shape = None
    joined = False
    if args.with_model:
        step, device, mesh_shape, joined = _model_step(args, packed,
                                                       offline_shape)

    _warm_parquet_reader()
    batch_time = AverageMeter(warmup=2)
    throughput = AverageMeter(warmup=2)
    seq_len_hist = Histogram()
    pad_hist = Histogram()
    all_min_lens, all_max_lens, all_batch_lens = [], [], []
    step_time = AverageMeter(warmup=2)
    losses, step_ms = [], []
    total_samples = 0
    total_wall = 0.0

    batches = loader
    host_lens = None
    if step is not None:
        # Double-buffered device prefetch: the next batch's collate and
        # H2D copy overlap the current step. The per-batch lengths are
        # summed on the host as each batch enters the prefetcher.
        host_lens = _HostLens(loader)
        batches = prefetch_to_device(host_lens, device=device)

    with obs.span("mock_train.run", epochs=args.epochs,
                  batch_size=args.batch_size):
        for epoch in range(args.start_epoch, args.start_epoch + args.epochs):
            epoch_t0 = time.perf_counter()
            epoch_samples = 0
            t0 = time.perf_counter()
            for i, batch in enumerate(batches):
                if host_lens is not None:
                    lens = host_lens.lens.popleft()
                else:
                    lens = batch["attention_mask"].sum(axis=1)
                n, L = batch["input_ids"].shape
                # Shape contracts: shape is metadata, so these never
                # sync a device batch.
                assert tuple(batch["attention_mask"].shape) == (n, L)
                assert tuple(batch["labels"].shape) == (n, L)
                if args.family == "bart":
                    assert tuple(batch["decoder_input_ids"].shape) == (n, L)
                elif "segments" in batch:
                    # Packed contract: per-token segment ids + per-slot
                    # [CLS] columns / NSP labels.
                    assert tuple(batch["segments"].shape) == (n, L)
                    assert batch["cls_positions"].shape == \
                        batch["next_sentence_labels"].shape
                    assert batch["next_sentence_labels"].shape[0] == n
                else:
                    assert tuple(batch["token_type_ids"].shape) == (n, L)
                    assert tuple(batch["next_sentence_labels"].shape) == (n,)
                seq_len_hist.update(L, n)
                pad_hist.update(L, int((L - lens).sum()))
                all_min_lens.append(int(lens.min()))
                all_max_lens.append(int(lens.max()))
                all_batch_lens.append(L)
                if step is not None:
                    ts = time.perf_counter()
                    metrics = step(batch)
                    losses.append(float(metrics["loss"]))  # syncs
                    step_time.update(time.perf_counter() - ts)
                    step_ms.append(step_time.val * 1e3)
                dt = time.perf_counter() - t0
                batch_time.update(dt)
                throughput.update(n / dt)
                epoch_samples += n
                if (i + 1) % args.log_freq == 0:
                    print("epoch {} it {}: {:.1f} samples/s, {:.2f} ms/batch"
                          .format(epoch, i + 1, throughput.avg,
                                  batch_time.avg * 1e3))
                t0 = time.perf_counter()
            total_samples += epoch_samples
            epoch_wall = time.perf_counter() - epoch_t0
            total_wall += epoch_wall
            # Per-epoch sustained rate: epoch 0 is the cold-cache pass,
            # later epochs show the warm shard cache.
            print("epoch {} sustained: {:.1f} samples/s ({} samples / "
                  "{:.2f} s)".format(epoch,
                                     epoch_samples / max(epoch_wall, 1e-9),
                                     epoch_samples, epoch_wall))

    total_tokens = sum(k * v for k, v in seq_len_hist.counts.items())
    total_pad = sum(pad_hist.counts.values())
    sustained = total_samples / max(total_wall, 1e-9)
    print("loader throughput: {:.1f} samples/s avg, {:.2f} ms/batch avg"
          .format(throughput.avg, batch_time.avg * 1e3))
    # Per-batch rate averages overstate sustained speed once prefetch hides
    # batches behind consumption; samples over wall clock is the honest one.
    print("loader sustained: {:.1f} samples/s ({} samples / {:.2f} s)"
          .format(sustained, total_samples, total_wall))
    if step is not None:
        print("train step: {:.2f} ms avg on mesh {}".format(
            step_time.avg * 1e3, mesh_shape))
    print("padded-zero ratio: {:.4f} ({} pad / {} slots)".format(
        total_pad / max(total_tokens, 1), total_pad, total_tokens))
    qbytes, qbatches = _queue_cost(loader)
    if qbatches:
        print("loader queue: {:.0f} bytes/batch over {} batches".format(
            qbytes / qbatches, qbatches))
    if args.seq_len_dir:
        os.makedirs(args.seq_len_dir, exist_ok=True)
        np.savez(
            os.path.join(args.seq_len_dir,
                         "lens_{}.npz".format(args.dp_rank)),
            min_lens=np.asarray(all_min_lens),
            max_lens=np.asarray(all_max_lens),
            batch_lens=np.asarray(all_batch_lens),
        )
        print("wrote {}/lens_{}.npz".format(args.seq_len_dir, args.dp_rank))
    if args.metrics_dir:
        # The loader's own sustained rate goes into the summary, beside
        # the instrumented numbers.
        obs.set_gauge("mock_train_sustained_samples_per_second", sustained)
        _telemetry_report(obs)
    if joined:
        import torch.distributed as dist
        dist.destroy_process_group()
    return {"samples": total_samples, "wall_s": total_wall,
            "sustained": sustained, "batch_lens": all_batch_lens,
            "pad": total_pad, "slots": total_tokens, "losses": losses,
            "step_ms": step_time.avg * 1e3 if step is not None else None,
            "step_ms_each": step_ms, "mesh": mesh_shape}


def main(argv=None):
    run(attach_args().parse_args(argv))


if __name__ == "__main__":
    main()
