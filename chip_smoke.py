#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py`` (``--kernels-only``
stops after phase 3). Phases, in order (any failure raises and the script
exits non-zero):

1. environment: the card's name and power limit (nvidia-smi), CUDA version;
2. build: compile every kernel of the paths from ``lddl_tpu_torch/ops/csrc``
   (four sources: ``attention_fwd.cu``, both bf16 forwards;
   ``online_attention_bwd.cu``, the bf16 backward of both regimes;
   ``attention_f32_fwd.cu`` and ``attention_f32_bwd.cu``, the fp32
   forwards and the fp32 backward of both regimes at D=64 and 128 and the
   fp32 online trio at D=256, 3xTF32 wgmma)
   with nvcc for sm_90a, one
   nvcc per source not built yet, all started together, and the build's
   seconds; print ptxas's register/spill lines (kept beside each library,
   so a cached build has them), a register/spill summary of each of the
   six kernels at D=64 and D=128 and of the three online kernels at D=256
   (which must spill 0 bytes in bf16, as must every fp32 kernel at every
   width) and, from ``cuobjdump -sass``, the HGMMA (wgmma)
   instructions of every bf16 kernel, none of which may be 0, and the
   TF32 HGMMA of every fp32 kernel, none of which may be 0;
3. kernels: hold each kernel against its plain PyTorch version on the card
   (forward O/LSE, backward dQ/dK/dV) at the main paths' shapes, and time
   kernel, plain version and, as a yardstick the port never calls,
   ``F.scaled_dot_product_attention`` (its backward via autograd.grad):
   the single-block kernels at bert_large's bins (plus L=128, 200, 896
   and D=128 at L=512), the online-softmax kernels at bart_base's B=8, H=12,
   L=1024 (plus L=2048, D=128 at L_pad 640, phase 16's D=256 shape B=8,
   H=3, L=1024 and D=256 at L_pad 640), each shape with padding masks and
   with segment ids 1-3 plus a batch row masked entirely, and
   the single-block kernels at the packed phase's shape (B=16, H=16,
   L=512, D=64) with packed rows' segment ids 1-8, timed there too
   against SDPA under the equivalent block-diagonal mask; every kernel
   bit-identical in two launches, at every checked shape; the online
   kernels timed at both B=8, L=1024 shapes (D=64 and D=256);
   the fp32 builds (TF32 off for the plain side, asserted) at the
   single-block pair's B=16, H=16, L 512 and 896 (D=64) and L=512
   (D=128), the online trio's B=8, H=12, L=1024 and L=2048 (D=64), L=1024
   (D=128) and B=8, H=3, L=1024 and L=600 (D=256), each with padding
   masks, segment ids 1-3 and packed rows' segment ids 1-8: within
   F32_BAR of max |ref| (the LSE F32_BAR absolute), bit-identical in two
   launches, and timed at the bf16 rows' shapes (D=64, and the online
   trio at D=256) against their plain versions and SDPA at fp32 under the
   additive mask, beside their FFMA and 3xTF32 bounds (each row bound by
   3xTF32, the products the kernels run);
   ``flash_attention`` at head dims it zero-pads (8, 32, 96 at L=512 on
   the single-block pair, 160 at L=1024 on the online kernels), forward
   and gradients against the plain versions at the true D; then the
   backward against the library's per L at B=16, H=16, D=64 (L 256-1024);
   every time is device time (``cuda_time_ms`` holds the stream while the
   calls queue);
4. binned BERT path: bert_large (vocab 30522, hidden 1024, 24 layers, 16
   heads, attention_dropout 0, attention_impl "auto", fp32 params, bf16
   activations, random weights from a seed) trained for a few steps from
   ``get_bert_pretrain_data_loader`` over synthetic balanced binned shards
   through ``prefetch_to_device``; kernel launch counters are zeroed just
   before and read just after, and must show the single-block kernels;
   then a torch.profiler window of further steps (device time by kernel
   group, idle share) and a check of the flash path against the dense
   path on a small batch;
5. packed BERT path: the same bert_large as ``BertForPreTrainingPacked``
   on offline-packed rows (``testing.write_packed_shards``: 1024 samples
   of 8-512 tokens packed into rows of 512, at most 8 a row), 16 rows a
   step from the packed loader through ``prefetch_to_device``; the
   counters must show ``onekv_fwd`` and ``onekv_bwd`` 24 times a step
   each (the segment ids reach the kernels); a profiled step; an eval
   step; on one batch, flash against dense logits and each sample's
   logits against the sample run alone; then a checkpoint saved, restored
   into a model and optimizer built from another seed, and one step from
   each with the same batch and seed, which must be bit-identical;
6. BART path: bart_base (vocab 30522, hidden 768, 6+6 layers, 12 heads,
   max positions 1024, attention_dropout 0, attention_impl "auto") trained
   for a few steps at L=1024, batch 8, from ``get_bart_pretrain_data_loader``
   over synthetic balanced schema-v2 BART shards through
   ``prefetch_to_device`` with ``bart_batch_loss``; the counters must show
   the three online kernels 6 times per step each (one per encoder
   layer), as must a profiled step; then the flash encoder against the
   dense one on a batch of the loader, in eval mode;
7. distributed BERT path: the port's multi-device entry points as a world
   of 1 over NCCL on cuda:0 (``init_distributed``; RANK, WORLD_SIZE,
   LOCAL_RANK, MASTER_ADDR and a free MASTER_PORT set where the launcher
   did not set them): the communicator rule, an int64 all_reduce past
   2^31, ``make_mesh({"dp": 1, "fsdp": 1, "tp": 1, "sp": 1})``,
   ``create_train_state`` of bert_large (every parameter a DTensor on
   cuda:0), the binned loader with ``process_dp_info``'s dp_rank, then
   3 batches of 16 in each of the L=256 and L=512 bins through
   ``to_device_batch`` and ``make_sharded_train_step``, each beside the
   unsharded ``make_train_step`` from the same weights on the same batch
   and seed: the losses must agree within DIST_LOSS_RTOL and every
   parameter after the steps within DIST_PARAM_ATOL, and each sharded
   step must launch ``onekv_fwd`` and ``onekv_bwd`` 24 times; a second
   unsharded model repeats the unsharded steps, and the parameters and
   first-step gradients that differ are printed for both pairs;
   host-clock step times of both, and of the plan on a mesh of tp alone
   and of fsdp alone; a sharded eval step; a sharded checkpoint saved,
   restored into a model from another seed and a bit-identical next
   step; ``entry.dryrun_multichip(1)``;
8. offline BERT data path, at the README Quickstart's phase-2 setting
   with a quarter of its corpus:
   the native engine built with g++ (its committed ``unicode_tables.h``
   must be calibrated for this Python's ``unicodedata``); the torch
   maskers on the card against the same maskers on the CPU at 4096 x 512
   (token and whole-word: masks and selections bit-identical, the
   counts, candidates, whole words and the 80/10/10 split held); a
   32 MiB text corpus from a seed (64 files of documents of 5-60
   sentences over bert_large's 30522-token vocab) through the port's
   preprocess CLI (target length 512, bins of 64, static masking,
   duplicate factor 5, sample ratio 0.9, 64 blocks, schema v2, up to 16
   spawned workers) with ``--engine torch`` on the card and then
   ``--engine numpy``: wall time, MB/s, the CUDA contexts and device
   memory the workers held; the two runs' shard names, row counts and
   every unmasked column equal and, with the labels put back, every id
   sequence equal; instances per bin; one bucket's masking by each
   engine; ``balance_shards`` to 64 shards a bin (each within 1 of its
   bin's mean, ``.num_samples.json`` and ``.manifest.json`` written);
   the loader alone (batch 16, the 8 bins' lengths): batches/s and
   tokens/s; then bert_large steps from the loader through
   ``prefetch_to_device``, 2 in each bin reached, with finite losses and
   ``onekv_fwd``/``onekv_bwd`` 24 times in each step of a bin with
   L_pad >= 256;
9. the loader's runtime under load, on phase 8's balanced shards (4
   workers a bin, telemetry on through ``LDDL_TPU_METRICS_DIR``): the
   SHA-256 of each of the first 128 batches of epoch 0 equal with thread
   workers, process workers (every bin's pool started at once), and
   process workers whose worker 1 in the bin drawn most is killed at its
   5th batch (``LDDL_TPU_FAULTS``, armed while that pool spawns; exactly
   one restart), with the process runs' queue bytes a batch; startup
   verification of a truncated shard (``on_corrupt="fail"`` refuses it
   by name, ``"quarantine"`` excludes, logs and serves the rest); then
   phase 8's bert_large under the thread and then the process loader,
   continuing their epochs, through ``prefetch_to_device`` (depth 2),
   each step ending in a device sync (``float(loss)``, so the
   prefetcher's gap is the step): 16 counted steps a mode after 2 with
   step ms, batches/s consumed, the attribution report and its stage
   seconds, the processes holding a CUDA context (this one alone; no
   worker with torch mapped) and the launch counts (24 of each
   single-block kernel a step of L_pad >= 256); last, the process loader
   alone, batches/s and tokens/s beside phase 8's. Phase 8 also times
   its loader alone with synchronous shard reads and with read-ahead,
   in turns;
10. offline BART data path: a 32 MiB corpus from a seed (16 files,
   phase 8's generator) through the port's BART preprocess CLI (chunks
   of at least 877 words, 32 blocks, sample ratio 0.9, up to 8 spawned
   workers), schema v2 (``--vocab-file``) and then v1: wall time, MB/s,
   no process with a CUDA context, the two runs' chunk text equal row
   for row, the chunk-token quartiles; ``balance_shards`` to 16 shards
   (each within 1 of the mean); the BART loader alone (batch 8, fixed
   L=1024), batches/s; then bart_base at B=8, L=1024 from the v2 shards
   through ``prefetch_to_device``: 8 steps with finite losses, the
   encoder tokens and pad share of each batch, and 6 launches of each
   online kernel a step;
11. streaming ingest under bert_large: a landing directory grown in three
   rounds (1 MiB, then 256 KiB twice, of one seeded corpus) at phase
   8's setting (target 512, bins of 64, static masking, numpy engine, 4
   shards a bin) -> ``ingest_once`` after each round (generation 0 in
   the root, then ``gen-0001`` and ``gen-0002``; every bin's counts
   within 1 of its row budget, the rows carried, seconds a round), and
   a rescan of the unchanged landing that must be a no-op; a
   ``follow_generations`` thread loader (batch 16) drains epoch 0 while
   round 2 publishes mid-epoch (it must serve generation 0 alone) and
   serves all three generations in epoch 1, from which bert_large
   steps through ``prefetch_to_device``, 2 in each bin reached, with
   finite losses and 24 launches of each single-block kernel a step of
   L_pad >= 256; then a replay of the three rounds into a second root,
   byte-equal in every file;
12. elastic scheduling under bert_large: a 32 MiB corpus (16 files, phase
   8's generator and vocab, seed 2) through phase 8's preprocess CLI
   (numpy engine, 4 workers), once static and once as three
   ``--elastic --lease-ttl 5`` processes on one output directory, each in
   its own session; the first is SIGKILLed with its process group (pool
   workers included) as soon as a lease file names it on a gather unit.
   The survivors must exit 0 having stolen at least one unit (their
   ``lease_steals_total`` and ``lease.steal`` trace events under
   ``LDDL_TPU_METRICS_DIR``), every shard and the manifest must equal the
   static run's byte for byte, and no elastic process may open a CUDA
   context (``DeviceWatch``); printed: the static and elastic seconds,
   the units each holder journaled, steals and fence rejects, the time
   from the kill to the first steal; then the elastic output balanced to
   16 shards a bin -> the loader (batch 16) -> bert_large, 2 steps a bin
   with finite losses, the step ms without each bin's first step, and 24
   launches of each single-block kernel a step of L_pad >= 256;
13. fleet telemetry under bert_large, in three timed parts. (1) Phase 12's
   corpus and three ``--elastic --lease-ttl 5`` hosts again, with
   ``--fleet-telemetry`` and a 1 s heartbeat; the first dies by the kill
   fault (``replace:kill:nth=1:path=_done/group-``: SIGKILL at its first
   gather ledger publish, holding that lease; its spool is flushed
   first, left unclosed). Every shard and the manifest must equal phase
   12's static run's; ``lddl_tpu_torch.tools.pipeline_status --json
   --alerts`` must exit 2 naming the killed host stalled and the
   survivors closed, fire a threshold rule on ``hosts.*.stalled``, count
   the survivors' ``lease_steals_total`` as its steals, and give each
   holder the units of the journal (the survivors' summaries, the killed
   host's ``_done/`` scatter records) in its counters and its
   ``unit.journaled`` events; the survivors must log ``unit.stolen``,
   ``trace_summary --merge`` must give every host a lane, and no host
   process may open a CUDA context. (2) ``ingest_watch --elastic
   --fleet-telemetry --autoscale`` over phase 11's round-0 landing (4
   rounds at 2 s, SLO 64 docs, at most 2 helpers, drain 1 round): at
   least one scale-up, every helper retired (scale-downs = scale-ups,
   none running after), no CUDA context in a helper, generation 0 equal
   to phase 11's byte for byte. (3) bert_large, 2 steps a bin, under a
   ``follow_generations`` loader over that root armed only by
   ``LDDL_TPU_FLEET_DIR``: finite losses, 24 launches of each
   single-block kernel a step of L_pad >= 256, and this process a live
   host of ``pipeline_status`` with the loader's padding efficiency.
   Printed: each part's seconds, the spool bytes a host and the rollups.
14. all four stages, then the analyzer, in two timed parts. (1) Phase 8's
   generator (seed 4) writes 8 MiB of documents, 2 MiB a source, in each
   source's upstream form: 16 wikiextractor files, a ``.tar.gz`` of 32
   books, a ``.tar.xz`` of 4 ``.xz`` subsets of page files, and Common
   Crawl buffer files written by the port's ``ArticleBuffer``. The four
   downloader CLIs (``python -m lddl_tpu_torch.download.<name>``, the
   download and extract steps skipped by ``--no-download --no-extract
   --extracted-dir``, ``--local-archive``, ``--no-newsplease
   --txt-dir``; 8 shards, 4 spawned sharding workers) must write every
   ``source/`` shard equal to the bytes the contract gives (built here
   from the generated documents: sorted inputs, input k::8, one ``<id>
   <flattened text>`` line each), as many documents as were generated,
   with no process mapping the CUDA driver; phase 8's preprocess CLI
   (numpy engine, sample ratio 1.0) over the four trees must read every
   document (``preprocess_docs_total``), then balance to 8 shards a bin
   -> the loader (batch 16) -> bert_large, 2 steps a bin with finite
   losses and 24 launches of each single-block kernel a step of L_pad >=
   256. (2) On the card's host, ``python -m lddl_tpu_torch.tools.
   lddl_check --no-cache --sarif`` over the tree as shipped must exit 0,
   then a cached run must agree and a warm one serve every file from the
   cache; ``pipeline_status <part 1's sink> --json`` must carry
   ``static_analysis`` with ``new`` 0 and the port's rule count.
   Printed: each source's seconds and documents, the preprocess, balance
   and step seconds, the analyzer's cold and warm seconds and its
   findings by rule.
15. bert_large's pipelined encoder: a world of 1 over NCCL (explicit
   ``tcp://`` address, world size and rank), ``make_mesh({"pp": 1, "dp":
   1})``; the 24 layers of a seeded bert_large (LayerNorm scales and
   biases from seed 1, so mean(y**2) depends on every layer) through
   ``stack_layer_params`` into ``make_pipelined_encoder(mesh, cfg,
   n_micro=4)`` and ``reference_encoder(cfg)``; x the model's bf16
   embeddings of a batch of 16 at L=512 from phase 4's shards through
   ``prefetch_to_device``, mask its padded attention mask. The forward
   and the gradients of mean(y.float()**2) for x and every layer
   parameter agree within PIPE_BAR; the pipelined forward + backward
   launches ``onekv_fwd`` and ``onekv_bwd`` 96 times each (24 layers x 4
   microbatches), the unpipelined one 24; host-clock ms of both and
   their ratio.
16. bart_base's widths at head dim 256: phase 6's path (the same loader,
   shards, steps and checks) with ``num_heads=3``, so hidden 768 makes
   head_dim 256 and "auto" sends the encoder's self-attention to the
   D=256 builds of the three online kernels (6 launches of each a step,
   in the counted steps and in a profiled step); the decoder stays dense.
   Host-clock step ms beside phase 6's.
17. bert_large at fp32: phase 4's model (``dtype=torch.float32``),
   loader and train step, F32_STEPS_PER_BIN steps in each of the four
   bins (the first of a bin a warm-up) with finite losses; the counters
   must show ``onekv_fwd_f32`` and ``onekv_bwd_f32`` 24 times a step of
   L_pad >= 256 and no bf16 kernel; step ms beside phase 4's; then at
   L=512 one train step with flash against one with dense from the same
   parameters, batch and dropout seed (learning rate 0, no clipping):
   losses within F32_LOSS_RTOL, global gradient norms within
   F32_NORM_RTOL; then one profiled step at L=512 (``profile_window``):
   the fp32 attention kernels' device time, 24 launches of each, their
   share of the step's device time, and the idle share;
18. bart_base at fp32: phase 6's loader and train step at
   ``dtype=torch.float32``, BART_F32_STEPS steps at B=8, L=1024 (the
   first a warm-up), the encoder on the online trio's fp32 builds (6
   launches of each a step, no bf16 kernel), step ms beside phase 6's,
   the same flash-against-dense train step, and a profiled step as
   phase 17's (6 launches of each fp32 online kernel);
19. bart_base at three heads in fp32: phase 18 with phase 16's widths
   (``num_heads=3``, head dim 256), BART_F32_STEPS steps, the encoder on
   the fp32 online trio's D=256 builds (6 launches of each a step, no
   other kernel), the same
   flash-against-dense train step and a profiled step. No cut of width;
20. the CI identity smokes on the card's host: (1) the six smokes of
   ``lddl_tpu_torch/tools`` (sink, elastic, backend, thread, status,
   cache), each ``python -m lddl_tpu_torch.tools.<name>_smoke`` in a
   process of its own at its default corpus size, each exiting 0 with
   ``identical: true`` (the status smoke with its alert fired and
   resolved), no process of any smoke mapping the CUDA driver (the
   ``DeviceWatch`` rule); (2) the cache smoke's balanced shards, built on
   the mock store with 10 ms a data op, loaded onto the card through
   ``prefetch_to_device`` under its sync leg and its prefetch+cache leg
   (batches of 8 padded to L=256): the device batches equal bit for bit;
   then two bert_large train steps (phase 4's model, full width) on them
   with finite losses, ``onekv_fwd`` and ``onekv_bwd`` 24 launches each
   a step. Each part's seconds.
21. the loader harness: (1) ``lddl_tpu_torch/examples/local_example.sh``
   at its defaults on the card's host (DATA in a temporary directory):
   its eight stages exit 0, ``validate_seqlen`` prints PASS, and no
   process of the recipe maps the CUDA driver (the ``DeviceWatch``
   rule); (2) ``lddl_tpu_torch.tools.mock_train.run`` with ``--with-model
   base --attention-impl flash --epochs 1`` on the card (the presets'
   attention dropout 0.1 pins "auto" to dense): bert_base on binned
   shards (``testing.write_balanced_shards``, 4 bins of 128, 2 shards of
   64 a bin) at batch 16 in the bins 128-512, bert_base
   (``BertForPreTrainingPacked``) on ``testing.write_unbinned_shards``'s
   512 samples packed at load time into 16 rows of 512, and bart_base at
   batch 8, L=1024 on ``testing.write_bart_shards``: finite last losses,
   ``onekv_fwd`` and ``onekv_bwd`` 12 times a BERT step each (one a
   layer), the online trio 6 times a BART step each, no other kernel;
   the binned run's dump through ``validate_seqlen``. Printed: each
   run's ``train step`` ms, ``loader sustained`` rate and launches.

Each phase from 4 prints its seconds. Prints a ``{"kernels": [...]}``
line (``launches`` summed over the paths, ``launches_by_path`` per path:
``download`` is phase 14's, ``pipeline`` phase 15's pipelined run,
``harness`` phase 21's three runs,
``bart_d256`` phase 16's; the ``_d256`` rows are the online kernels'
D=256 builds, timed at phase 16's shape and counted in phase 16 alone,
and the other online rows count every path but phase 16; the ``_f32``
rows are the fp32 builds, launched only in phases 17-19: the
``_f32_d256`` rows counted in phase 19 (``bart_f32_d256``) alone, the
other ``_f32`` rows in every path but phase 19, with
``bound_ffma_ms`` and ``bound_3xtf32_ms`` beside
``bound_ms``, which takes the TF32 peak three times over), the card
line, and
last
``{"ok": true, "device": {...}}``. Exits non-zero without a CUDA device.
"""

import dataclasses
import functools
import hashlib
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import warnings

# torch is imported in main(): the loader's spawned workers re-import this
# script as their main module and must import no torch.
torch = None

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): the bound of each kernel.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
# fp32 on the CUDA cores (FFMA); and TF32 on the tensor cores, which the
# fp32 kernels' 3xTF32 split (three products a product) uses: their bound.
PEAK_F32_FLOPS = 66.9e12
PEAK_TF32_FLOPS = 494.7e12
# The fp32 kernels against their plain versions: O and the gradients
# within F32_BAR of max |ref|, the LSE within F32_BAR absolute (both sides
# compute in fp32; only the summation order differs).
F32_BAR = 1e-5
# Phases 17-18 (fp32): steps a bin (the first a warm-up), BART steps (the
# first a warm-up), and the bars on one flash step against one dense
# step: the loss (relative) and the global gradient norm (relative).
F32_STEPS_PER_BIN = 3
BART_F32_STEPS = 3
F32_LOSS_RTOL = 1e-5
F32_NORM_RTOL = 1e-4
BINS = [128, 256, 384, 512]
STEPS = 16           # counted BERT steps
PROFILE_STEPS = 6    # then a profiled window of further steps
BART_STEPS = 8       # counted BART steps (the first is warm-up)
BART_BATCH, BART_L = 8, 1024
BART_D256_HEADS = 3  # phase 16: bart_base's widths at head dim 256
D256_PATH = "bart_d256"  # phase 16, the one path at head dim 256
F32_D256_PATH = "bart_f32_d256"  # phase 19, the one fp32 path at D=256
# Packed rows: pack_seq_length, rows per batch (the binned L=512 bin's
# 8192 padded tokens a step) and samples per row at most (the preprocess
# CLI's default).
PACK_L, PACK_ROWS, PACK_PER_ROW = 512, 16, 8
PACKED_STEPS = 8     # counted packed steps (the first is warm-up)
PACKED_SAMPLES = 1024
# The distributed phase: sharded and unsharded steps, DIST_STEPS in each
# bin, and the bars on their difference at a world of 1, where the plan
# changes no arithmetic: each step's loss (relative), and every parameter
# after the steps (absolute), far below one AdamW update (~1e-4 x the
# schedule), far above an ulp of a parameter (~1e-9).
DIST_BINS = [256, 512]
DIST_STEPS = 3
DIST_LOSS_RTOL = 1e-6
DIST_PARAM_ATOL = 1e-6

# The offline BERT data path (phase 8), at the README Quickstart's
# phase-2 setting: a corpus of DATA_CORPUS_BYTES in DATA_FILES files ->
# preprocess at target length 512, 64-token bins, static masking ->
# DATA_SHARDS balanced shards a bin -> the loader -> bert_large. The
# corpus is a quarter of the Quickstart's 128 MiB, so that the script
# keeps its time limit on a slow host (phases 8-9 took 296-412 s at 128
# MiB and 297-353 s at 64 MiB; the whole script with phase 21 ~1100 s
# at 64 MiB on a slow host). Block 0 of 64 still holds 2227 rows for
# time_bucket_masking (4347 at 64 MiB).
DATA_CORPUS_BYTES = 32 << 20
DATA_FILES = 64
DATA_TARGET, DATA_BIN = 512, 64
DATA_BINS = [DATA_BIN * (i + 1) for i in range(DATA_TARGET // DATA_BIN)]
DATA_SHARDS = 64
DATA_LOADER_BATCHES = 200    # loader alone: batches timed after the first
DATA_STEPS_PER_BIN = 2       # bert_large steps in each bin reached
DATA_MAX_BATCHES = 400       # batches drawn, at most, to reach the bins
MASK_ROWS, MASK_WIDTH = 4096, 512
BUCKET_MIN_ROWS = 2048       # the bucket whose masking is timed, at least
# Columns the masks change (masked tokens) or are (positions, labels):
# the only ones the torch and numpy engines may disagree on.
# The loader runtime under load (phase 9), on phase 8's balanced shards.
LOADER_WORKERS = 4           # workers a bin, thread or process
LOADER_ID_BATCHES = 128      # batches hashed in each of the three runs
LOADER_STEPS = 16            # counted bert_large steps a worker mode
LOADER_WARM_STEPS = 2        # steps before the counted ones
LOADER_KILL = "worker:kill:nth=5:path=w1:flag={}"
LOADER_STAGES = ("shard_fetch", "shard_read", "decode", "collate", "ipc",
                 "h2d", "prefetch_wait", "prefetch_gap")
MASKED_COLUMNS = {"A", "B", "A_ids", "B_ids", "masked_lm_positions",
                  "masked_lm_labels", "masked_lm_positions_ids",
                  "masked_lm_label_ids"}
# The offline BART data path (phase 10): a corpus of BART_DATA_BYTES in
# BART_DATA_FILES files (phase 8's generator) -> the BART preprocess CLI,
# schema v2 and v1 -> BART_DATA_SHARDS balanced shards -> the BART
# loader -> bart_base at L=1024. Chunks close at BART_DATA_TARGET words:
# ~1.15 WordPiece tokens a word puts a full chunk near L - 2 = 1022
# tokens. Documents of BART_DATA_SENTENCES sentences (~4,500 words) hold
# about five chunks each, so most chunks are full and only a document's
# last one (and the short_seq_prob draws) end shorter.
BART_DATA_BYTES = 32 << 20
BART_DATA_FILES = 16
BART_DATA_TARGET = 880
BART_DATA_SENTENCES = (240, 400)
BART_DATA_BLOCKS = 32
BART_DATA_SHARDS = 16
BART_LOADER_BATCHES = 100    # loader alone: batches timed after the first
# Streaming ingest (phase 11): a landing directory grown in rounds of
# these sizes (one seeded corpus, INGEST_FILES files of 256 KiB), at
# phase 8's setting, INGEST_SHARDS shards a bin in generation 0.
INGEST_ROUND_FILES = (4, 5, 6)
INGEST_FILES = 6
INGEST_FILE_BYTES = 256 << 10
INGEST_SHARDS = 4
INGEST_BATCH = 16
INGEST_STEPS_PER_BIN = 2
# Elastic scheduling (phase 12): a corpus of ELASTIC_BYTES in
# ELASTIC_FILES files (phase 8's generator, seed 2) through phase 8's
# preprocess CLI with ELASTIC_WORKERS workers, once static and once as
# ELASTIC_HOSTS ``--elastic`` processes on one output directory, the
# first of which is SIGKILLed with its workers while it holds a gather
# lease; the elastic output balanced to ELASTIC_SHARDS shards a bin ->
# the loader -> bert_large.
ELASTIC_BYTES = 32 << 20
ELASTIC_FILES = 16
ELASTIC_WORKERS = 4
ELASTIC_HOSTS = 3
ELASTIC_TTL = 5
ELASTIC_SHARDS = 16
ELASTIC_STEPS_PER_BIN = 2
# Fleet telemetry (phase 13): phase 12's corpus and elastic hosts again,
# now with --fleet-telemetry and a FLEET_INTERVAL-second heartbeat, the
# first host SIGKILLed by the kill fault at its first gather ledger
# publish (it holds that gather lease); then ingest_watch --autoscale
# over phase 11's round-0 landing; then bert_large under a fleet-armed
# follow_generations loader over that ingest root.
FLEET_INTERVAL = 1
FLEET_KILL = "replace:kill:nth=1:path=_done/group-"
FLEET_SLO_DOCS = 64          # below round 0's document count
FLEET_MAX_HELPERS = 2
FLEET_DRAIN_ROUNDS = 1
FLEET_ROUNDS = 4
FLEET_WATCH_INTERVAL = 2
FLEET_STEPS_PER_BIN = 2
# All four stages (phase 14): phase 8's generator (seed 4) writes
# DOWNLOAD_BYTES of documents, a quarter a source, in each source's
# upstream form; the four downloader CLIs shard them (local-input flags,
# DOWNLOAD_WORKERS spawned sharding workers); phase 8's preprocess CLI
# (numpy engine, every document sampled) reads the four source trees ->
# balance -> the loader -> bert_large, DOWNLOAD_STEPS_PER_BIN steps a bin.
DOWNLOAD_BYTES = 8 << 20
DOWNLOAD_SOURCES = ("wikipedia", "books", "openwebtext", "common_crawl")
DOWNLOAD_WIKI_FILES = 16     # wikiextractor AA/wiki_NN files
DOWNLOAD_BOOKS = 32          # book .txt files in books1.tar.gz
DOWNLOAD_OWT_SUBSETS = 4     # .xz subsets in openwebtext.tar.xz
DOWNLOAD_CC_FILES = 32       # Common Crawl buffer files
DOWNLOAD_SHARDS = 8          # --num-shards of each downloader
DOWNLOAD_WORKERS = 4         # --number-of-sharding-processes
DOWNLOAD_PRE_WORKERS = 4     # the preprocess CLI's --local-workers
DOWNLOAD_BAL_SHARDS = 8
DOWNLOAD_STEPS_PER_BIN = 2
# bert_large's pipelined encoder (phase 15): pp = 1, PIPE_MICRO
# microbatches of one batch of 16 at L=512, against the unpipelined
# stack on the same weights. Both run bf16 activations through the same
# kernels; they differ only in the matmuls' rows (4 x 512 against 16 x
# 512) and in a parameter's gradient being the sum of the microbatches'
# bf16 contributions, so the forward, gx and every layer gradient are
# held to PIPE_BAR of their largest magnitude, the cross-package bf16 bar
# (test_torch_models.py::test_bf16_logits_close_to_flax). attention.key
# .bias has a zero gradient in exact arithmetic (the softmax ignores a
# shift shared by all keys): it is held to PIPE_BAR of its layer's
# largest gradient magnitude instead.
PIPE_MICRO = 4
PIPE_BAR = 5e-2
PIPE_REPEATS = 3     # timed forward + backward of each, after a warm-up
# The CI identity smokes (phase 20): (1) the six, each at its default
# corpus size, in processes of their own; (2) the cache smoke's balanced
# shards on the latency-injected mock store loaded onto the card twice,
# then SMOKE_STEPS bert_large steps on batches of SMOKE_BATCH padded to
# SMOKE_L (the data's samples are at most 128 tokens; L_pad 256 is the
# first length "auto" sends to the single-block kernels).
SMOKES = ("sink", "elastic", "backend", "thread", "status", "cache")
SMOKE_TIMEOUT = 600
SMOKE_LATENCY_MS = "10"
SMOKE_BATCH = 8
SMOKE_L = 256
SMOKE_STEPS = 2

# The loader harness (phase 21): (1) the recipe at its defaults in a
# temporary DATA; (2) ``mock_train.run --with-model base`` on the card,
# one epoch of each run's synthetic shards (HARNESS_* are the shard
# makers' arguments) with flash attention: bert_base binned at batch 16 in
# the bins of HARNESS_BINS, on load-time packed rows of 512, and bart_base
# at batch 8, L=1024.
HARNESS_RECIPE = "lddl_tpu_torch/examples/local_example.sh"
HARNESS_TIMEOUT = 600
HARNESS_BINS = ["128", "256", "384", "512"]
HARNESS_BINNED = dict(num_bins=4, bin_size=128, shards_per_bin=2,
                      samples_per_shard=64)
HARNESS_UNBINNED = dict(num_shards=2, samples_per_shard=256)
HARNESS_BART = dict(num_shards=2, samples_per_shard=32)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters=20, warmup=3):
    """Device time (ms) per call of ``fn`` over ``iters`` calls. A sleep
    holds the stream while every call is queued, so that a kernel shorter
    than its wrapper's host path is timed on the device, not the host."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)     # ~50 ms; the calls queue behind it
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rel_err(got, ref):
    ref = ref.float()
    return float((got.float() - ref).abs().max() / ref.abs().max())


def attention_inputs(b, l, h, d, seed, segments=False, packed=False,
                     dtype=None):
    """q, k, v, dO [B, L, H, D] in ``dtype`` (bf16 when None) and an int32
    [B, L] mask: padding
    (row 0 full, the others 1 up to a random length), or with
    ``segments`` per-token segment ids 1-3 up to that length and the last
    batch row masked entirely (the kernels then take it as both masks),
    or with ``packed`` the segment ids of packed rows: runs of ids 1-8 at
    random cuts and a padded tail."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn((b, l, h, d), generator=g, device="cuda")
                   .to(dtype or torch.bfloat16) for _ in range(4))
    if packed:
        return q, k, v, do, packed_segments(b, l, g)
    lens = torch.randint(l // 2, l + 1, (b,), generator=g, device="cuda")
    lens[0] = l
    mask = (torch.arange(l, device="cuda")[None, :] < lens[:, None]).to(
        torch.int32)
    if segments:
        mask *= torch.randint(1, 4, (b, l), generator=g, device="cuda",
                              dtype=torch.int32)
        mask[-1] = 0
    return q, k, v, do, mask


def packed_segments(b, l, g):
    """[B, L] int32 segment ids of packed rows: ids 1..PACK_PER_ROW in
    runs that end at sorted random cuts, 0 from the last cut on."""
    n = PACK_PER_ROW
    cuts = torch.sort(torch.randint(1, l, (b, n), generator=g,
                                    device="cuda"), dim=1).values
    cols = torch.arange(l, device="cuda")
    seg = 1 + (cols[None, :, None] >= cuts[:, None, :n - 1]).sum(-1)
    return torch.where(cols[None, :] >= cuts[:, n - 1:], 0,
                       seg).to(torch.int32)


def bound(nbytes, flops, peak=PEAK_BF16_FLOPS):
    """The least time (ms) the card needs for the work, at ``peak``
    FLOP/s, and what sets it."""
    tb = nbytes / PEAK_BYTES_PER_S * 1e3
    tf = flops / peak * 1e3
    return max(tb, tf), ("bytes" if tb >= tf else "operations")


def check_errors(what, e, bar=2e-2, lse_bar=1e-3):
    """Print the errors ``e`` and raise past the bars: ``bar`` of max
    |ref| for O and the gradients, ``lse_bar`` for the LSE (bf16: 2e-2
    and 1e-3 of max |ref|)."""
    bad = {n: x for n, x in e.items()
           if not x <= (lse_bar if n.startswith("LSE") else bar)}
    print("kernel check {}: {}".format(what, " ".join(
        "{}={:.2e}".format(n, x) for n, x in e.items())), flush=True)
    if bad:
        raise AssertionError("kernel disagrees with its plain version at "
                             "{}: {}".format(what, bad))


FWD_SRC = "lddl_tpu_torch/ops/csrc/attention_fwd.cu"
BWD_SRC = "lddl_tpu_torch/ops/csrc/online_attention_bwd.cu"
CSRC = "lddl_tpu_torch/ops/csrc/{}.cu"
# The TPU kernel each port kernel replaces (lddl_tpu/ops/flash_attention.py).
REPLACES = {"onekv_fwd": 441, "onekv_bwd": 459, "online_fwd": 64,
            "online_bwd_dq": 104, "online_bwd_dkv": 133}


def check_repeat(what, names, first, second):
    """Raise unless a second launch gave bit-identical outputs ``names``."""
    torch.cuda.synchronize()
    for name, x, y in zip(names, first, second):
        if not torch.equal(x, y):
            raise AssertionError("{}: two launches gave different {}".format(
                what, name))
    print("kernel check {}: {} bit-identical in two launches".format(
        what, ", ".join(names)), flush=True)


def time_turns(kernel, plain):
    """Plain, kernel, kernel, plain: (kernel ms, plain ms), each the mean
    of its two turns, and the four times."""
    p_a = cuda_time_ms(plain)
    k_a = cuda_time_ms(kernel)
    k_b = cuda_time_ms(kernel)
    p_b = cuda_time_ms(plain)
    return (k_a + k_b) / 2, (p_a + p_b) / 2, [p_a, k_a, k_b, p_b]


def library_calls(q, k, v, do, mask, segments=False):
    """The yardstick the port never calls: PyTorch's fused attention on
    the same inputs and mask, (forward, backward); the backward
    (autograd.grad) gives dQ, dK and dV together. With ``segments`` the
    mask is the kernels' block-diagonal one as a boolean [B, 1, L, L]
    (a padding query attends every key, which averages them uniformly,
    as the kernels' all-masked rows do). fp32 inputs take the mask as
    the kernels' additive fp32 bias (0 or -1e9)."""
    ql, kl, vl = (t.detach().transpose(1, 2).requires_grad_()
                  for t in (q, k, v))
    keep = mask[:, None, None, :] > 0
    if segments:
        keep = (keep & (mask[:, None, :, None] == mask[:, None, None, :])
                | (mask == 0)[:, None, :, None])
    if q.dtype == torch.float32:
        keep = torch.where(keep, 0.0, -1e9).to(torch.float32)

    def fwd():
        return torch.nn.functional.scaled_dot_product_attention(
            ql, kl, vl, attn_mask=keep)

    out, dol = fwd(), do.transpose(1, 2)

    def bwd():
        return torch.autograd.grad(out, (ql, kl, vl), dol, retain_graph=True)

    return fwd, bwd


def check_kernels(fa):
    """Single-block kernels vs plain versions at every checked shape, each
    with padding masks and with segment ids 1-3 plus a batch row masked
    entirely, and at the packed phase's shape with packed rows' segment
    ids 1-8; both kernels bit-identical in two launches. Timings at the
    BERT path's largest kernel bin, with padding and with packed rows.
    Returns the kernels' JSON entries (launch counts filled in later)."""
    shapes = [(16, l, 16, 64) for l in (128, 200, 256, 384, 512, 896)]
    shapes.append((16, 512, 16, 128))
    cases = [(shape, kind) for shape in shapes
             for kind in ("padding", "segments")]
    cases.append(((16, PACK_L, 16, 64), "packed"))
    max_abs = {}
    for (b, l, h, d), kind in cases:
        segments = kind != "padding"
        q, k, v, do, mask = attention_inputs(
            b, l, h, d, seed=l + d, segments=kind == "segments",
            packed=kind == "packed")
        qb, kb, vb, maskb, qmaskb, (_, _, _, _, l_pad) = fa._prep(
            q, k, v, mask, mask if segments else None)
        scale = 1.0 / math.sqrt(d)
        what = "B={} L={} H={} D={} {}".format(
            b, l, h, d, {"padding": "padding", "segments": "segments 1-3",
                         "packed": "packed segments 1-8"}[kind])
        o, lse = fa.onekv_fwd(qb, kb, vb, maskb, qmaskb, scale)
        torch.cuda.synchronize()
        check_repeat(what, ("O", "LSE"), (o, lse),
                     fa.onekv_fwd(qb, kb, vb, maskb, qmaskb, scale))
        o_ref, lse_ref = fa.onekv_fwd_plain(qb, kb, vb, maskb, qmaskb, scale)
        torch.cuda.synchronize()
        dob = fa._prep_one(do, l_pad)
        delta = (dob.float() * o_ref.float()).sum(-1)
        args = (qb, kb, vb, maskb, qmaskb, dob, lse_ref, delta, scale)
        grads = fa.onekv_bwd(*args)
        torch.cuda.synchronize()
        check_repeat(what, ("dQ", "dK", "dV"), grads, fa.onekv_bwd(*args))
        grads_ref = fa.onekv_bwd_plain(*args)
        torch.cuda.synchronize()
        e = {"O": rel_err(o, o_ref), "LSE": rel_err(lse, lse_ref)}
        for name, got, ref in zip(("dQ", "dK", "dV"), grads, grads_ref):
            e[name] = rel_err(got, ref)
        check_errors(what, e)
        if (l, d) == (512, 64) and kind == "padding":  # the largest bin
            max_abs["fwd"] = max(
                float((o.float() - o_ref.float()).abs().max()),
                float((lse - lse_ref).abs().max()))
            max_abs["bwd"] = max(float((g.float() - r.float()).abs().max())
                                 for g, r in zip(grads, grads_ref))

    # Timings at the largest main-path bin: B=16, H=16, L=512, D=64.
    b, l, h, d = 16, 512, 16, 64
    q, k, v, do, mask = attention_inputs(b, l, h, d, seed=7)
    qb, kb, vb, maskb, qmaskb, _ = fa._prep(q, k, v, mask, None)
    scale = 1.0 / math.sqrt(d)
    o, lse = fa.onekv_fwd_plain(qb, kb, vb, maskb, qmaskb, scale)
    dob = fa._prep_one(do, l)
    delta = (dob.float() * o.float()).sum(-1)
    fwd_in = (qb, kb, vb, maskb, qmaskb, scale)
    bwd_in = (qb, kb, vb, maskb, qmaskb, dob, lse, delta, scale)
    lib_fwd, lib_bwd = library_calls(q, k, v, do, mask)
    # The library's backward in two turns, around the port's: one turn
    # has varied by 2x between calls.
    lib_bwd_turns = [cuda_time_ms(lib_bwd)]
    t = {"fwd": time_turns(lambda: fa.onekv_fwd(*fwd_in),
                           lambda: fa.onekv_fwd_plain(*fwd_in)),
         "bwd": time_turns(lambda: fa.onekv_bwd(*bwd_in),
                           lambda: fa.onekv_bwd_plain(*bwd_in))}
    lib_bwd_turns.append(cuda_time_ms(lib_bwd))
    lib = {"fwd": cuda_time_ms(lib_fwd),
           "bwd": sum(lib_bwd_turns) / len(lib_bwd_turns)}
    print("timings B={} L={} H={} D={} (ms; plain, kernel, kernel, plain): "
          "{}; library fwd {:.4f}, library bwd turns {}".format(
              b, l, h, d, json.dumps(
                  {n: [round(x, 4) for x in v[2]] for n, v in t.items()}),
              lib["fwd"], [round(x, 4) for x in lib_bwd_turns]), flush=True)
    print("single-block backward: {:.4f} ms, library backward {:.4f} ms "
          "(mean of two turns), ratio {:.2f}".format(
              t["bwd"][0], lib["bwd"], t["bwd"][0] / lib["bwd"]), flush=True)

    bh, n = b * h, b * h * l * d
    fwd_bytes = 4 * n * 2 + 2 * b * l * 4 + bh * l * 4
    fwd_flops = 2 * 2 * bh * l * l * d
    bwd_bytes = 7 * n * 2 + 2 * b * l * 4 + 2 * bh * l * 4
    bwd_flops = 5 * 2 * bh * l * l * d
    fb, fby = bound(fwd_bytes, fwd_flops)
    bb, bby = bound(bwd_bytes, bwd_flops)
    time_packed(fa, fwd_bytes, bwd_bytes)
    return [
        {"name": "onekv_fwd", "route": "cuda", "source": FWD_SRC,
         "replaces": "lddl_tpu/ops/flash_attention.py:{}".format(
             REPLACES["onekv_fwd"]),
         "launches": 0, "max_abs_err": max_abs["fwd"], "ms": t["fwd"][0],
         "plain_ms": t["fwd"][1], "bound_ms": fb, "bound_by": fby,
         "library_ms": lib["fwd"]},
        {"name": "onekv_bwd", "route": "cuda", "source": BWD_SRC,
         "replaces": "lddl_tpu/ops/flash_attention.py:{}".format(
             REPLACES["onekv_bwd"]),
         "launches": 0, "max_abs_err": max_abs["bwd"], "ms": t["bwd"][0],
         "plain_ms": t["bwd"][1], "bound_ms": bb, "bound_by": bby,
         "library_ms": lib["bwd"]},
    ]


def time_packed(fa, fwd_bytes, bwd_bytes):
    """Both single-block kernels at the packed phase's shape (B=16, H=16,
    L=512, D=64) with packed rows' segment ids 1-8, against their plain
    versions and SDPA under the equivalent boolean block-diagonal mask.
    The bound counts the products that the segments need: the sum over
    segments of (length x length), not L x L."""
    b, l, h, d = 16, PACK_L, 16, 64
    q, k, v, do, seg = attention_inputs(b, l, h, d, seed=17, packed=True)
    qb, kb, vb, maskb, qmaskb, _ = fa._prep(q, k, v, seg, seg)
    scale = 1.0 / math.sqrt(d)
    o, lse = fa.onekv_fwd_plain(qb, kb, vb, maskb, qmaskb, scale)
    dob = fa._prep_one(do, l)
    delta = (dob.float() * o.float()).sum(-1)
    fwd_in = (qb, kb, vb, maskb, qmaskb, scale)
    bwd_in = (qb, kb, vb, maskb, qmaskb, dob, lse, delta, scale)
    lib_fwd, lib_bwd = library_calls(q, k, v, do, seg, segments=True)
    lib_bwd_turns = [cuda_time_ms(lib_bwd)]
    t = {"fwd": time_turns(lambda: fa.onekv_fwd(*fwd_in),
                           lambda: fa.onekv_fwd_plain(*fwd_in)),
         "bwd": time_turns(lambda: fa.onekv_bwd(*bwd_in),
                           lambda: fa.onekv_bwd_plain(*bwd_in))}
    lib_bwd_turns.append(cuda_time_ms(lib_bwd))
    lib = {"fwd": cuda_time_ms(lib_fwd),
           "bwd": sum(lib_bwd_turns) / len(lib_bwd_turns)}
    lens = torch.stack([(seg == i).sum(1)
                        for i in range(1, PACK_PER_ROW + 1)])
    pairs = int((lens.double() ** 2).sum())      # query-key pairs needed
    row = {}
    for name, nbytes, products in (("fwd", fwd_bytes, 2),
                                   ("bwd", bwd_bytes, 5)):
        bms, by = bound(nbytes, 2 * products * h * pairs * d)
        row[name] = {"ms": t[name][0], "plain_ms": t[name][1],
                     "library_ms": lib[name], "bound_ms": bms,
                     "bound_by": by, "turns": t[name][2]}
    print("packed segments 1-8 B={} L={} H={} D={} ({} of {} query-key "
          "pairs in a segment): {}; library bwd turns {}".format(
              b, l, h, d, pairs, b * l * l, json.dumps(row),
              [round(x, 4) for x in lib_bwd_turns]), flush=True)


def backward_by_length(fa):
    """The backward at B=16, H=16, D=64 with padding masks per L: the
    single-block ``onekv_bwd`` up to L_pad 896, the online pair at 1024,
    between two turns of the library's backward. Prints one JSON line per
    L with the time per streamed tile of one 128-row item (us: ms * 1e3 /
    (B H (L / 128) (L / 64))), which shows what an item's fixed cost
    weighs at short L."""
    b, h, d = 16, 16, 64
    for l in (256, 384, 512, 896, 1024):
        q, k, v, do, mask = attention_inputs(b, l, h, d, seed=l)
        qb, kb, vb, maskb, qmaskb, _ = fa._prep(q, k, v, mask, None)
        scale = 1.0 / math.sqrt(d)
        o, lse = fa.online_fwd_plain(qb, kb, vb, maskb, qmaskb, scale)
        dob = fa._prep_one(do, l)
        delta = (dob.float() * o.float()).sum(-1)
        args = (qb, kb, vb, maskb, qmaskb, dob, lse, delta, scale)
        if fa._use_onekv(l, d):
            name, port = "onekv_bwd", lambda: fa.onekv_bwd(*args)
        else:
            name = "online pair"
            port = lambda: (fa.online_bwd_dq(*args), fa.online_bwd_dkv(*args))
        _, lib_bwd = library_calls(q, k, v, do, mask)
        ms = {"library": [cuda_time_ms(lib_bwd)], name: []}
        ms[name] += [cuda_time_ms(port), cuda_time_ms(port)]
        ms["library"].append(cuda_time_ms(lib_bwd))
        tiles = b * h * (l // 128) * (l // 64)
        print("backward by length: " + json.dumps({
            "B": b, "H": h, "L": l, "D": d, "ms": ms,
            "us_per_tile": {n: 1e3 * sum(t) / len(t) / tiles
                            for n, t in ms.items()}}), flush=True)


def check_online_kernels(fa):
    """Online-softmax kernels vs plain versions at bart_base's shape, at
    L=2048, at D=128 (L_pad 640), at phase 16's D=256 shape (B=8, L=1024,
    H=3) and at the reference's D=256 case (L=600, L_pad 640), each with
    padding masks and with segment ids 1-3 plus a batch row masked
    entirely; every kernel must give bit-identical results in two
    launches. Timings at bart_base's shape and at phase 16's. Returns the
    kernels' JSON entries (launch counts filled in later): the D=64 rows
    under the kernels' names, the D=256 rows with a ``_d256`` suffix."""
    main = {64: (BART_BATCH, BART_L, 12, 64),
            256: (BART_BATCH, BART_L, BART_D256_HEADS, 256)}
    max_abs = {}
    for (b, l, h, d), segments in (
            (shape, seg) for shape in (main[64], (2, 2048, 4, 64),
                                       (4, 600, 4, 128), main[256],
                                       (2, 600, 2, 256))
            for seg in (False, True)):
        q, k, v, do, mask = attention_inputs(b, l, h, d, seed=l + d + 1,
                                             segments=segments)
        qb, kb, vb, maskb, qmaskb, (_, _, _, _, l_pad) = fa._prep(
            q, k, v, mask, mask if segments else None)
        if fa._use_onekv(l_pad, d):
            raise AssertionError("L_pad {} at D={} is not in the online "
                                 "regime".format(l_pad, d))
        scale = 1.0 / math.sqrt(d)
        what = "online B={} L={} H={} D={} {}".format(
            b, l, h, d, "segments" if segments else "padding")
        o, lse = fa.online_fwd(qb, kb, vb, maskb, qmaskb, scale)
        torch.cuda.synchronize()
        check_repeat(what, ("O", "LSE"), (o, lse),
                     fa.online_fwd(qb, kb, vb, maskb, qmaskb, scale))
        o_ref, lse_ref = fa.online_fwd_plain(qb, kb, vb, maskb, qmaskb,
                                             scale)
        dob = fa._prep_one(do, l_pad)
        delta = (dob.float() * o_ref.float()).sum(-1)
        args = (qb, kb, vb, maskb, qmaskb, dob, lse_ref, delta, scale)
        dq = fa.online_bwd_dq(*args)
        torch.cuda.synchronize()
        dk, dv = fa.online_bwd_dkv(*args)
        torch.cuda.synchronize()
        check_repeat(what, ("dQ", "dK", "dV"), (dq, dk, dv),
                     (fa.online_bwd_dq(*args),) + fa.online_bwd_dkv(*args))
        dq_ref = fa.online_bwd_dq_plain(*args)
        dk_ref, dv_ref = fa.online_bwd_dkv_plain(*args)
        torch.cuda.synchronize()
        check_errors(what, {
            "O": rel_err(o, o_ref), "LSE": rel_err(lse, lse_ref),
            "dQ": rel_err(dq, dq_ref), "dK": rel_err(dk, dk_ref),
            "dV": rel_err(dv, dv_ref)})
        if (b, l, h, d) == main.get(d) and not segments:
            def abs_err(a, r):
                return float((a.float() - r.float()).abs().max())
            max_abs[d] = {
                "online_fwd": max(abs_err(o, o_ref), abs_err(lse, lse_ref)),
                "online_bwd_dq": abs_err(dq, dq_ref),
                "online_bwd_dkv": max(abs_err(dk, dk_ref),
                                      abs_err(dv, dv_ref))}
    return (time_online_kernels(fa, main[64], max_abs[64], "",
                                lambda path: path != D256_PATH)
            + time_online_kernels(fa, main[256], max_abs[256], "_d256",
                                  lambda path: path == D256_PATH))


def time_online_kernels(fa, shape, max_abs, suffix, counts_path):
    """The three online kernels at ``shape`` with padding masks: kernel
    and plain version in turns and SDPA's forward and backward (two turns
    around the port's); returns their JSON entries, named with
    ``suffix``. Each entry carries the wrapper's counter (``counter``) and
    which paths' launches it counts (``counts_path``, a predicate on the
    path's name); ``main`` takes both out of the entry."""
    b, l, h, d = shape
    q, k, v, do, mask = attention_inputs(b, l, h, d, seed=11)
    qb, kb, vb, maskb, qmaskb, _ = fa._prep(q, k, v, mask, None)
    scale = 1.0 / math.sqrt(d)
    o, lse = fa.online_fwd_plain(qb, kb, vb, maskb, qmaskb, scale)
    dob = fa._prep_one(do, l)
    delta = (dob.float() * o.float()).sum(-1)
    fwd_in = (qb, kb, vb, maskb, qmaskb, scale)
    bwd_in = (qb, kb, vb, maskb, qmaskb, dob, lse, delta, scale)
    lib_fwd, lib_bwd = library_calls(q, k, v, do, mask)
    lib_bwd_turns = [cuda_time_ms(lib_bwd)]   # two turns, around the port's
    t = {}
    for name, kernel, plain, args in (
            ("online_fwd", fa.online_fwd, fa.online_fwd_plain, fwd_in),
            ("online_bwd_dq", fa.online_bwd_dq, fa.online_bwd_dq_plain,
             bwd_in),
            ("online_bwd_dkv", fa.online_bwd_dkv, fa.online_bwd_dkv_plain,
             bwd_in)):
        t[name] = time_turns(lambda: kernel(*args), lambda: plain(*args))
    lib_bwd_turns.append(cuda_time_ms(lib_bwd))
    lib = {"fwd": cuda_time_ms(lib_fwd),
           "bwd": sum(lib_bwd_turns) / len(lib_bwd_turns)}
    print("timings B={} L={} H={} D={} (ms; plain, kernel, kernel, plain): "
          "{}; library fwd {:.4f}, library bwd turns {}".format(
              b, l, h, d, json.dumps(
                  {n: [round(x, 4) for x in v[2]] for n, v in t.items()}),
              lib["fwd"], [round(x, 4) for x in lib_bwd_turns]), flush=True)
    pair = t["online_bwd_dq"][0] + t["online_bwd_dkv"][0]
    print("online backward pair at D={}: dQ + dK/dV {:.4f} ms, library "
          "backward {:.4f} ms (mean of two turns), ratio {:.2f}".format(
              d, pair, lib["bwd"], pair / lib["bwd"]), flush=True)

    bh, n = b * h, b * h * l * d
    masks, row = 2 * b * l * 4, bh * l * 4
    product = 2 * bh * l * l * d
    work = {   # (bytes: each input read once, each output written once;
               #  bf16 matmul FLOP)
        "online_fwd": (4 * n * 2 + masks + row, 2 * product),
        "online_bwd_dq": (5 * n * 2 + masks + 2 * row, 3 * product),
        "online_bwd_dkv": (6 * n * 2 + masks + 2 * row, 4 * product),
    }
    src = {"online_fwd": FWD_SRC, "online_bwd_dq": BWD_SRC,
           "online_bwd_dkv": BWD_SRC}
    entries = []
    for name in ("online_fwd", "online_bwd_dq", "online_bwd_dkv"):
        bms, by = bound(*work[name])
        entries.append({
            "name": name + suffix, "route": "cuda", "source": src[name],
            "replaces": "lddl_tpu/ops/flash_attention.py:{}".format(
                REPLACES[name]),
            "launches": 0, "max_abs_err": max_abs[name], "ms": t[name][0],
            "plain_ms": t[name][1], "bound_ms": bms, "bound_by": by,
            "library_ms": lib["fwd" if name == "online_fwd" else "bwd"],
            "shape": {"B": b, "L": l, "H": h, "D": d},
            "counter": name, "counts_path": counts_path})
    return entries


def check_f32_kernels(fa):
    """The fp32 builds of the five kernels against their plain versions on
    the card, whose products run in full fp32 (TF32 off, asserted): the
    single-block pair at B=16, H=16 at L 512 and 896 (D=64) and L=512
    (D=128), the online trio at bart_base's B=8, H=12, L=1024 and at
    L=2048 (D=64), at L=1024 (D=128) and at phase 16's B=8, H=3, L=1024
    and L=600 (D=256); each shape with padding masks, with segment ids
    1-3 plus a batch row masked entirely, and with packed rows' segment
    ids 1-8. Every output within F32_BAR (of max |ref|; absolute for the
    LSE) and bit-identical in two launches. Then the timing rows at the
    bf16 rows' shapes, the D=256 ones named with a ``_d256`` suffix;
    returns their JSON entries (launch counts filled in later)."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on for fp32 matmuls: the plain "
                             "versions would not compute in fp32")
    onekv = [(16, 512, 16, 64), (16, 896, 16, 64), (16, 512, 16, 128)]
    online = [(BART_BATCH, BART_L, 12, 64), (2, 2048, 4, 64),
              (4, 1024, 4, 128), (BART_BATCH, BART_L, BART_D256_HEADS, 256),
              (2, 600, 2, 256)]
    trio = ("online_fwd", "online_bwd_dq", "online_bwd_dkv")
    timed = {(16, 512, 16, 64): ("onekv_fwd", "onekv_bwd"),
             (BART_BATCH, BART_L, 12, 64): trio,
             (BART_BATCH, BART_L, BART_D256_HEADS, 256): trio}
    max_abs = {}     # {shape: {kernel: max |err|}}
    for (b, l, h, d), kind in ((shape, kind) for shape in onekv + online
                               for kind in ("padding", "segments",
                                            "packed")):
        segments = kind != "padding"
        q, k, v, do, mask = attention_inputs(
            b, l, h, d, seed=l + d + 2, segments=kind == "segments",
            packed=kind == "packed", dtype=torch.float32)
        qb, kb, vb, maskb, qmaskb, (_, _, _, _, l_pad) = fa._prep(
            q, k, v, mask, mask if segments else None)
        single = fa._use_onekv(l_pad, d)
        if single != ((b, l, h, d) in onekv):
            raise AssertionError("L_pad {} at D={} is not in the regime "
                                 "checked".format(l_pad, d))
        scale = 1.0 / math.sqrt(d)
        what = "fp32 {} B={} L={} H={} D={} {}".format(
            "single-block" if single else "online", b, l, h, d,
            {"padding": "padding", "segments": "segments 1-3",
             "packed": "packed segments 1-8"}[kind])
        fwd = fa.onekv_fwd if single else fa.online_fwd
        fwd_plain = fa.onekv_fwd_plain if single else fa.online_fwd_plain
        o, lse = fwd(qb, kb, vb, maskb, qmaskb, scale)
        torch.cuda.synchronize()
        check_repeat(what, ("O", "LSE"), (o, lse),
                     fwd(qb, kb, vb, maskb, qmaskb, scale))
        o_ref, lse_ref = fwd_plain(qb, kb, vb, maskb, qmaskb, scale)
        dob = fa._prep_one(do, l_pad)
        delta = (dob * o_ref).sum(-1)
        args = (qb, kb, vb, maskb, qmaskb, dob, lse_ref, delta, scale)
        if single:
            def bwd():
                return fa.onekv_bwd(*args)
            grads_ref = fa.onekv_bwd_plain(*args)
        else:
            def bwd():
                return (fa.online_bwd_dq(*args),) + fa.online_bwd_dkv(*args)
            grads_ref = ((fa.online_bwd_dq_plain(*args),)
                         + fa.online_bwd_dkv_plain(*args))
        grads = bwd()
        torch.cuda.synchronize()
        check_repeat(what, ("dQ", "dK", "dV"), grads, bwd())
        torch.cuda.synchronize()
        e = {"O": rel_err(o, o_ref),
             "LSE abs": float((lse - lse_ref).abs().max())}
        for name, got, ref in zip(("dQ", "dK", "dV"), grads, grads_ref):
            e[name] = rel_err(got, ref)
        check_errors(what, e, F32_BAR, F32_BAR)
        if (b, l, h, d) in timed and kind == "padding":
            err = {n: float((g - r).abs().max()) for n, g, r in zip(
                ("O", "LSE", "dQ", "dK", "dV"), (o, lse) + tuple(grads),
                (o_ref, lse_ref) + tuple(grads_ref))}
            fwd_err = max(err["O"], err["LSE"])
            max_abs[(b, l, h, d)] = (
                {"onekv_fwd": fwd_err,
                 "onekv_bwd": max(err["dQ"], err["dK"], err["dV"])}
                if single else
                {"online_fwd": fwd_err, "online_bwd_dq": err["dQ"],
                 "online_bwd_dkv": max(err["dK"], err["dV"])})
    return [row for shape, names in timed.items()
            for row in time_f32_kernels(fa, shape, names, max_abs[shape])]


def time_f32_kernels(fa, shape, names, max_abs):
    """The fp32 kernels ``names`` (one regime's) at ``shape`` with padding
    masks: kernel and plain version in turns, and SDPA at fp32 under the
    kernels' additive mask (forward, and backward in two turns around
    the port's). Bound: bytes of fp32 operands at 3.35 TB/s against the
    reference's products at the peak of the kernels' own operations, the
    TF32 peak three times over (3xTF32); ``bound_ffma_ms`` and
    ``bound_3xtf32_ms`` give the FFMA and 3xTF32 bounds. Rows at
    D=256 are named with a ``_d256`` suffix and count phase 19's launches
    alone, the others every path's but phase 19's. Returns the JSON
    entries."""
    b, l, h, d = shape
    q, k, v, do, mask = attention_inputs(b, l, h, d, seed=7,
                                         dtype=torch.float32)
    qb, kb, vb, maskb, qmaskb, _ = fa._prep(q, k, v, mask, None)
    scale = 1.0 / math.sqrt(d)
    single = names[0] == "onekv_fwd"
    fwd_plain = fa.onekv_fwd_plain if single else fa.online_fwd_plain
    o, lse = fwd_plain(qb, kb, vb, maskb, qmaskb, scale)
    dob = fa._prep_one(do, l)
    delta = (dob * o).sum(-1)
    fwd_in = (qb, kb, vb, maskb, qmaskb, scale)
    bwd_in = (qb, kb, vb, maskb, qmaskb, dob, lse, delta, scale)
    lib_fwd, lib_bwd = library_calls(q, k, v, do, mask)
    lib_bwd_turns = [cuda_time_ms(lib_bwd)]
    t = {name: time_turns(
        lambda: getattr(fa, name)(*(fwd_in if "fwd" in name else bwd_in)),
        lambda: getattr(fa, name + "_plain")(
            *(fwd_in if "fwd" in name else bwd_in)))
        for name in names}
    lib_bwd_turns.append(cuda_time_ms(lib_bwd))
    lib = {"fwd": cuda_time_ms(lib_fwd),
           "bwd": sum(lib_bwd_turns) / len(lib_bwd_turns)}
    print("fp32 timings B={} L={} H={} D={} (ms; plain, kernel, kernel, "
          "plain): {}; library fwd {:.4f}, library bwd turns {}".format(
              b, l, h, d, json.dumps(
                  {n: [round(x, 4) for x in v[2]] for n, v in t.items()}),
              lib["fwd"], [round(x, 4) for x in lib_bwd_turns]), flush=True)

    n = b * h * l * d
    masks, row = 2 * b * l * 4, b * h * l * 4
    product = 2 * b * h * l * l * d
    work = {   # (bytes: fp32 operands, each read once, each output written
               #  once; the reference's products, FLOP)
        "onekv_fwd": (4 * n * 4 + masks + row, 2 * product),
        "onekv_bwd": (7 * n * 4 + masks + 2 * row, 5 * product),
        "online_fwd": (4 * n * 4 + masks + row, 2 * product),
        "online_bwd_dq": (5 * n * 4 + masks + 2 * row, 3 * product),
        "online_bwd_dkv": (6 * n * 4 + masks + 2 * row, 4 * product),
    }
    entries = []
    for name in names:
        nbytes, flops = work[name]
        source = fa.f32_source("lddl_{}_f32".format(name), d)
        bms, by = bound(nbytes, 3 * flops, PEAK_TF32_FLOPS)
        entries.append({
            "name": name + "_f32" + ("_d256" if d == 256 else ""),
            "route": "cuda", "source": CSRC.format(source),
            "replaces": "lddl_tpu/ops/flash_attention.py:{}".format(
                REPLACES[name]),
            "launches": 0, "max_abs_err": max_abs[name], "ms": t[name][0],
            "plain_ms": t[name][1], "bound_ms": bms, "bound_by": by,
            "library_ms": lib["fwd" if "fwd" in name else "bwd"],
            "bound_ffma_ms": bound(nbytes, flops, PEAK_F32_FLOPS)[0],
            "bound_3xtf32_ms": bound(nbytes, 3 * flops, PEAK_TF32_FLOPS)[0],
            "shape": {"B": b, "L": l, "H": h, "D": d}})
        d256 = d == 256
        entries[-1].update({
            "counter": name + "_f32",
            "counts_path": lambda path, d256=d256: (
                (path == F32_D256_PATH) == d256)})
        row = entries[-1]
        print("fp32 {} D={}: {:.4f} ms, bound {:.4f} ms ({}; FFMA {:.4f}, "
              "3xTF32 {:.4f}, {:.1%} of it), plain {:.4f} ms, SDPA at fp32 "
              "{:.4f} ms".format(name, d, t[name][0], bms, by,
                                 row["bound_ffma_ms"],
                                 row["bound_3xtf32_ms"],
                                 row["bound_3xtf32_ms"] / t[name][0],
                                 t[name][1], row["library_ms"]), flush=True)
    return entries


def check_padded_widths(fa):
    """flash_attention on the card at head dims the kernels are not built
    for, which it zero-pads to the next built width: D=8, 32 and 96 at
    L=512 (the single-block pair, at 64, 64 and 128) and D=160 at L=1024
    (the online kernels, at 256). The forward and the gradients of
    sum(out * dO) against the plain versions at the true D (no padding,
    the regime the true D picks), within the kernel bars; each case must
    have launched its regime's kernels."""
    b, h = 4, 4
    for l, d in ((512, 8), (512, 32), (512, 96), (1024, 160)):
        q, k, v, do, mask = attention_inputs(b, l, h, d, seed=3 * d + 1)
        onekv = fa._use_onekv(l, d)
        zero_launches(fa)
        qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
        out = fa.flash_attention(qg, kg, vg, kv_mask=mask)
        dq, dk, dv = torch.autograd.grad(out, (qg, kg, vg), do)
        torch.cuda.synchronize()
        launched = {n: c for n, c in read_launches(fa).items() if c}
        want = ({"onekv_fwd": 1, "onekv_bwd": 1} if onekv else
                {"online_fwd": 1, "online_bwd_dq": 1, "online_bwd_dkv": 1})
        if launched != want:
            raise AssertionError("D={} L={} launched {}, want {}".format(
                d, l, launched, want))

        def flat(t):      # [B, L, H, D] -> [B*H, L, D], D unpadded
            return t.permute(0, 2, 1, 3).reshape(b * h, l, d).contiguous()

        qb, kb, vb, dob = (flat(t) for t in (q, k, v, do))
        maskb = mask.contiguous()
        qmaskb = torch.ones_like(maskb)
        scale = 1.0 / math.sqrt(d)
        fwd = fa.onekv_fwd_plain if onekv else fa.online_fwd_plain
        o_ref, lse_ref = fwd(qb, kb, vb, maskb, qmaskb, scale)
        delta = (dob.float() * o_ref.float()).sum(-1)
        args = (qb, kb, vb, maskb, qmaskb, dob, lse_ref, delta, scale)
        if onekv:
            grads_ref = fa.onekv_bwd_plain(*args)
        else:
            grads_ref = ((fa.online_bwd_dq_plain(*args),)
                         + fa.online_bwd_dkv_plain(*args))
        torch.cuda.synchronize()
        e = {"O": rel_err(out.detach(), fa._from_bh(o_ref, b, l, h, d))}
        for name, got, ref in zip(("dQ", "dK", "dV"), (dq, dk, dv),
                                  grads_ref):
            e[name] = rel_err(got, fa._from_bh(ref, b, l, h, d))
        check_errors("padded D={} (kernel width {}) L={} {}".format(
            d, fa.kernel_head_dim(d), l, "single-block" if onekv
            else "online"), e)


def ptxas_summary(log):
    """{(kernel, D): "N registers, X bytes spill stores, Y bytes spill
    loads"} from ptxas's -v report of one build."""
    import re
    out, key = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function "
                      r"'\S*?([a-z_]+(?:_f32)?_kernel)ILi(\d+)E", line)
        if m:
            key = (m.group(1), int(m.group(2)))
            out[key] = []
        elif key is not None:
            m = re.search(r"(\d+ bytes spill stores, \d+ bytes spill loads)|"
                          r"Used (\d+ registers)", line)
            if m:
                out[key].insert(0 if m.group(2) else 1,
                                m.group(1) or m.group(2))
    return {k: ", ".join(v) for k, v in out.items()}


def sass_opcodes(lib_path, full=False):
    """{kernel function: {opcode: instructions}} of a built library's
    SASS (cuobjdump from the CUDA toolkit, or Triton's copy), by base
    mnemonic: the opcode before its first modifier, so ``HFMA2.MMA`` (an
    fp16 FMA that moves constants) counts as ``HFMA2`` and
    ``HGMMA.64x64x16.F32.BF16`` as ``HGMMA``; with ``full``, by the whole
    opcode, modifiers included (``HGMMA.64x32x8.F32.TF32``)."""
    import collections
    import re
    tool = shutil.which("cuobjdump")
    candidates = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                               "bin", "cuobjdump")]
    try:
        import triton
        candidates.append(os.path.join(os.path.dirname(triton.__file__),
                                       "backends", "nvidia", "bin",
                                       "cuobjdump"))
    except ImportError:
        pass
    for c in candidates:
        if tool is None and os.path.isfile(c):
            tool = c
    if tool is None:
        raise RuntimeError("cuobjdump not found (PATH, $CUDA_HOME/bin or "
                           "triton/backends/nvidia/bin)")
    out = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                         text=True, check=True, timeout=300).stdout
    counts, fn = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = collections.Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?"
                     r"([A-Z][A-Z0-9_]*)((?:\.\w+)*)", line)
        if fn is not None and m:
            counts[fn][m.group(1) + (m.group(2) if full else "")] += 1
    return counts


def profile_window(step, batches, n):
    """torch.profiler over ``n`` train steps: device time by kernel group
    and the device's busy share of the window's wall time. Returns the
    (ms, launches, name) rows of the device's kernels and the steps'
    sequence lengths. A warm-up step (the first batch again) runs under
    the profiler before the window and its records are dropped: a
    kernel of the first profiled step has gone unrecorded (one of a BART
    step's six online_fwd launches)."""
    from torch.profiler import ProfilerActivity, profile, schedule
    todo = [next(batches) for _ in range(n)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for batch in todo:        # the same steps unprofiled, for the wall
        step(batch)
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=n,
                                   repeat=1)) as prof:
        step(todo[0])
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        marks_ms = 0.0      # host time of the step marks inside the window
        for i, batch in enumerate(todo):
            step(batch)
            if i == n - 1:          # the window ends with the last step
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            t1 = time.perf_counter()
            prof.step()
            if i < n - 1:
                marks_ms += (time.perf_counter() - t1) * 1e3
    events = prof.key_averages()
    # User annotations (e.g. Optimizer.step) also show on the device
    # track; they have a CPU twin of the same name, kernels do not.
    cpu_names = {e.key for e in events if e.device_type.name == "CPU"}
    groups = {}
    rows = []
    for evt in events:
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        if (us <= 0 or evt.device_type.name != "CUDA"
                or evt.key in cpu_names):
            continue
        name = evt.key
        low = name.lower()
        if "onekv" in low or "online" in low:
            group = "attention kernels (port)"
        elif any(t in low for t in ("nvjet", "gemm", "xmma", "cutlass")):
            group = "matmul (cuBLAS)"
        elif "copy" in low or "memset" in low:
            group = "copies and dtype casts"
        elif "multi_tensor_apply" in low:
            group = "optimizer and grad clipping (foreach)"
        else:
            group = "other (norms, GELU, softmax, dropout, losses)"
        groups[group] = groups.get(group, 0.0) + us / 1e3
        rows.append((us / 1e3, evt.count, name))
    launches = sum(r[1] for r in rows)
    busy = sum(groups.values())
    print("profile: {} steps, L={}, device busy {:.1f} ms; wall {:.1f} ms "
          "unprofiled (idle share {:.1%}), {:.1f} ms profiled (idle share "
          "{:.1%}; its {} step marks took {:.3f} ms of host time); {} "
          "kernel launches per step".format(
              n, [b["input_ids"].shape[1] for b in todo], busy,
              plain_wall_ms, 1 - busy / plain_wall_ms, wall_ms,
              1 - busy / wall_ms, n - 1, marks_ms, launches // n),
          flush=True)
    for group, ms in sorted(groups.items(), key=lambda x: -x[1]):
        print("profile group {:48s} {:9.2f} ms {:6.1%}".format(
            group, ms, ms / busy), flush=True)
    for ms, count, name in sorted(rows, reverse=True)[:12]:
        print("profile kernel {:9.2f} ms x{:5d} {}".format(
            ms, count, name[:100]), flush=True)
    for ms, count, name in sorted(rows, reverse=True):
        if "onekv" in name or "online" in name:
            print("profile port kernel {:9.2f} ms x{:5d} {}".format(
                ms, count, name[:100]), flush=True)
    return rows, [b["input_ids"].shape[1] for b in todo]


BF16_KERNELS = ("onekv_fwd", "onekv_bwd", "online_fwd", "online_bwd_dq",
                "online_bwd_dkv")
ONLINE_KERNELS = BF16_KERNELS[2:]
# Every launch counter: the bf16 kernels' (``<wrapper>.launches``) and
# their fp32 builds' (``<wrapper>.launches_f32``, read as
# ``<wrapper>_f32``).
KERNELS = BF16_KERNELS + tuple(n + "_f32" for n in BF16_KERNELS)


def zero_launches(fa):
    for name in BF16_KERNELS:
        getattr(fa, name).launches = 0
        getattr(fa, name).launches_f32 = 0


def read_launches(fa):
    counts = {n: getattr(fa, n).launches for n in BF16_KERNELS}
    counts.update({n + "_f32": getattr(fa, n).launches_f32
                   for n in BF16_KERNELS})
    return counts


def profile_f32_step(step, batches, attentions, impl, want, label):
    """Phases 17-18 after their checks (which leave the attention modules
    dense): the modules back to ``impl``, then one train step of
    ``batches`` under profile_window, whose kernels must include ``want``
    (kernel name: launches). Prints the fp32 attention kernels' device
    time and their share of the step's device time; profile_window prints
    the idle share."""
    for attn in attentions:
        attn.attention_impl = impl
    rows, _ = profile_window(step, batches, 1)
    busy = sum(r[0] for r in rows)
    counts = {k: sum(c for _, c, n in rows if k in n) for k in want}
    ms = sum(m for m, _, n in rows if "_f32_kernel" in n)
    print("{} profiled step: fp32 attention kernels {:.2f} ms of {:.2f} ms "
          "of device time ({:.1%}); launches {}".format(
              label, ms, busy, ms / busy, counts), flush=True)
    if counts != want:
        raise AssertionError("{}: the profiled step launched {} (want {})"
                             .format(label, counts, want))


def flash_vs_dense_step(fa, model, attentions, batch, want, label,
                        **step_kw):
    """One train step with the flash path against one with the dense
    path (``attentions``: the attention modules switched), from the same
    parameters, batch and dropout seed: each with a fresh optimizer of
    learning rate 0 and no clipping, so both draw the same dropout masks,
    the parameters stay as they are and the raw gradients are left in
    place. The flash step must launch ``want`` (counter: launches) and
    nothing else; the losses must agree within F32_LOSS_RTOL and the
    global gradient norms within F32_NORM_RTOL."""
    from lddl_tpu_torch.models import make_optimizer, make_train_step
    out = {}
    for impl in ("flash", "dense"):
        for attn in attentions:
            attn.attention_impl = impl
        opt = make_optimizer(model.parameters(), learning_rate=0.0,
                             clip_norm=math.inf)
        zero_launches(fa)
        loss = float(make_train_step(model, opt, **step_kw)(batch,
                                                            seed=0)["loss"])
        launched = read_launches(fa)
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        norm = float(torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads))))
        out[impl] = (loss, norm)
        del opt, grads
        if launched != dict.fromkeys(KERNELS, 0) | (
                want if impl == "flash" else {}):
            raise AssertionError("{} {} step launched {} (want {})".format(
                label, impl, launched, want if impl == "flash" else {}))
    (f_loss, f_norm), (d_loss, d_norm) = out["flash"], out["dense"]
    rel_loss = abs(f_loss - d_loss) / abs(d_loss)
    rel_norm = abs(f_norm - d_norm) / d_norm
    print("{} flash vs dense train step (L={}): loss {!r} vs {!r} (rel "
          "{:.2e}, bar {:.0e}), gradient norm {!r} vs {!r} (rel {:.2e}, bar "
          "{:.0e})".format(label, batch["input_ids"].shape[1], f_loss,
                          d_loss, rel_loss, F32_LOSS_RTOL, f_norm, d_norm,
                          rel_norm, F32_NORM_RTOL), flush=True)
    if not (math.isfinite(f_loss) and rel_loss <= F32_LOSS_RTOL
            and rel_norm <= F32_NORM_RTOL):
        raise AssertionError("{}: the flash step disagrees with the dense "
                             "one".format(label))


def bert_path(fa, card, shared, dtype=None):
    """bert_large steps from the binned loader: phase 4 (bf16
    activations, STEPS steps as the loader draws them, a profiled window
    and flash against dense logits) or, with ``dtype`` (torch.float32),
    phase 17: the same model, loader and train step at that dtype,
    F32_STEPS_PER_BIN steps in each bin (the first a warm-up), on the
    fp32 kernels, one flash train step against one dense at L=512, then
    a profiled step at L=512. Phase 4 leaves its step ms a bin in
    ``shared`` for phase 17. Returns the launch counts of the counted
    steps."""
    from lddl_tpu_torch.loader import (get_bert_pretrain_data_loader,
                                       prefetch_to_device)
    from lddl_tpu_torch.models import (BertConfig, BertForPreTraining,
                                       make_optimizer, make_train_step)
    from lddl_tpu_torch.testing import write_balanced_shards, write_vocab

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        t0 = time.perf_counter()
        vocab = os.path.join(tmp, "vocab.txt")
        tokens = write_vocab(vocab, 30522, seed=0)
        write_balanced_shards(os.path.join(tmp, "shards"), tokens,
                              num_bins=len(BINS), bin_size=128,
                              shards_per_bin=2, samples_per_shard=64,
                              masking=True, seed=0)
        print("data: {:.1f} s for 4 bins x 2 balanced shards x 64 samples"
              .format(time.perf_counter() - t0), flush=True)
        loader = get_bert_pretrain_data_loader(
            os.path.join(tmp, "shards"), vocab_file=vocab, batch_size=16,
            fixed_seq_lengths=BINS, shuffle_buffer_size=256,
            shuffle_buffer_warmup_factor=4, base_seed=12345)

        f32 = dtype is not None
        suffix = "_f32" if f32 else ""
        label = "bert_large" + (" fp32" if f32 else "")
        torch.manual_seed(0)
        cfg = BertConfig.bert_large(attention_dropout=0.0,
                                    attention_impl="auto",
                                    **({"dtype": dtype} if f32 else {}))
        with torch.device("cuda"):
            model = BertForPreTraining(cfg)
        opt = make_optimizer(model.parameters(), learning_rate=1e-4,
                             warmup_steps=4, total_steps=100)
        step = make_train_step(model, opt)

        # bf16: the first STEPS batches; fp32: F32_STEPS_PER_BIN in each
        # bin, the batches of a bin that has them skipped.
        n_steps = F32_STEPS_PER_BIN * len(BINS) if f32 else STEPS
        zero_launches(fa)
        rows, last, it = [], {}, iter(prefetch_to_device(loader))
        try:
            for batch in it:
                l_bin = batch["input_ids"].shape[1]
                if f32 and sum(r[0] == l_bin for r in rows) == \
                        F32_STEPS_PER_BIN:
                    continue
                t0 = time.perf_counter()
                metrics = step(batch)
                loss = float(metrics["loss"])  # syncs the device
                dt = time.perf_counter() - t0
                real = int(batch["attention_mask"].sum())
                rows.append((l_bin, dt, real, loss))
                last[l_bin] = batch
                print("{}step {:2d} L={} loss={:.4f} mlm_acc={:.4f} {:.1f} "
                      "ms".format("fp32 " if f32 else "", len(rows) - 1,
                                  l_bin, loss,
                                  float(metrics["mlm_accuracy"]), dt * 1e3),
                      flush=True)
                if not math.isfinite(loss):
                    raise AssertionError("non-finite loss at step {}"
                                         .format(len(rows) - 1))
                if len(rows) == n_steps:
                    break
        finally:
            it.close()
        launches = read_launches(fa)
        if len(rows) != n_steps:
            raise AssertionError("{} steps drawn of {}".format(len(rows),
                                                               n_steps))

        kernel_steps = sum(1 for r in rows
                           if fa.single_block_serves(r[0], 64))
        if not any(r[0] == 128 for r in rows):
            raise AssertionError("the dense bin (L=128) was never drawn")
        if kernel_steps == 0:
            raise AssertionError("no kernel bin was drawn")
        want = cfg.num_layers * kernel_steps
        if launches != dict.fromkeys(KERNELS, 0) | {
                "onekv_fwd" + suffix: want, "onekv_bwd" + suffix: want}:
            raise AssertionError("launch counts {} != {} per kernel ({} "
                                 "kernel-bin steps x {} layers)".format(
                                     launches, want, kernel_steps,
                                     cfg.num_layers))
        print("launches over {} steps ({} in kernel bins): {}".format(
            len(rows), kernel_steps, launches), flush=True)

        per_bin = {}
        seen = set()
        for l_bin, dt, real, _ in rows:
            if l_bin not in seen:   # first step of a bin: warm-up
                seen.add(l_bin)
                continue
            per_bin.setdefault(l_bin, []).append((dt, real))
        for l_bin in sorted(per_bin):
            dts = [x[0] for x in per_bin[l_bin]]
            ms = 1e3 * sum(dts) / len(dts)
            toks = 16 * l_bin * len(dts) / sum(dts)
            real = sum(x[1] for x in per_bin[l_bin]) / sum(dts)
            beside = shared.get("bert_step_ms", {}).get(l_bin)
            print("{} step L={}: {:.2f} ms mean of {} steps, {:.0f} "
                  "padded tokens/s, {:.0f} real tokens/s{} ({})".format(
                      label, l_bin, ms, len(dts), toks, real,
                      "" if not f32 or beside is None else
                      "; phase 4's bf16 step {:.2f} ms, ratio {:.2f} (host "
                      "clock)".format(beside, ms / beside), card),
                  flush=True)
            if not f32:
                shared.setdefault("bert_step_ms", {})[l_bin] = ms

        if f32:
            attentions = [getattr(model, "layer_{}".format(i)).attention
                          for i in range(cfg.num_layers)]
            flash_vs_dense_step(
                fa, model, attentions, last[BINS[-1]],
                {"onekv_fwd_f32": cfg.num_layers,
                 "onekv_bwd_f32": cfg.num_layers}, label)
            it = iter(prefetch_to_device(loader))
            try:
                profile_f32_step(
                    step, (b for b in it
                           if b["input_ids"].shape[1] == BINS[-1]),
                    attentions, cfg.attention_impl,
                    dict.fromkeys(("onekv_fwd_f32_kernel",
                                   "onekv_bwd_dkv_f32_kernel",
                                   "onekv_bwd_dq_f32_kernel"),
                                  cfg.num_layers), label)
            finally:
                it.close()
            return launches

        it = iter(prefetch_to_device(loader))
        try:
            prof_rows, lengths = profile_window(step, it, PROFILE_STEPS)
        finally:
            it.close()
        want = {name: cfg.num_layers * sum(
            1 for l_bin in lengths if fa.single_block_serves(l_bin, 64))
            for name in ("onekv_fwd_kernel", "onekv_bwd_dkv_kernel",
                         "onekv_bwd_dq_kernel")}
        counts = {name: sum(c for _, c, n in prof_rows if name in n)
                  for name in want}
        print("kernels in the profiled bert window: {}".format(counts),
              flush=True)
        if counts != want:
            raise AssertionError("the profiled window launched {} (want {})"
                                 .format(counts, want))

        # The flash path against the dense path on one small batch (the
        # same weights, eval mode): the model's output agrees.
        model.eval()
        g = torch.Generator().manual_seed(1)
        ids = torch.randint(5, cfg.vocab_size, (2, 256), generator=g).cuda()
        typ = torch.zeros_like(ids)
        am = torch.ones_like(ids, dtype=torch.int32)
        am[1, 200:] = 0
        outs = {}
        for impl in ("flash", "dense"):
            for i in range(cfg.num_layers):
                getattr(model, "layer_{}".format(i)).attention \
                    .attention_impl = impl
            with torch.no_grad():
                outs[impl] = model(ids, typ, am)
        for name, a, r in zip(("mlm", "nsp"), outs["flash"], outs["dense"]):
            if a.shape != r.shape or not torch.isfinite(a).all():
                raise AssertionError("bad {} logits".format(name))
            err = rel_err(a, r)
            print("flash vs dense {} logits: rel err {:.2e}".format(name, err),
                  flush=True)
            if err > 5e-2:
                raise AssertionError("flash and dense logits disagree")
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def bart_path(fa, card, shared, num_heads=None, dtype=None):
    """bart_base denoising steps at L=1024 from the port's BART loader
    (phase 6; with ``num_heads`` phase 16: bart_base's widths with that
    many heads, whose head dim the encoder's online kernels take; with
    ``dtype`` (torch.float32) phase 18: bart_base at that dtype on the
    online kernels' fp32 builds, BART_F32_STEPS steps, then one flash
    train step against one dense and a profiled step, in place of the
    bf16 profiled step and the eval logits; with both, phase 19: phase
    18 at phase 16's widths, on the fp32 builds at D=256); returns the
    launch counts of the counted steps. Phase 6 leaves its step ms in
    ``shared`` for phases 16, 18 and 19 to print beside their own."""
    from lddl_tpu_torch.loader import (get_bart_pretrain_data_loader,
                                       prefetch_to_device)
    from lddl_tpu_torch.models import (BartConfig, BartForPreTraining,
                                       bart_batch_loss, make_optimizer,
                                       make_train_step)
    from lddl_tpu_torch.testing import write_bart_shards, write_vocab

    tmp = tempfile.mkdtemp(prefix="chip_smoke_bart_")
    try:
        t0 = time.perf_counter()
        vocab = os.path.join(tmp, "vocab.txt")
        write_vocab(vocab, 30522, seed=0)
        write_bart_shards(os.path.join(tmp, "shards"), 30522, num_shards=2,
                          samples_per_shard=64, seed=0)
        print("data: {:.1f} s for 2 balanced BART shards x 64 samples"
              .format(time.perf_counter() - t0), flush=True)
        loader = get_bart_pretrain_data_loader(
            os.path.join(tmp, "shards"), vocab_file=vocab,
            batch_size=BART_BATCH, max_seq_length=BART_L,
            fixed_seq_length=BART_L, shuffle_buffer_size=128,
            shuffle_buffer_warmup_factor=4, base_seed=12345)

        torch.manual_seed(0)
        f32 = dtype is not None
        suffix = "_f32" if f32 else ""
        n_steps = BART_F32_STEPS if f32 else BART_STEPS
        kw = {} if num_heads is None else {"num_heads": num_heads}
        if f32:
            kw["dtype"] = dtype
        cfg = BartConfig.bart_base(attention_dropout=0.0,
                                   attention_impl="auto", **kw)
        label = "bart_base" + ("" if num_heads is None else
                               " H={} (D={})".format(
                                   cfg.num_heads,
                                   cfg.hidden_size // cfg.num_heads)) + (
                                       " fp32" if f32 else "")
        with torch.device("cuda"):
            model = BartForPreTraining(cfg)
        opt = make_optimizer(model.parameters(), learning_rate=1e-4,
                             warmup_steps=2, total_steps=100)
        step = make_train_step(model, opt, batch_loss=bart_batch_loss)

        zero_launches(fa)
        rows, it = [], iter(prefetch_to_device(loader))
        try:
            for i in range(n_steps):
                batch = next(it)
                t0 = time.perf_counter()
                metrics = step(batch)
                loss = float(metrics["loss"])  # syncs the device
                dt = time.perf_counter() - t0
                enc = int(batch["attention_mask"].sum())
                rows.append((dt, enc))
                print("bart step {} L={} loss={:.4f} acc={:.4f} encoder "
                      "tokens {} {:.1f} ms".format(
                          i, batch["input_ids"].shape[1], loss,
                          float(metrics["accuracy"]), enc, dt * 1e3),
                      flush=True)
                if not math.isfinite(loss):
                    raise AssertionError("non-finite loss at step {}"
                                         .format(i))
        finally:
            it.close()
        launches = read_launches(fa)
        want = cfg.num_encoder_layers * n_steps
        if launches != dict.fromkeys(KERNELS, 0) | {
                name + suffix: want for name in ONLINE_KERNELS}:
            raise AssertionError("launch counts {} != {} per online kernel "
                                 "({} steps x {} encoder layers)".format(
                                     launches, want, n_steps,
                                     cfg.num_encoder_layers))
        print("launches over {} {} steps: {}".format(n_steps, label,
                                                    launches), flush=True)
        dts = [r[0] for r in rows[1:]]          # the first is warm-up
        ms = 1e3 * sum(dts) / len(dts)
        print("{} step L={} B={}: {:.2f} ms mean of {} steps "
              "(min {:.2f}, max {:.2f}), {:.0f} decoder tokens/s, {:.0f} "
              "real encoder tokens/s ({})".format(
                  label, BART_L, BART_BATCH, ms, len(dts), 1e3 * min(dts),
                  1e3 * max(dts), BART_BATCH * BART_L / (ms / 1e3),
                  sum(r[1] for r in rows[1:]) / sum(dts), card), flush=True)
        if num_heads is None and not f32:
            shared["bart_step_ms"] = ms
        elif "bart_step_ms" in shared:
            print("{} step {:.2f} ms beside phase 6's bart_base (bf16, "
                  "H=12, D=64) {:.2f} ms, ratio {:.2f} (host clock)".format(
                      label, ms, shared["bart_step_ms"],
                      ms / shared["bart_step_ms"]), flush=True)

        encoders = [getattr(model, "encoder_{}".format(i)).self_attention
                    for i in range(cfg.num_encoder_layers)]
        if f32:
            flash_vs_dense_step(
                fa, model, encoders, batch,
                {name + suffix: cfg.num_encoder_layers
                 for name in ONLINE_KERNELS}, label,
                batch_loss=bart_batch_loss)
            it = iter(prefetch_to_device(loader))
            try:
                profile_f32_step(
                    step, it, encoders, cfg.attention_impl,
                    {name + "_f32_kernel": cfg.num_encoder_layers
                     for name in ONLINE_KERNELS}, label)
            finally:
                it.close()
            return launches

        it = iter(prefetch_to_device(loader))
        try:
            prof_rows, _ = profile_window(step, it, 1)
            batch = next(it)
        finally:
            it.close()
        counts = {name: sum(c for _, c, n in prof_rows
                            if name + "_kernel" in n)
                  for name in ONLINE_KERNELS}
        print("kernels in a profiled bart step: {}".format(counts),
              flush=True)
        if counts != dict.fromkeys(ONLINE_KERNELS, cfg.num_encoder_layers):
            raise AssertionError("a profiled step launched {} (want {} "
                                 "each)".format(counts,
                                                cfg.num_encoder_layers))

        # The flash encoder against the dense one on a batch of the loader
        # (the same weights, eval mode): the model's output agrees.
        model.eval()
        inputs = [batch[k] for k in model.BATCH_INPUTS]
        outs = {}
        for impl in ("flash", "dense"):
            for attn in encoders:
                attn.attention_impl = impl
            with torch.no_grad():
                outs[impl] = model(*inputs)
        a, r = outs["flash"], outs["dense"]
        if a.shape != (BART_BATCH, BART_L, cfg.vocab_size) or not \
                torch.isfinite(a).all():
            raise AssertionError("bad bart logits {}".format(tuple(a.shape)))
        err = rel_err(a, r)
        print("{} flash vs dense logits: rel err {:.2e}".format(label, err),
              flush=True)
        if err > 5e-2:
            raise AssertionError("flash and dense bart logits disagree")
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def unpack(batch, l):
    """The samples of a packed batch, one per row of an unpacked batch of
    width ``l``: (spans [(row, slot, offset, length)], input_ids,
    token_type_ids, attention_mask)."""
    rows, slots = torch.nonzero(batch["next_sentence_labels"] != -1,
                                as_tuple=True)
    seg = batch["segments"]
    spans = []
    for r, s in zip(rows.tolist(), slots.tolist()):
        spans.append((r, s, int(batch["cls_positions"][r, s]),
                      int((seg[r] == s + 1).sum())))
    ids = torch.zeros((len(spans), l), dtype=batch["input_ids"].dtype,
                      device="cuda")
    typ, am = torch.zeros_like(ids), torch.zeros_like(ids)
    for i, (r, _, off, n) in enumerate(spans):
        ids[i, :n] = batch["input_ids"][r, off:off + n]
        typ[i, :n] = batch["token_type_ids"][r, off:off + n]
        am[i, :n] = 1
    return spans, ids, typ, am


def check_packed_model(fa, model, batch):
    """On one packed batch, in eval mode: the flash path against the dense
    path, and every sample's logits against the sample run alone at L_pad
    512 (both through the kernels)."""
    cfg = model.cfg
    model.eval()
    inputs = [batch[k] for k in model.BATCH_INPUTS]

    def forward(impl, *args):
        for i in range(cfg.num_layers):
            getattr(model, "layer_{}".format(i)).attention \
                .attention_impl = impl
        zero_launches(fa)
        with torch.no_grad():
            out = model(*args)
        torch.cuda.synchronize()
        return out, read_launches(fa)["onekv_fwd"]

    (mlm, nsp), flash_launches = forward("auto", *inputs)
    (mlm_d, nsp_d), dense_launches = forward("dense", *inputs)
    if (flash_launches, dense_launches) != (cfg.num_layers, 0):
        raise AssertionError("onekv_fwd launched {} times on the packed "
                             "batch and {} on the dense path".format(
                                 flash_launches, dense_launches))
    for name, a, r in (("mlm", mlm, mlm_d), ("nsp", nsp, nsp_d)):
        if a.shape != r.shape or not torch.isfinite(a).all():
            raise AssertionError("bad packed {} logits".format(name))
        err = rel_err(a, r)
        print("packed flash vs dense {} logits {}: rel err {:.2e}".format(
            name, tuple(a.shape), err), flush=True)
        if err > 5e-2:
            raise AssertionError("packed flash and dense logits disagree")
    del mlm_d, nsp_d

    spans, ids, typ, am = unpack(batch, PACK_L)
    (mlm_u, nsp_u), unpacked_launches = forward("auto", ids, typ, am)
    if unpacked_launches != cfg.num_layers:
        raise AssertionError("the unpacked samples launched onekv_fwd {} "
                             "times".format(unpacked_launches))
    got = torch.cat([mlm[r, off:off + n] for r, _, off, n in spans])
    ref = torch.cat([mlm_u[i, :n] for i, (_, _, _, n) in enumerate(spans)])
    rows = torch.tensor([sp[0] for sp in spans], device="cuda")
    slots = torch.tensor([sp[1] for sp in spans], device="cuda")
    errs = {"mlm": rel_err(got, ref), "nsp": rel_err(nsp[rows, slots], nsp_u)}
    print("packed vs unpacked, {} samples of {} rows: mlm rel err {:.2e}, "
          "nsp rel err {:.2e}".format(len(spans), PACK_ROWS, errs["mlm"],
                                      errs["nsp"]), flush=True)
    if max(errs.values()) > 5e-2:
        raise AssertionError("packed and unpacked logits disagree")
    model.train()


def check_checkpoint(model, opt, step, batch, root, note, rebuild,
                     make_step):
    """Save the train state, restore it into the model and optimizer
    ``rebuild()`` makes from another seed, then one step from each
    (``make_step(model, opt)`` for the restored one) with the same batch
    and seed: the losses and every parameter (every local shard of a
    sharded model) must be bit-identical."""
    from lddl_tpu_torch.models import restore_train_state, save_train_state
    ckpt = os.path.join(root, "ckpt")
    count = opt.step_count
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_train_state(ckpt, model, opt, count)
    t_save = time.perf_counter() - t0
    nbytes = sum(os.path.getsize(os.path.join(dirpath, f))
                 for dirpath, _, names in os.walk(ckpt) for f in names)
    fresh, fresh_opt = rebuild()

    def local(t):
        return t.to_local() if hasattr(t, "to_local") else t

    if torch.equal(local(fresh.embeddings.word_embeddings.weight),
                   local(model.embeddings.word_embeddings.weight)):
        raise AssertionError("the fresh model equals the live one")
    t0 = time.perf_counter()
    restored = restore_train_state(ckpt, fresh, fresh_opt)
    torch.cuda.synchronize()
    t_restore = time.perf_counter() - t0
    if restored != count or fresh_opt.step_count != count:
        raise AssertionError("restored step {} (schedule {}) != {}".format(
            restored, fresh_opt.step_count, count))
    m_resumed = make_step(fresh, fresh_opt)(batch, seed=0)
    m_live = step(batch, seed=0)
    loss_r, loss_l = float(m_resumed["loss"]), float(m_live["loss"])
    differ = [n for (n, a), b in zip(model.state_dict().items(),
                                     fresh.state_dict().values())
              if not torch.equal(local(a), local(b))]
    print("checkpoint ({}): {} bytes, save {:.2f} s, restore {:.2f} s; "
          "step {} resumed loss {!r}, live loss {!r}, {} of {} parameters "
          "differ".format(note, nbytes, t_save, t_restore, count, loss_r,
                          loss_l, len(differ), len(model.state_dict())),
          flush=True)
    if loss_r != loss_l or differ:
        raise AssertionError("the restored step is not bit-identical to "
                             "the live one: {}".format(differ[:5]))


def adamw(params):
    """The optimizer of the model phases."""
    from lddl_tpu_torch.models import make_optimizer
    return make_optimizer(params, learning_rate=1e-4, warmup_steps=4,
                          total_steps=100)


def packed_path(fa, card):
    """bert_large on offline-packed rows: data, a few train steps through
    the packed loader and prefetch_to_device, a profiled step, an eval
    step, the flash-vs-dense and packed-vs-unpacked logits, and a
    checkpoint roundtrip with a bit-identical resumed step. Returns the
    launch counts of the counted steps."""
    from lddl_tpu_torch.loader import (get_bert_pretrain_data_loader,
                                       prefetch_to_device)
    from lddl_tpu_torch.models import (BertConfig, BertForPreTrainingPacked,
                                       make_eval_step, make_optimizer,
                                       make_train_step)
    from lddl_tpu_torch.testing import write_packed_shards, write_vocab

    tmp = tempfile.mkdtemp(prefix="chip_smoke_packed_")
    try:
        vocab = os.path.join(tmp, "vocab.txt")
        tokens = write_vocab(vocab, 30522, seed=0)
        t0 = time.perf_counter()
        counts, stats = write_packed_shards(
            os.path.join(tmp, "shards"), tokens, num_samples=PACKED_SAMPLES,
            num_shards=2, pack_seq_length=PACK_L,
            pack_max_per_row=PACK_PER_ROW, min_tokens=8, max_tokens=512,
            masking=True, seed=0)
        print("packed data: {:.2f} s to pack {} samples of 8-512 tokens "
              "into {} rows of {} ({} shards); pad ratio {:.4f}, {:.2f} "
              "samples a row, {:.1f} samples a step of {} rows".format(
                  time.perf_counter() - t0, stats["samples"], stats["rows"],
                  PACK_L, len(counts), 1 - stats["tokens"] / stats["slots"],
                  stats["samples"] / stats["rows"],
                  PACK_ROWS * stats["samples"] / stats["rows"], PACK_ROWS),
              flush=True)
        loader = get_bert_pretrain_data_loader(
            os.path.join(tmp, "shards"), vocab_file=vocab,
            pack_seq_length=PACK_L, pack_rows=PACK_ROWS,
            shuffle_buffer_size=256, shuffle_buffer_warmup_factor=4,
            base_seed=12345)

        torch.manual_seed(0)
        cfg = BertConfig.bert_large(attention_dropout=0.0,
                                    attention_impl="auto")
        with torch.device("cuda"):
            model = BertForPreTrainingPacked(cfg)
        opt = make_optimizer(model.parameters(), learning_rate=1e-4,
                             warmup_steps=4, total_steps=100)
        step = make_train_step(model, opt)

        zero_launches(fa)
        rows, it = [], iter(prefetch_to_device(loader))
        try:
            for i in range(PACKED_STEPS):
                batch = next(it)
                if batch["input_ids"].shape != (PACK_ROWS, PACK_L):
                    raise AssertionError("packed batch of shape {}".format(
                        tuple(batch["input_ids"].shape)))
                t0 = time.perf_counter()
                metrics = step(batch, seed=0)
                loss = float(metrics["loss"])  # syncs the device
                dt = time.perf_counter() - t0
                real = int(batch["attention_mask"].sum())
                samples = int((batch["next_sentence_labels"] != -1).sum())
                rows.append((dt, real, samples))
                print("packed step {} loss={:.4f} mlm_acc={:.4f} dropped={} "
                      "real tokens {} samples {} max segment {} {:.1f} ms"
                      .format(i, loss, float(metrics["mlm_accuracy"]),
                              int(metrics["mlm_dropped_labels"]), real,
                              samples, int(batch["segments"].max()),
                              dt * 1e3), flush=True)
                if not math.isfinite(loss):
                    raise AssertionError("non-finite loss at packed step {}"
                                         .format(i))
        finally:
            it.close()
        launches = read_launches(fa)
        want = cfg.num_layers * PACKED_STEPS
        if launches != dict.fromkeys(KERNELS, 0) | {
                "onekv_fwd": want, "onekv_bwd": want}:
            raise AssertionError("packed launch counts {} != {} per "
                                 "single-block kernel ({} steps x {} "
                                 "layers)".format(launches, want,
                                                  PACKED_STEPS,
                                                  cfg.num_layers))
        print("launches over {} packed steps: {}".format(PACKED_STEPS,
                                                         launches),
              flush=True)
        timed = rows[1:]                         # the first is warm-up
        secs = sum(r[0] for r in timed)
        print("bert_large packed step L={} rows={}: {:.2f} ms mean of {} "
              "steps (min {:.2f}, max {:.2f}), {:.0f} padded tokens/s, "
              "{:.0f} real tokens/s, {:.0f} samples/s ({})".format(
                  PACK_L, PACK_ROWS, 1e3 * secs / len(timed), len(timed),
                  1e3 * min(r[0] for r in timed),
                  1e3 * max(r[0] for r in timed),
                  PACK_ROWS * PACK_L * len(timed) / secs,
                  sum(r[1] for r in timed) / secs,
                  sum(r[2] for r in timed) / secs, card), flush=True)

        it = iter(prefetch_to_device(loader))
        try:
            prof_rows, _ = profile_window(step, it, 1)
            eval_batch = next(it)
            ckpt_batch = next(it)
        finally:
            it.close()
        counts = {name: sum(c for _, c, n in prof_rows if name in n)
                  for name in ("onekv_fwd_kernel", "onekv_bwd_dkv_kernel",
                               "onekv_bwd_dq_kernel")}
        print("kernels in a profiled packed step: {}".format(counts),
              flush=True)
        if counts != dict.fromkeys(counts, cfg.num_layers):
            raise AssertionError("a profiled packed step launched {}"
                                 .format(counts))

        metrics = make_eval_step(model)(eval_batch)
        print("packed eval step: {}".format(json.dumps(
            {k: float(v) for k, v in metrics.items()})), flush=True)
        if not all(math.isfinite(float(v)) for v in metrics.values()):
            raise AssertionError("non-finite eval metrics")
        check_packed_model(fa, model, eval_batch)

        need = 3 * 4 * sum(p.numel() for p in model.parameters())
        free = shutil.disk_usage(tmp).free
        note = "bert_large, {} layers".format(cfg.num_layers)
        if free < 2 * need:
            # Not room for the full train state: bert_large widths at fewer
            # layers, two steps from a fresh model.
            layers = max(1, int(cfg.num_layers * free / (2 * need)))
            note = ("bert_large widths at {} layers: {} bytes free for a "
                    "{}-byte state".format(layers, free, need))
            del model, opt, step
            torch.manual_seed(0)
            with torch.device("cuda"):
                model = BertForPreTrainingPacked(
                    dataclasses.replace(cfg, num_layers=layers))
            opt = make_optimizer(model.parameters(), learning_rate=1e-4,
                                 warmup_steps=4, total_steps=100)
            step = make_train_step(model, opt)
            for _ in range(2):
                step(eval_batch, seed=0)
        def rebuild():
            torch.manual_seed(1)
            with torch.device("cuda"):
                fresh = BertForPreTrainingPacked(model.cfg)
            return fresh, adamw(fresh.parameters())

        check_checkpoint(model, opt, step, ckpt_batch, tmp, note, rebuild,
                         make_train_step)
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def free_port():
    import socket
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def host_profile(step, batch):
    """Where a sharded step's host time goes: one step under
    torch.profiler, CPU self time of DTensor's dispatch (the
    ``PythonSubclass`` rows), of the optimizer step and in all, beside
    the device's busy time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(batch, seed=0)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    cpu = {e.key: e for e in events if e.device_type.name == "CPU"}
    busy = sum(getattr(e, "self_device_time_total", 0) for e in events
               if e.device_type.name == "CUDA" and e.key not in cpu) / 1e3
    self_ms = sum(e.self_cpu_time_total for e in cpu.values()) / 1e3
    dispatch = cpu.get("PythonSubclass")
    opt = [e for k, e in cpu.items() if k.startswith("Optimizer.step")]
    print("host profile of a sharded step: wall {:.1f} ms, device busy "
          "{:.1f} ms; CPU self time {:.1f} ms, of it DTensor dispatch "
          "{:.1f} ms in {} calls; the optimizer step {:.1f} ms in all"
          .format(wall, busy, self_ms,
                  dispatch.self_cpu_time_total / 1e3 if dispatch else 0.0,
                  dispatch.count if dispatch else 0,
                  sum(e.cpu_time_total for e in opt) / 1e3), flush=True)
    for e in sorted(cpu.values(), key=lambda e: -e.self_cpu_time_total)[:6]:
        print("host profile op {:9.2f} ms self x{:6d} {}".format(
            e.self_cpu_time_total / 1e3, e.count, e.key[:80]), flush=True)


def differing(names, ref, got):
    """{name: max |diff|} of the tensors of ``got`` (local shards of
    DTensors) that differ from ``ref``'s."""
    out = {}
    with torch.no_grad():
        for name, a, b in zip(names, ref, got):
            b = b.to_local() if hasattr(b, "to_local") else b
            if not torch.equal(a, b):
                out[name] = float((a - b).abs().max())
    return out


def style_overhead(cfg, state, batches, make_mesh, card):
    """Host-clock sharded steps of the plan on a mesh of tp alone and of
    fsdp alone, at a world of 1, on ``batches`` (the first one warm-up):
    which style costs what of the four-axis mesh's overhead."""
    from lddl_tpu_torch.models import (create_train_state,
                                       make_sharded_train_step)
    for axes in ({"tp": 1}, {"fsdp": 1}):
        mesh = make_mesh(axes)
        model, opt = create_train_state(cfg, mesh, params=state,
                                        optimizer=adamw)
        step = make_sharded_train_step(mesh, model, opt)
        times = []
        for batch in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            float(step(batch, seed=0)["loss"])
            times.append(time.perf_counter() - t0)
        print("bert_large sharded step at world 1 on mesh {}, L={} B=16: "
              "{:.2f} ms, mean of {} steps, host clock ({})".format(
                  axes, batches[0]["input_ids"].shape[1],
                  1e3 * sum(times[1:]) / len(times[1:]), len(times) - 1,
                  card), flush=True)
        del model, opt, step


def distributed_path(fa, card):
    """The port's multi-device entry points on the card as a world of 1
    over NCCL: the process group, the communicator rule, the mesh, the
    sharded train state, the binned loader's rank rule and batch
    placement, sharded train steps against the unsharded step from the
    same weights on the same batches and seeds, a sharded eval step, a
    sharded checkpoint and the dryrun. Returns the launch counts of the
    sharded steps."""
    import torch.distributed as dist

    from lddl_tpu_torch.entry import dryrun_multichip
    from lddl_tpu_torch.loader import (get_bert_pretrain_data_loader,
                                       prefetch_to_device)
    from lddl_tpu_torch.loader.sharding import (process_dp_info,
                                                to_device_batch)
    from lddl_tpu_torch.models import (BertConfig, BertForPreTraining,
                                       create_train_state, make_eval_step,
                                       make_sharded_train_step,
                                       make_train_step)
    from lddl_tpu_torch.parallel import (LocalCommunicator,
                                         get_communicator, init_distributed,
                                         make_mesh)
    from lddl_tpu_torch.testing import write_balanced_shards, write_vocab

    for key, value in (("RANK", "0"), ("WORLD_SIZE", "1"),
                       ("LOCAL_RANK", "0"), ("MASTER_ADDR", "127.0.0.1"),
                       ("MASTER_PORT", str(free_port()))):
        os.environ.setdefault(key, value)
    device = init_distributed()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    try:
        print("distributed: backend {} world {} device {}".format(
            dist.get_backend(), dist.get_world_size(), device), flush=True)
        if dist.get_backend() != "nccl" or device != torch.device("cuda", 0):
            raise AssertionError("want nccl on cuda:0")
        comm = get_communicator()
        if not isinstance(comm, LocalCommunicator):
            raise AssertionError("a world of 1 got {}".format(comm))
        big = torch.tensor([2**31 + 7, 2**40 + 3], dtype=torch.int64,
                           device=device)
        dist.all_reduce(big)
        if big.tolist() != [2**31 + 7, 2**40 + 3]:
            raise AssertionError("int64 all_reduce gave {}".format(
                big.tolist()))
        mesh = make_mesh({"dp": 1, "fsdp": 1, "tp": 1, "sp": 1})
        dp_rank, groups = process_dp_info(mesh)
        print("mesh {}; communicator {}; int64 all_reduce exact past 2^31; "
              "dp_rank {} of {}".format(mesh, type(comm).__name__, dp_rank,
                                        groups), flush=True)

        vocab = os.path.join(tmp, "vocab.txt")
        tokens = write_vocab(vocab, 30522, seed=0)
        write_balanced_shards(os.path.join(tmp, "shards"), tokens,
                              num_bins=len(BINS), bin_size=128,
                              shards_per_bin=2, samples_per_shard=64,
                              masking=True, seed=1)
        loader = get_bert_pretrain_data_loader(
            os.path.join(tmp, "shards"), vocab_file=vocab, batch_size=16,
            fixed_seq_lengths=BINS, shuffle_buffer_size=256,
            shuffle_buffer_warmup_factor=4, base_seed=54321,
            dp_rank=dp_rank, num_dp_groups=groups)
        picked = {l_bin: [] for l_bin in DIST_BINS}
        it = iter(prefetch_to_device(loader))
        try:
            while any(len(v) < DIST_STEPS for v in picked.values()):
                batch = next(it)
                l_bin = batch["input_ids"].shape[1]
                if l_bin in picked and len(picked[l_bin]) < DIST_STEPS:
                    picked[l_bin].append(batch)
        finally:
            it.close()
        batches = [b for l_bin in DIST_BINS for b in picked[l_bin]]

        torch.manual_seed(0)
        cfg = BertConfig.bert_large(attention_dropout=0.0,
                                    attention_impl="auto")
        with torch.device("cuda"):
            plain = BertForPreTraining(cfg)
            again = BertForPreTraining(cfg)
        again.load_state_dict(plain.state_dict())
        names = [n for n, _ in plain.named_parameters()]

        plain_step = make_train_step(plain, adamw(plain.parameters()))
        again_step = make_train_step(again, adamw(again.parameters()))
        model, opt = create_train_state(cfg, mesh,
                                        params=plain.state_dict(),
                                        optimizer=adamw)
        kinds = {(type(p).__name__, str(p.device))
                 for p in model.parameters()}
        print("sharded parameters: {}".format(sorted(kinds)), flush=True)
        if kinds != {("DTensor", "cuda:0")}:
            raise AssertionError("parameters are not all DTensors on cuda:0")
        step = make_sharded_train_step(mesh, model, opt)

        zero_launches(fa)
        launches = dict.fromkeys(KERNELS, 0)
        rows = []
        for i, batch in enumerate(batches):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss_u = float(plain_step(batch, seed=0)["loss"])
            dt_u = time.perf_counter() - t0
            if i == 0:
                first = [p.grad.clone() for p in plain.parameters()]
            zero_launches(fa)
            t0 = time.perf_counter()
            metrics = step(to_device_batch(batch, mesh), seed=0)
            loss_s = float(metrics["loss"])
            dt_s = time.perf_counter() - t0
            got = read_launches(fa)
            for name in KERNELS:
                launches[name] += got[name]
            loss_a = float(again_step(batch, seed=0)["loss"])
            if i == 0:
                for what, other in (("sharded", model), ("repeat", again)):
                    grads = differing(names, first, [p.grad for p in
                                                     other.parameters()])
                    print("first step's clipped gradients, {} vs unsharded: "
                          "{} of {} differ (max |diff|): {}".format(
                              what, len(grads), len(names), grads),
                          flush=True)
                del first
            l_bin = batch["input_ids"].shape[1]
            diff = abs(loss_s - loss_u)
            rows.append((l_bin, dt_s, dt_u))
            print("sharded step {} L={} loss {!r} unsharded {!r} |diff| {:.3e}"
                  " ({}; the unsharded repeat {!r}) {:.1f} ms vs {:.1f} ms; "
                  "launches {}".format(
                      i, l_bin, loss_s, loss_u, diff,
                      "bit-identical" if loss_s == loss_u else "differ",
                      loss_a, dt_s * 1e3, dt_u * 1e3, got), flush=True)
            if not math.isfinite(loss_s) or diff > DIST_LOSS_RTOL * abs(
                    loss_u):
                raise AssertionError("sharded loss {} vs unsharded {}"
                                     .format(loss_s, loss_u))
            if got != dict.fromkeys(KERNELS, 0) | {
                    "onekv_fwd": cfg.num_layers,
                    "onekv_bwd": cfg.num_layers}:
                raise AssertionError("a sharded step launched {}".format(got))
        ref = list(plain.parameters())
        for what, other in (("sharded", model), ("repeat", again)):
            differ = differing(names, ref, list(other.parameters()))
            print("after {} steps {} of {} parameters differ between the "
                  "{} and unsharded models (max |diff|): {}".format(
                      len(batches), len(differ), len(names), what, differ),
                  flush=True)
            if what == "sharded" and max(differ.values(),
                                         default=0.0) > DIST_PARAM_ATOL:
                raise AssertionError("sharded parameters off by more than "
                                     "{}".format(DIST_PARAM_ATOL))
        del again, again_step
        for l_bin in DIST_BINS:
            timed = [r for r in rows if r[0] == l_bin][1:]   # warm-up out
            ms_s = 1e3 * sum(r[1] for r in timed) / len(timed)
            ms_u = 1e3 * sum(r[2] for r in timed) / len(timed)
            print("bert_large sharded step at world 1, L={} B=16: {:.2f} ms "
                  "vs unsharded {:.2f} ms, ratio {:.3f}, mean of {} steps "
                  "each, host clock ({})".format(
                      l_bin, ms_s, ms_u, ms_s / ms_u, len(timed), card),
                  flush=True)

        style_overhead(cfg, plain.state_dict(), batches[:DIST_STEPS],
                       make_mesh, card)
        host_profile(step, to_device_batch(batches[-1], mesh))
        metrics = make_eval_step(model, mesh=mesh)(
            to_device_batch(batches[0], mesh))
        print("sharded eval step: {}".format(json.dumps(
            {k: float(v) for k, v in metrics.items()})), flush=True)
        if not all(math.isfinite(float(v)) for v in metrics.values()):
            raise AssertionError("non-finite sharded eval metrics")
        del plain, plain_step
        need = 3 * 4 * sum(p.numel() for p in model.parameters())
        if shutil.disk_usage(tmp).free < 2 * need:
            raise AssertionError("no room for the {}-byte sharded state"
                                 .format(need))
        check_checkpoint(
            model, opt, step, to_device_batch(batches[-1], mesh), tmp,
            "sharded, bert_large, {} layers".format(cfg.num_layers),
            lambda: create_train_state(cfg, mesh, seed=1, optimizer=adamw),
            functools.partial(make_sharded_train_step, mesh))
        print("dryrun_multichip(1): {}".format(dryrun_multichip(1)),
              flush=True)
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        dist.destroy_process_group()


def descendants(root):
    """The pids of ``root`` and of every process below it."""
    parent = {}
    for pid in os.listdir("/proc"):
        if pid.isdigit():
            try:
                with open("/proc/{}/stat".format(pid)) as f:
                    parent[int(pid)] = int(
                        f.read().rsplit(")", 1)[1].split()[1])
            except (OSError, IndexError, ValueError):
                continue
    out = set()
    for pid in parent:
        p = pid
        while p in parent and p != root and p > 1:
            p = parent[p]
        if p == root:
            out.add(pid)
    return out


def maps_library(pid, name):
    """True when process ``pid`` has mapped a library named ``name``."""
    try:
        with open("/proc/{}/maps".format(pid)) as f:
            return name in f.read()
    except OSError:
        return False


def process_image(pid):
    """``(exe, cmdline, parent pid)`` of process ``pid``, or None once it
    is gone."""
    try:
        with open("/proc/{}/cmdline".format(pid), "rb") as f:
            cmdline = f.read()
        with open("/proc/{}/stat".format(pid)) as f:
            ppid = int(f.read().rsplit(")", 1)[1].split()[1])
        return os.readlink("/proc/{}/exe".format(pid)), cmdline, ppid
    except (OSError, IndexError, ValueError):
        return None


def not_yet_execed(pid):
    """True while ``pid`` still runs its parent's image: a child between
    its fork and its exec shows its parent's maps (libcuda included
    where the parent imported torch), though it opens nothing. Read
    before the maps: once this is False, the maps read after it are the
    child's own."""
    mine = process_image(pid)
    if mine is None:
        return True
    parent = process_image(mine[2])
    return parent is not None and mine[:2] == parent[:2]


class DeviceWatch:
    """Polls every 0.25 s while a command runs: the device memory in use
    (``torch.cuda.mem_get_info``, the most seen beyond what was in use
    at the start) and the command's processes that have mapped the CUDA
    driver library (``/proc/<pid>/maps``), i.e. that opened a CUDA
    context. One poll that sees libcuda mapped counts a process, unless
    it has not exec'd yet (``not_yet_execed``): a process that imports
    torch maps libcuda on a CUDA build (a CLI under ``--multihost``, a
    preprocess with ``--engine torch``, this script), and a worker it
    spawns shows its maps for the few ms before its exec.
    ``chip_cuda_watch.py`` holds this rule to a 2 ms poll of the BART
    CLI."""

    def __init__(self, root_pid):
        import threading
        self.root, self.cuda_pids, self.procs, self.used = root_pid, set(), \
            set(), 0
        free, total = torch.cuda.mem_get_info()
        self.base = total - free
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.wait(0.25):
            free, total = torch.cuda.mem_get_info()
            self.used = max(self.used, total - free)
            pids = descendants(self.root)
            self.procs |= pids
            self.cuda_pids |= {pid for pid in pids - self.cuda_pids
                               if not not_yet_execed(pid)
                               and maps_library(pid, "libcuda.so")}

    def stop(self):
        self._stop.set()
        self._thread.join()
        return {"cuda_procs": len(self.cuda_pids - {self.root}),
                "procs": len(self.procs - {self.root}),
                "held_mib": (self.used - self.base) / 2**20}


def preprocess_cmd(corpus, vocab, out, engine, workers):
    """The port's BERT preprocess CLI at phase 8's setting."""
    return [sys.executable, "-m",
            "lddl_tpu_torch.cli.preprocess_bert_pretrain",
            "--wikipedia", corpus, "--sink", out, "--vocab-file", vocab,
            "--target-seq-length", str(DATA_TARGET), "--bin-size",
            str(DATA_BIN), "--masking", "--duplicate-factor", "5",
            "--sample-ratio", "0.9", "--seed", "12345", "--num-blocks", "64",
            "--schema-version", "2", "--local-workers", str(workers),
            "--engine", engine] + (["--device", "cuda"] if engine == "torch"
                                   else [])


def preprocess_cli(corpus, vocab, out, engine, workers, card):
    """The port's preprocess CLI in a process of its own (its spawned
    workers then import the CLI module, not this script); returns
    (seconds, device watch)."""
    return run_cli(preprocess_cmd(corpus, vocab, out, engine, workers),
                   "preprocess --engine " + engine)


def watched(cmd, timeout=900, env=None):
    """``cmd`` in a process of its own from the repository root (first
    on ``PYTHONPATH``; ``env`` adds variables), watched by a
    ``DeviceWatch``: (seconds, exit code, stdout, stderr, what the watch
    saw, the watch)."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, **(env or {}), PYTHONPATH=os.pathsep.join(
        [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=root,
                            env=env)
    watch = DeviceWatch(proc.pid)
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
        seen = watch.stop()
    return (time.perf_counter() - t0, proc.returncode, stdout, stderr,
            seen, watch)


def run_cli(cmd, label):
    """One of the port's CLIs in a process of its own, watched by a
    ``DeviceWatch``; returns (seconds, what the watch saw)."""
    secs, rc, stdout, stderr, seen, _ = watched(cmd)
    for line in stdout.splitlines()[-4:]:
        print("{}: {}".format(label, line), flush=True)
    if rc != 0:
        raise AssertionError("{} failed ({}):\n{}".format(
            label, rc, stderr[-4000:]))
    return secs, seen


def shard_tables(out):
    import pyarrow.parquet as pq
    names = sorted(n for n in os.listdir(out) if ".parquet" in n)
    return {n: pq.read_table(os.path.join(out, n)) for n in names}


def unmasked_ids(table):
    """The [CLS] A [SEP] B [SEP] id sequences of a masked shard with every
    label put back at its position, flat: what the masks were drawn on."""
    import numpy as np
    from lddl_tpu_torch.preprocess.arrowcols import concat_aranges

    def flat(name):
        col = table.column(name).combine_chunks()
        offs = col.offsets.to_numpy()
        return (col.values.to_numpy()[offs[0]:offs[-1]],
                np.diff(offs).astype(np.int64))

    a, a_lens = flat("A_ids")
    b, b_lens = flat("B_ids")
    pos, p_lens = flat("masked_lm_positions_ids")
    lab, _ = flat("masked_lm_label_ids")
    lens = a_lens + b_lens + 3
    start = np.cumsum(lens) - lens
    seq = np.full(int(lens.sum()), -1, dtype=np.int64)
    seq[np.repeat(start + 1, a_lens) + concat_aranges(a_lens)] = a
    seq[np.repeat(start + 2 + a_lens, b_lens) + concat_aranges(b_lens)] = b
    seq[np.repeat(start, p_lens) + pos] = lab
    return seq, p_lens, lens


def mask_invariants(what, ids, cand, num, out, sel, mask_id, groups=None):
    """The maskers' invariants on [N, L] numpy arrays: rows take
    min(num, candidates) positions (at most num for whole words), only
    candidates, unselected positions unchanged, whole words atomic, and
    the 80/10/10 split within 6 standard deviations."""
    import numpy as np
    if (sel & ~cand).any():
        raise AssertionError("{}: a non-candidate was selected".format(what))
    if (out[~sel] != ids[~sel]).any():
        raise AssertionError("{}: an unselected position changed"
                             .format(what))
    taken = sel.sum(1)
    if groups is None:
        want = np.minimum(num, cand.sum(1))
        if (taken != want).any():
            raise AssertionError("{}: per-row counts differ".format(what))
    else:
        if (taken > num).any() or taken.sum() < 0.9 * num.sum():
            raise AssertionError("{}: per-row counts {} vs budgets {}"
                                 .format(what, taken.sum(), num.sum()))
        cont = groups
        if (sel[:, 1:][cont[:, 1:]] != sel[:, :-1][cont[:, 1:]]).any():
            raise AssertionError("{}: a whole word was split".format(what))
    n = int(sel.sum())
    frac = {"mask": float((out[sel] == mask_id).sum()) / n,
            "kept": float((out[sel] == ids[sel]).sum()) / n}
    frac["random"] = 1 - frac["mask"] - frac["kept"]
    for key, p in (("mask", 0.8), ("kept", 0.1), ("random", 0.1)):
        if abs(frac[key] - p) > 6 * math.sqrt(p * (1 - p) / n):
            raise AssertionError("{}: {} share {:.4f} over {} selections"
                                 .format(what, key, frac[key], n))
    return n, frac


def check_maskers(tok_info, card):
    """The torch maskers on the card against the same maskers on the CPU
    at MASK_ROWS x MASK_WIDTH: masks and selections bit-identical, the
    invariants held on both; device times of the card's."""
    import numpy as np
    from lddl_tpu_torch.ops import masking
    g = np.random.default_rng(5)
    n, w, vocab = MASK_ROWS, MASK_WIDTH, tok_info.vocab_size
    lens = g.integers(8, w + 1, n)
    a_lens = (g.random(n) * (lens - 3)).astype(np.int64).clip(1)
    ids = g.integers(5, vocab, (n, w)).astype(np.int32)
    cand = np.arange(w)[None] < lens[:, None]
    cand[:, 0] = False
    cand[np.arange(n), a_lens + 1] = False
    cand[np.arange(n), lens - 1] = False
    num = masking.plan_num_to_predict(lens, 0.15, 77)
    is_sub = tok_info.is_subword
    cont = np.zeros_like(cand)
    cont[:, 1:] = cand[:, 1:] & cand[:, :-1] & is_sub[ids[:, 1:]]
    for wwm in (False, True):
        name = "whole-word" if wwm else "token"
        make = (functools.partial(masking.make_torch_whole_word_masker,
                                  tok_info.mask_id, vocab, is_sub)
                if wwm else functools.partial(masking.make_torch_masker,
                                              tok_info.mask_id, vocab))
        card_run, cpu_run = make(device="cuda"), make(device="cpu")
        got = card_run(ids, cand, num, 12345)
        ref = cpu_run(ids, cand, num, 12345)
        for label, x, y in zip(("masks", "selections"), got, ref):
            if not np.array_equal(x, y):
                raise AssertionError("{} masker: card and CPU {} differ in "
                                     "{} places".format(name, label,
                                                        int((x != y).sum())))
        for where, (out, sel) in (("card", got), ("cpu", ref)):
            k, frac = mask_invariants(
                "{} masker on the {}".format(name, where), ids, cand, num,
                out, sel, tok_info.mask_id, cont if wwm else None)
        fn = (masking.mask_whole_word_batch_torch if wwm
              else masking.mask_batch_torch)
        extra = ({"is_subword": torch.as_tensor(is_sub, device="cuda")}
                 if wwm else {})
        ids_t = torch.as_tensor(ids, device="cuda")
        cand_t = torch.as_tensor(cand, device="cuda")
        num_t = torch.as_tensor(num, device="cuda")
        ms = cuda_time_ms(lambda: fn(ids_t, cand_t, num_t, 12345,
                                     tok_info.mask_id, vocab, **extra),
                          iters=5, warmup=1)
        t0 = time.perf_counter()
        card_run(ids, cand, num, 12345)
        host_ms = 1e3 * (time.perf_counter() - t0)
        print("{} masker {}x{}: card == cpu bit for bit; {} selections, "
              "shares mask {:.4f} kept {:.4f} random {:.4f}; {:.3f} ms "
              "event-timed on the card, {:.2f} ms with the host copies "
              "({})".format(
                  name, n, w, k, frac["mask"], frac["kept"], frac["random"],
                  ms, host_ms, card), flush=True)


def time_bucket_masking(root, tok_info, card):
    """One bucket's static masking as the preprocess runs it: block 0's
    documents -> instances (native) -> apply_static_masking with the
    numpy engine (the native Philox replay, at the workers' native thread
    budget) and with the torch engine on the card."""
    import numpy as np
    from lddl_tpu_torch.preprocess.bert import (
        BertPretrainConfig, apply_static_masking, instances_from_texts)
    from lddl_tpu_torch.preprocess.readers import (
        discover_source_files, plan_blocks, read_documents)
    blocks = plan_blocks(discover_source_files({"w": root}), 64)
    texts = [t for _, t in read_documents(blocks[0], 0.9, 12345)]
    times = {}
    for engine in ("numpy", "torch", "torch", "numpy"):
        cfg = BertPretrainConfig(max_seq_length=DATA_TARGET, masking=True,
                                 engine=engine, device="cuda")
        batch = instances_from_texts(texts, tok_info, cfg, 12345, 0)
        t0 = time.perf_counter()
        masked, _, ids, _, _ = apply_static_masking(batch, cfg, tok_info,
                                                    12345, (0x3A5C, 0))
        times.setdefault(engine, []).append(time.perf_counter() - t0)
    if len(batch) < BUCKET_MIN_ROWS or ids.shape[1] != DATA_TARGET:
        raise AssertionError("bucket of {} rows x {}".format(len(batch),
                                                             ids.shape[1]))
    print("bucket masking, {} rows x {} (native threads {}): numpy engine "
          "{:.2f} ms, torch engine on the card {:.2f} ms (means of 2 "
          "turns; {})".format(
              len(batch), ids.shape[1],
              os.environ.get("LDDL_TPU_NATIVE_THREADS", "1"),
              1e3 * np.mean(times["numpy"]), 1e3 * np.mean(times["torch"]),
              card), flush=True)


def data_path(fa, card):
    """The offline BERT data path on the card: corpus -> preprocess
    (torch engine on the card, then numpy) -> balance -> loader ->
    bert_large steps. Returns the launch counts of the counted steps."""
    import unicodedata

    import numpy as np
    from lddl_tpu_torch import native
    from lddl_tpu_torch.balance import balance_shards
    from lddl_tpu_torch.loader import (get_bert_pretrain_data_loader,
                                       prefetch_to_device)
    from lddl_tpu_torch.models import (BertConfig, BertForPreTraining,
                                       make_optimizer, make_train_step)
    from lddl_tpu_torch.native import build as native_build
    from lddl_tpu_torch.native.gen_tables import header_calibration
    from lddl_tpu_torch.ops.masking import plan_num_to_predict
    from lddl_tpu_torch.preprocess import get_tokenizer
    from lddl_tpu_torch.preprocess.bert import TokenizerInfo
    from lddl_tpu_torch.testing import write_text_corpus, write_vocab
    from lddl_tpu_torch.utils.cpus import usable_cpu_count
    from lddl_tpu_torch.utils.fs import read_num_samples_cache

    tag = header_calibration(native_build.TABLES)
    want = "unicodedata=" + unicodedata.unidata_version
    if want not in tag.split(";"):
        raise AssertionError("unicode_tables.h is calibrated for {} but "
                             "this Python has {}".format(tag, want))
    t0 = time.perf_counter()
    native._load()
    print("native engine: built and loaded in {:.1f} s; tables {}".format(
        time.perf_counter() - t0, tag), flush=True)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_data_")
    try:
        vocab = os.path.join(tmp, "vocab.txt")
        tokens = write_vocab(vocab, 30522, seed=0)
        t0 = time.perf_counter()
        nbytes = write_text_corpus(tmp, tokens, DATA_CORPUS_BYTES,
                                   num_files=DATA_FILES, seed=0)
        print("corpus: {} bytes in {} files in {:.1f} s".format(
            nbytes, DATA_FILES, time.perf_counter() - t0), flush=True)
        tok_info = TokenizerInfo(get_tokenizer(vocab))
        check_maskers(tok_info, card)

        workers = min(16, usable_cpu_count())
        outs, runs = {}, {}
        for engine in ("torch", "numpy"):
            outs[engine] = os.path.join(tmp, "pre_" + engine)
            secs, seen = preprocess_cli(tmp, vocab, outs[engine], engine,
                                        workers, card)
            runs[engine] = secs
            print("preprocess --engine {}: {:.1f} s for {} bytes, {:.2f} "
                  "MB/s, {} workers; {} of the run's {} processes opened a "
                  "CUDA context, device memory held beyond this process's "
                  "at most {:.0f} MiB ({})".format(
                      engine, secs, nbytes, nbytes / 1e6 / secs, workers,
                      seen["cuda_procs"], seen["procs"], seen["held_mib"],
                      card), flush=True)
            if (engine == "torch") != (seen["cuda_procs"] > 0):
                raise AssertionError("--engine {}: {} processes opened a "
                                     "CUDA context".format(
                                         engine, seen["cuda_procs"]))
        t0 = time.perf_counter()
        tables = {e: shard_tables(outs[e]) for e in outs}
        n_shards = len(tables["numpy"])
        if list(tables["torch"]) != list(tables["numpy"]):
            raise AssertionError("the engines wrote different shard names")
        per_bin, rows_masked = {}, 0
        for name, t in tables["torch"].items():
            r = tables["numpy"][name]
            if t.num_rows != r.num_rows or t.schema != r.schema:
                raise AssertionError("{}: rows or schema differ".format(name))
            for col in t.column_names:
                if col not in MASKED_COLUMNS and not t.column(col).equals(
                        r.column(col)):
                    raise AssertionError("{}: column {} differs".format(
                        name, col))
            seq_t, n_t, lens = unmasked_ids(t)
            seq_r, _, _ = unmasked_ids(r)
            if not np.array_equal(seq_t, seq_r):
                raise AssertionError("{}: the unmasked sequences differ"
                                     .format(name))
            if not np.array_equal(n_t, plan_num_to_predict(lens, 0.15, 77)):
                raise AssertionError("{}: masked counts differ from the plan"
                                     .format(name))
            rows_masked += int(n_t.sum())
            b = int(name.rsplit("_", 1)[1])
            per_bin[b] = per_bin.get(b, 0) + t.num_rows
        del tables
        print("engines agree: {} shards, every unmasked column and every "
              "unmasked sequence equal, {} masked positions at the planned "
              "counts ({:.1f} s)".format(n_shards, rows_masked,
                                         time.perf_counter() - t0),
              flush=True)
        print("instances per bin: {}".format(json.dumps(
            {str(DATA_BINS[b]): n for b, n in sorted(per_bin.items())})),
            flush=True)
        shutil.rmtree(outs["numpy"])
        time_bucket_masking(tmp, tok_info, card)

        bal = os.path.join(tmp, "balanced")
        t0 = time.perf_counter()
        counts = balance_shards(outs["torch"], bal, DATA_SHARDS)
        secs = time.perf_counter() - t0
        for b in per_bin:
            got = [n for k, n in counts.items()
                   if k.endswith("_{}".format(b))]
            if (len(got) != DATA_SHARDS or sum(got) != per_bin[b]
                    or max(got) - min(got) > 1):
                raise AssertionError("bin {}: {} shards, {} rows, spread "
                                     "{}".format(b, len(got), sum(got),
                                                 max(got) - min(got)))
        for name in (".num_samples.json", ".manifest.json"):
            if not os.path.isfile(os.path.join(bal, name)):
                raise AssertionError("balance wrote no " + name)
        if read_num_samples_cache(bal) != counts:
            raise AssertionError(".num_samples.json disagrees")
        print("balance: {} shards ({} a bin) in {:.1f} s ({})".format(
            len(counts), DATA_SHARDS, secs, card), flush=True)
        shutil.rmtree(outs["torch"])

        def loader():
            return get_bert_pretrain_data_loader(
                bal, vocab_file=vocab, batch_size=16,
                fixed_seq_lengths=DATA_BINS, base_seed=12345)

        def loader_alone(label):
            it = iter(loader())
            t0 = time.perf_counter()
            next(it)
            first = time.perf_counter() - t0
            padded = real = 0
            t0 = time.perf_counter()
            for _ in range(DATA_LOADER_BATCHES):
                batch = next(it)
                padded += int(np.prod(batch["input_ids"].shape))
                real += int(batch["attention_mask"].sum())
            secs = time.perf_counter() - t0
            it.close()
            print("loader alone{}: first batch {:.2f} s, then {} batches of "
                  "16 in {:.2f} s: {:.1f} batches/s, {:.0f} padded "
                  "tokens/s, {:.0f} real tokens/s ({})".format(
                      label, first, DATA_LOADER_BATCHES, secs,
                      DATA_LOADER_BATCHES / secs, padded / secs,
                      real / secs, card), flush=True)
            return DATA_LOADER_BATCHES / secs, padded / secs

        alone = loader_alone("")
        # The shard read-ahead (default) against synchronous reads, in
        # turns: sync, default, sync.
        sync = {"LDDL_TPU_LOADER_PREFETCH_SHARDS": "0",
                "LDDL_TPU_LOADER_CACHE_BYTES": "0"}
        for label in ("sync", "default", "sync"):
            if label == "sync":
                os.environ.update(sync)
            try:
                loader_alone(", shard reads {}".format(label))
            finally:
                for k in sync:
                    os.environ.pop(k, None)

        torch.manual_seed(0)
        cfg = BertConfig.bert_large(attention_dropout=0.0,
                                    attention_impl="auto")
        with torch.device("cuda"):
            model = BertForPreTraining(cfg)
        opt = make_optimizer(model.parameters(), learning_rate=1e-4,
                             warmup_steps=4, total_steps=100)
        step = make_train_step(model, opt)
        steps = {}
        zero_launches(fa)
        it = iter(prefetch_to_device(loader()))
        try:
            for _ in range(DATA_MAX_BATCHES):
                batch = next(it)
                l_bin = batch["input_ids"].shape[1]
                if steps.get(l_bin, 0) >= DATA_STEPS_PER_BIN:
                    continue
                t0 = time.perf_counter()
                metrics = step(batch, seed=0)
                loss = float(metrics["loss"])  # syncs the device
                dt = time.perf_counter() - t0
                steps[l_bin] = steps.get(l_bin, 0) + 1
                print("data step L={} loss={:.4f} mlm_acc={:.4f} {:.1f} ms "
                      "({})".format(l_bin, loss,
                                    float(metrics["mlm_accuracy"]),
                                    dt * 1e3, card), flush=True)
                if not math.isfinite(loss):
                    raise AssertionError("non-finite loss at L={}".format(
                        l_bin))
                if len(steps) == len(DATA_BINS) and min(
                        steps.values()) >= DATA_STEPS_PER_BIN:
                    break
        finally:
            it.close()
        launches = read_launches(fa)
        kernel_steps = sum(n for l_bin, n in steps.items()
                           if fa.single_block_serves(l_bin, 64))
        want = cfg.num_layers * kernel_steps
        if not kernel_steps or launches != dict.fromkeys(KERNELS, 0) | {
                "onekv_fwd": want, "onekv_bwd": want}:
            raise AssertionError("data-path launch counts {} != {} per "
                                 "single-block kernel ({} steps)".format(
                                     launches, want, steps))
        print("bins reached {} (steps a bin); launches: {}".format(
            json.dumps({str(k): v for k, v in sorted(steps.items())}),
            launches), flush=True)
        return launches, loader_path(fa, card, tmp, bal, vocab, tokens,
                                     step, cfg, alone)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def batch_hashes(batches):
    """SHA-256 of each batch's arrays, keys in order."""
    out = []
    for batch in batches:
        h = hashlib.sha256()
        for key in sorted(batch):
            h.update(key.encode())
            h.update(batch[key].tobytes())
        out.append(h.hexdigest())
    return out


def runtime_loader(bal, vocab, mode, **kw):
    """Phase 8's binned loader with LOADER_WORKERS workers a bin in
    ``mode``; raises if process mode fell back to threads."""
    from lddl_tpu_torch.loader import get_bert_pretrain_data_loader
    loader = get_bert_pretrain_data_loader(
        bal, vocab_file=vocab, batch_size=16, fixed_seq_lengths=DATA_BINS,
        base_seed=12345, num_workers=LOADER_WORKERS, worker_mode=mode, **kw)
    modes = {dl._worker_mode for dl in loader._dataloaders}
    if modes != {mode}:
        raise AssertionError("worker_mode {} ran as {}".format(mode, modes))
    return loader


def worker_pids(loader):
    return [p.pid for dl in loader._dataloaders for p in (dl._procs or ())]


def worker_stage_seconds(metrics_dir, pids):
    """{stage: seconds} summed over the per-pid exports of ``pids``."""
    from lddl_tpu_torch.observability import attribution
    out = {}
    for pid in pids:
        path = os.path.join(metrics_dir, "metrics-rank0-pid{}.jsonl".format(
            pid))
        if not os.path.isfile(path):
            continue
        with open(path) as f:
            last = json.loads(f.read().splitlines()[-1])
        values = last["metrics"].get(attribution.STAGE_METRIC, {}).get(
            "values", {})
        for label, v in values.items():
            stage = label.partition("=")[2]
            out[stage] = out.get(stage, 0.0) + v
    return out


def cuda_holders():
    """(processes below this one, those that mapped the CUDA driver; a
    child not yet exec'd is not counted, as in ``DeviceWatch``)."""
    procs = descendants(os.getpid())
    return procs, sorted(p for p in procs if not not_yet_execed(p)
                         and maps_library(p, "libcuda.so"))


class Continue:
    """A loader whose ``iter()`` continues an epoch already under way, so
    that ``prefetch_to_device`` draws from a running iterator instead of
    starting an epoch (which would tear the process pools down). Closing
    what ``iter()`` gives leaves the running iterator open."""

    def __init__(self, it, n):
        self._it, self._n = it, n

    def __iter__(self):
        for batch in self._it:
            yield batch

    def __len__(self):
        return self._n


def kill_target(bins, n_workers, worker, nth):
    """The bin whose ``worker`` dies at its ``nth`` batch in the first
    batches ``bins`` (their lengths, in draw order): the bin with the most
    draws. The death shows when the consumer asks for the worker's
    ``nth`` batch, its bin's batch number (nth - 1) * n_workers + worker
    (counting from 0), which must lie within the draws."""
    counts = {}
    for l in bins:
        counts[l] = counts.get(l, 0) + 1
    target = max(counts, key=counts.get)
    need = (nth - 1) * n_workers + worker + 1
    if counts[target] < need:
        raise AssertionError("bin {} has {} of the first {} batches; the "
                             "kill needs {}".format(target, counts[target],
                                                    len(bins), need))
    return target


def steps_under_loader(fa, cfg, step, it, n, mode, card):
    """``n`` bert_large steps (after LOADER_WARM_STEPS) from the prefetcher
    ``it``, each ending in a device sync; returns the launch counts.
    Prints step ms, batches/s consumed and the attribution of the
    counted steps' window."""
    from lddl_tpu_torch.observability import attribution
    zero_launches(fa)
    times, losses, bins = [], [], []
    for i in range(LOADER_WARM_STEPS + n):
        if i == LOADER_WARM_STEPS:
            base = attribution.stage_seconds()
            t_start = time.perf_counter()
        batch = next(it)
        t0 = time.perf_counter()
        loss = float(step(batch, seed=0)["loss"])  # syncs the device
        if i >= LOADER_WARM_STEPS:
            times.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        bins.append(batch["input_ids"].shape[1])
    rate = n / (time.perf_counter() - t_start)
    stages = attribution.stage_seconds()
    launches = read_launches(fa)
    want = cfg.num_layers * sum(fa.single_block_serves(l, 64) for l in bins)
    if launches != dict.fromkeys(KERNELS, 0) | {"onekv_fwd": want,
                                                "onekv_bwd": want}:
        raise AssertionError("{} workers: launches {} != {} per "
                             "single-block kernel".format(mode, launches,
                                                          want))
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError("{} workers: non-finite loss".format(mode))
    window = {k: v - base.get(k, 0.0) for k, v in stages.items()}
    print("loader under bert_large, {} workers: step {:.2f} ms mean "
          "({:.2f}-{:.2f}) of {} steps after {}, {:.2f} batches/s consumed, "
          "bins {}, losses {:.4f}..{:.4f} ({})".format(
              mode, sum(times) / len(times), min(times), max(times), n,
              LOADER_WARM_STEPS, rate, sorted(set(bins)), min(losses),
              max(losses), card), flush=True)
    print(attribution.format_report(
        attribution.from_stage_seconds(window), indent="  "), flush=True)
    print("  stage seconds over the {} counted steps ({} batches): {}".format(
        n, n, json.dumps({k: round(window.get(k, 0.0), 6)
                          for k in LOADER_STAGES})), flush=True)
    return launches


def loader_path(fa, card, tmp, bal, vocab, tokens, step, cfg, alone):
    """Phase 9, the loader's runtime under load, with telemetry on:
    the same batches from thread workers, process workers and a
    killed-and-replayed process worker; startup verification of a
    truncated shard; bert_large steps continuing the thread and the
    process loaders' epochs (step ms, attribution, CUDA contexts, kernel
    launches); the process loader alone. Returns the launch counts of
    the counted steps."""
    import numpy as np
    from lddl_tpu_torch.loader import (get_bert_pretrain_data_loader,
                                       prefetch_to_device)
    from lddl_tpu_torch.resilience import integrity
    from lddl_tpu_torch.testing import write_balanced_shards

    metrics_dir = os.path.join(tmp, "metrics")
    os.environ["LDDL_TPU_METRICS_DIR"] = metrics_dir
    loaders = {}
    try:
        # 1. identity: thread, process, process with worker 1 killed once
        # (its pool alone armed, in the bin with the most early draws).
        # Every bin's pool is started up front, all at once: a bin's pool
        # otherwise spawns at its first draw, one after another.
        its, runs = {}, {}
        flag = os.path.join(tmp, "kill.flag")
        for name in ("thread", "process", "process+kill"):
            mode = name.split("+")[0]
            loader = loaders[name] = runtime_loader(bal, vocab, mode)
            t0 = time.perf_counter()
            if name == "process+kill":
                target = kill_target(runs["thread"][1], LOADER_WORKERS, 1, 5)
                dl = loader._dataloaders[DATA_BINS.index(target)]
                os.environ["LDDL_TPU_FAULTS"] = LOADER_KILL.format(flag)
                try:
                    dl._ensure_worker_pool()   # spawns with the fault armed
                finally:
                    os.environ.pop("LDDL_TPU_FAULTS")
            if mode == "process":
                for dl in loader._dataloaders:
                    dl._ensure_worker_pool()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                it = its[name] = iter(loader)
                batches = [next(it)]
                first = time.perf_counter() - t0
                batches += [next(it) for _ in range(LOADER_ID_BATCHES - 1)]
            restarts = sum("died" in str(w.message) for w in caught)
            qb = sum(dl.queue_bytes for dl in loader._dataloaders)
            qn = sum(dl.queue_batches for dl in loader._dataloaders)
            runs[name] = (batch_hashes(batches),
                          [b["input_ids"].shape[1] for b in batches])
            print("loader identity {}: first batch {:.2f} s (spawn "
                  "included), {} batches in {:.2f} s, {} restart(s), queue "
                  "{} bytes / {} batches = "
                  "{:.0f} bytes a batch ({})".format(
                      name, first, len(batches), time.perf_counter() - t0,
                      restarts, qb, qn, qb / max(qn, 1), card), flush=True)
            if restarts != (1 if name == "process+kill" else 0):
                raise AssertionError("{}: {} worker restarts".format(
                    name, restarts))
        if not os.path.exists(flag):
            raise AssertionError("the worker kill never fired")
        if not (runs["thread"][0] == runs["process"][0]
                == runs["process+kill"][0]):
            raise AssertionError("batch hashes differ across worker modes")
        t0 = time.perf_counter()
        its.pop("process+kill").close()
        killed = loaders.pop("process+kill")
        t1 = time.perf_counter()
        alive = [p for p in worker_pids(killed) if os.path.exists(
            "/proc/{}".format(p))]
        killed.shutdown_workers()
        print("loader identity: the killed run's iterator closed in {:.2f} "
              "s ({} of its workers still there), its loader shut down in "
              "{:.2f} s".format(t1 - t0, len(alive),
                                time.perf_counter() - t1), flush=True)
        print("loader identity: the {} batch hashes equal across thread, "
              "process and killed-worker runs (the kill in bin {})".format(
                  LOADER_ID_BATCHES, target), flush=True)

        # 2. startup verification of a truncated shard.
        vdir = os.path.join(tmp, "verify")
        write_balanced_shards(vdir, tokens, num_bins=2, shards_per_bin=2,
                              samples_per_shard=64, seed=9)
        integrity.build_manifest(vdir)
        victim = os.path.join(vdir, "shard-1.parquet_0")
        with open(victim, "r+b") as f:
            f.truncate(os.path.getsize(victim) // 2)
        try:
            get_bert_pretrain_data_loader(vdir, vocab_file=vocab,
                                          batch_size=16)
        except integrity.ShardIntegrityError as e:
            if "shard-1.parquet_0" not in str(e):
                raise AssertionError("the refusal does not name the shard: "
                                     "{}".format(e)) from e
        else:
            raise AssertionError("on_corrupt='fail' loaded a truncated "
                                 "shard")
        logs = os.path.join(tmp, "verify_logs")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            loader = get_bert_pretrain_data_loader(
                vdir, vocab_file=vocab, batch_size=16,
                on_corrupt="quarantine", log_dir=logs)
        files = [f.path for dl in loader._dataloaders
                 for f in dl.dataset._files]
        served = sum(len(b["input_ids"]) for b in loader)
        with open(os.path.join(logs, "rank-rank0-worker0.log")) as f:
            logged = f.read()
        if (victim in files or len(files) != 3 or served != 3 * 64
                or not any(victim in str(w.message) for w in caught)
                or victim not in logged):
            raise AssertionError("quarantine: files {}, {} samples served, "
                                 "warned/logged {}/{}".format(
                                     files, served, len(caught),
                                     victim in logged))
        print("startup verification: on_corrupt='fail' refused the "
              "truncated shard by name; 'quarantine' excluded exactly it, "
              "logged it and served the {} samples of the 3 "
              "survivors".format(served), flush=True)

        # 3. bert_large under the loaders, continuing their epochs.
        total = dict.fromkeys(KERNELS, 0)
        for mode in ("thread", "process"):
            it = iter(prefetch_to_device(Continue(its[mode], LOADER_STEPS),
                                         depth=2))
            try:
                launches = steps_under_loader(fa, cfg, step, it,
                                              LOADER_STEPS, mode, card)
                procs, holders = cuda_holders()
                pids = worker_pids(loaders[mode])
                torch_pids = [p for p in pids
                              if maps_library(p, "libtorch")]
                smi = subprocess.run(
                    ["nvidia-smi", "--query-compute-apps=pid",
                     "--format=csv,noheader"], capture_output=True,
                    text=True, timeout=60).stdout.split()
            finally:
                it.close()
            print("  processes holding a CUDA context: {} of {} (this one "
                  "is {}; {} loader workers, {} of them with torch mapped); "
                  "nvidia-smi compute apps: {}; launches {}".format(
                      holders, len(procs), os.getpid(), len(pids),
                      len(torch_pids), smi or "none listed", launches),
                  flush=True)
            if holders != [os.getpid()] or torch_pids:
                raise AssertionError("CUDA contexts in {}, torch in {} "
                                     "(this process is {})".format(
                                         holders, torch_pids, os.getpid()))
            for k in total:
                total[k] += launches[k]

        # 4. the process loader alone, continuing its epoch.
        it = its["process"]
        padded = 0
        t0 = time.perf_counter()
        for _ in range(DATA_LOADER_BATCHES):
            padded += int(np.prod(next(it)["input_ids"].shape))
        secs = time.perf_counter() - t0
        print("loader alone, process workers ({} a bin), continuing the "
              "epoch: {} batches of 16 in {:.2f} s: {:.1f} batches/s, {:.0f} "
              "padded tokens/s; phase 8's one thread worker a bin: {:.1f} "
              "batches/s, {:.0f} padded tokens/s ({})".format(
                  LOADER_WORKERS, DATA_LOADER_BATCHES, secs,
                  DATA_LOADER_BATCHES / secs, padded / secs, alone[0],
                  alone[1], card), flush=True)
        pids = worker_pids(loaders["process"])
    finally:
        t0 = time.perf_counter()
        for name, it in its.items():
            it.close()
        for loader in loaders.values():
            loader.shutdown_workers()
        os.environ.pop("LDDL_TPU_METRICS_DIR", None)
    print("loaders closed in {:.2f} s; process workers' own stage seconds, "
          "whole run (their exports on exit): {}".format(
              time.perf_counter() - t0, json.dumps({
              k: round(v, 6) for k, v in sorted(worker_stage_seconds(
                  metrics_dir, pids).items())})), flush=True)
    return total


def bart_data_path(fa, card):
    """Phase 10, the offline BART data path on the card: corpus -> the
    port's BART preprocess CLI (schema v2, then v1) -> balance -> the
    BART loader -> bart_base steps at L=1024. Returns the launch counts
    of the counted steps."""
    import numpy as np
    from lddl_tpu_torch.balance import balance_shards
    from lddl_tpu_torch.loader import (get_bart_pretrain_data_loader,
                                       prefetch_to_device)
    from lddl_tpu_torch.models import (BartConfig, BartForPreTraining,
                                       bart_batch_loss, make_optimizer,
                                       make_train_step)
    from lddl_tpu_torch.testing import write_text_corpus, write_vocab
    from lddl_tpu_torch.utils.cpus import usable_cpu_count

    tmp = tempfile.mkdtemp(prefix="chip_smoke_bart_data_")
    try:
        vocab = os.path.join(tmp, "vocab.txt")
        tokens = write_vocab(vocab, 30522, seed=0)
        t0 = time.perf_counter()
        nbytes = write_text_corpus(tmp, tokens, BART_DATA_BYTES,
                                   num_files=BART_DATA_FILES, seed=0,
                                   sentences=BART_DATA_SENTENCES)
        print("bart corpus: {} bytes in {} files in {:.1f} s".format(
            nbytes, BART_DATA_FILES, time.perf_counter() - t0), flush=True)
        workers = min(8, usable_cpu_count())
        outs = {}
        for schema in ("v2", "v1"):
            outs[schema] = os.path.join(tmp, "pre_" + schema)
            cmd = [sys.executable, "-m",
                   "lddl_tpu_torch.cli.preprocess_bart_pretrain",
                   "--wikipedia", tmp, "--sink", outs[schema],
                   "--target-seq-length", str(BART_DATA_TARGET),
                   "--num-blocks", str(BART_DATA_BLOCKS),
                   "--sample-ratio", "0.9", "--seed", "12345",
                   "--local-workers", str(workers)]
            if schema == "v2":
                cmd += ["--vocab-file", vocab]
            secs, seen = run_cli(cmd, "bart preprocess " + schema)
            print("bart preprocess {}: {:.1f} s for {} bytes, {:.2f} MB/s, "
                  "{} workers, {} of {} processes opened a CUDA context "
                  "({})".format(schema, secs, nbytes, nbytes / 1e6 / secs,
                                workers, seen["cuda_procs"], seen["procs"],
                                card), flush=True)
            if seen["cuda_procs"]:
                raise AssertionError("a BART preprocess process opened a "
                                     "CUDA context")
        t0 = time.perf_counter()
        tables = {k: shard_tables(v) for k, v in outs.items()}
        if list(tables["v2"]) != list(tables["v1"]) or not tables["v2"]:
            raise AssertionError("the two schemas wrote different shards")
        lens, rows = [], 0
        for name, t2 in tables["v2"].items():
            t1 = tables["v1"][name]
            if t1.column_names != ["sentences"] or t2.column_names != [
                    "sentences", "sentence_ids", "sentence_lens"]:
                raise AssertionError("{}: columns {} / {}".format(
                    name, t2.column_names, t1.column_names))
            if not t2.column("sentences").equals(t1.column("sentences")):
                raise AssertionError("{}: v2 and v1 chunk text differ"
                                     .format(name))
            lens += [sum(x) for x in t2.column("sentence_lens").to_pylist()]
            rows += t2.num_rows
        n_shards = len(tables["v2"])
        del tables
        lens = np.asarray(lens)
        q = np.percentile(lens, [0, 25, 50, 75, 100])
        print("bart chunks: {} in {} shards, v2 and v1 text equal row for "
              "row; chunk tokens min/q1/median/q3/max {}; {:.2%} over "
              "L - 2 = {} ({:.1f} s)".format(
                  rows, n_shards, "/".join(str(int(x)) for x in q),
                  float((lens > BART_L - 2).mean()), BART_L - 2,
                  time.perf_counter() - t0), flush=True)
        shutil.rmtree(outs["v1"])

        bal = os.path.join(tmp, "balanced")
        t0 = time.perf_counter()
        counts = balance_shards(outs["v2"], bal, BART_DATA_SHARDS)
        vals = list(counts.values())
        mean = sum(vals) / len(vals)
        if (len(vals) != BART_DATA_SHARDS or sum(vals) != rows
                or max(abs(v - mean) for v in vals) > 1):
            raise AssertionError("bart balance: {}".format(counts))
        print("bart balance: {} shards of {}-{} chunks in {:.1f} s ({})"
              .format(len(vals), min(vals), max(vals),
                      time.perf_counter() - t0, card), flush=True)
        shutil.rmtree(outs["v2"])

        def loader():
            return get_bart_pretrain_data_loader(
                bal, vocab_file=vocab, batch_size=BART_BATCH,
                max_seq_length=BART_L, fixed_seq_length=BART_L,
                base_seed=12345)

        it = iter(loader())
        t0 = time.perf_counter()
        next(it)
        first = time.perf_counter() - t0
        real = 0
        t0 = time.perf_counter()
        for _ in range(BART_LOADER_BATCHES):
            real += int(next(it)["attention_mask"].sum())
        secs = time.perf_counter() - t0
        it.close()
        print("bart loader alone: first batch {:.2f} s, then {} batches of "
              "{} in {:.2f} s: {:.1f} batches/s, {:.0f} real encoder "
              "tokens/s ({})".format(first, BART_LOADER_BATCHES, BART_BATCH,
                                     secs, BART_LOADER_BATCHES / secs,
                                     real / secs, card), flush=True)

        torch.manual_seed(0)
        cfg = BartConfig.bart_base(attention_dropout=0.0,
                                   attention_impl="auto")
        with torch.device("cuda"):
            model = BartForPreTraining(cfg)
        opt = make_optimizer(model.parameters(), learning_rate=1e-4,
                             warmup_steps=2, total_steps=100)
        step = make_train_step(model, opt, batch_loss=bart_batch_loss)
        zero_launches(fa)
        dts, it = [], iter(prefetch_to_device(loader()))
        try:
            for i in range(BART_STEPS):
                batch = next(it)
                t0 = time.perf_counter()
                loss = float(step(batch)["loss"])  # syncs the device
                dts.append(time.perf_counter() - t0)
                enc = int(batch["attention_mask"].sum())
                print("bart data step {} L={} loss={:.4f} encoder tokens {} "
                      "pad share {:.3f} {:.1f} ms ({})".format(
                          i, batch["input_ids"].shape[1], loss, enc,
                          1 - enc / (BART_BATCH * BART_L), dts[-1] * 1e3,
                          card), flush=True)
                if not math.isfinite(loss):
                    raise AssertionError("non-finite bart loss at step {}"
                                         .format(i))
        finally:
            it.close()
        launches = read_launches(fa)
        want = cfg.num_encoder_layers * BART_STEPS
        if launches != dict.fromkeys(KERNELS, 0) | {
                "online_fwd": want, "online_bwd_dq": want,
                "online_bwd_dkv": want}:
            raise AssertionError("bart data launch counts {} != {} per "
                                 "online kernel".format(launches, want))
        ms = 1e3 * sum(dts[1:]) / len(dts[1:])     # the first is warm-up
        print("bart_base on preprocessed shards: {:.2f} ms mean of {} steps "
              "(min {:.2f}, max {:.2f}); launches {} ({})".format(
                  ms, len(dts) - 1, 1e3 * min(dts[1:]), 1e3 * max(dts[1:]),
                  launches, card), flush=True)
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def file_tree(root):
    """{relpath: bytes} of every file under ``root``."""
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            p = os.path.join(dirpath, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def ingest_path(fa, card, shared):
    """Phase 11, streaming ingest under bert_large: a landing directory
    grown in three rounds -> ``ingest_once`` after each (generation 0,
    gen-0001, gen-0002; the delta balancer appends) -> a
    ``follow_generations`` loader that picks the new generations up at
    the epoch boundary -> bert_large steps; then a replay of the rounds
    into a second root, byte for byte. Generation 0's files go into
    ``shared["ingest_gen0"]`` (phase 13 holds its ingest to them).
    Returns the launch counts of the counted steps."""
    from lddl_tpu_torch.ingest import ingest_once
    from lddl_tpu_torch.loader import (get_bert_pretrain_data_loader,
                                       prefetch_to_device)
    from lddl_tpu_torch.models import (BertConfig, BertForPreTraining,
                                       make_optimizer, make_train_step)
    from lddl_tpu_torch.preprocess import BertPretrainConfig, get_tokenizer
    from lddl_tpu_torch.testing import write_text_corpus, write_vocab
    from lddl_tpu_torch.utils.fs import (generation_dir_name,
                                         get_all_parquets_under,
                                         get_bin_id_of_path,
                                         read_num_samples_cache)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_ingest_")
    try:
        vocab = os.path.join(tmp, "vocab.txt")
        tokens = write_vocab(vocab, 30522, seed=0)
        corpus = os.path.join(tmp, "corpus")
        nbytes = write_text_corpus(corpus, tokens,
                                   INGEST_FILES * INGEST_FILE_BYTES,
                                   num_files=INGEST_FILES, seed=1)
        tok = get_tokenizer(vocab)
        cfg_pre = BertPretrainConfig(max_seq_length=DATA_TARGET,
                                     masking=True, engine="numpy")

        def ingest_round(root, landing, n_files):
            src = os.path.join(landing, "source")
            os.makedirs(src, exist_ok=True)
            for i in range(n_files):
                shutil.copy(os.path.join(corpus, "source",
                                         "{}.txt".format(i)), src)
            t0 = time.perf_counter()
            rep = ingest_once(root, tok, landing=landing, config=cfg_pre,
                              num_shards=INGEST_SHARDS, bin_size=DATA_BIN,
                              seed=12345)
            return rep, time.perf_counter() - t0

        def generation_counts(root, gen):
            d = root if gen == 0 else os.path.join(
                root, generation_dir_name(gen))
            cache = read_num_samples_cache(d) or {}
            return {k: v for k, v in cache.items() if k != "__sizes__"}

        def counts_by_bin(root, latest):
            by_bin = {}
            for gen in range(latest + 1):
                for name, n in generation_counts(root, gen).items():
                    by_bin.setdefault(get_bin_id_of_path(name), []).append(n)
            return by_bin

        def epoch_samples(root, latest):
            """Samples an epoch over generations 0..latest serves: one
            rank, one worker, each shard of a bin cut to the bin's
            smallest (the loader's equalization)."""
            return sum(min(ns) * len(ns)
                       for ns in counts_by_bin(root, latest).values())

        def check_budgets(root, latest):
            by_bin = counts_by_bin(root, latest)
            for b, ns in by_bin.items():
                if max(ns) - min(ns) > 1:
                    raise AssertionError("bin {}: counts {} outside the "
                                         "row budget".format(b, sorted(ns)))
            return {str(DATA_BINS[b]): "{}x{}-{}".format(len(ns), min(ns),
                                                         max(ns))
                    for b, ns in sorted(by_bin.items())}

        root = os.path.join(tmp, "root")
        landing = os.path.join(tmp, "landing")
        t_phase = time.perf_counter()
        reps = []

        def report(rep, secs):
            reps.append(rep)
            print("ingest generation {}: {} docs, {} samples visible, {} "
                  "new shards, {} carry rows, {:.2f} s; bins (shards x "
                  "rows, within 1 of the budget) {} ({})".format(
                      rep["generation"], rep["docs"], rep["samples_visible"],
                      rep["new_shards"], rep["carry_rows"], secs,
                      json.dumps(check_budgets(root, rep["generation"])),
                      card), flush=True)
            if rep["noop"] or rep["touched_prior_shards"]:
                raise AssertionError("ingest round: {}".format(rep))

        report(*ingest_round(root, landing, INGEST_ROUND_FILES[0]))
        shared["ingest_gen0"] = file_tree(root)
        gen0 = epoch_samples(root, 0)
        bins = sorted({get_bin_id_of_path(p)
                       for p in get_all_parquets_under(root)})
        if bins != list(range(len(DATA_BINS))):
            raise AssertionError("generation 0 has bins {}".format(bins))

        loader = get_bert_pretrain_data_loader(
            root, vocab_file=vocab, batch_size=INGEST_BATCH,
            fixed_seq_lengths=DATA_BINS, base_seed=12345,
            follow_generations=True)
        it = iter(loader)
        served = sum(len(next(it)["input_ids"]) for _ in range(2))
        # Round 2 publishes gen-0001 mid-epoch: epoch 0 must not see it.
        report(*ingest_round(root, landing, INGEST_ROUND_FILES[1]))
        served += sum(len(b["input_ids"]) for b in it)
        print("follow loader epoch 0: {} samples served, generation 0 "
              "holds {} ({} before the loader's equalization)".format(
                  served, gen0, sum(generation_counts(root, 0).values())),
              flush=True)
        if served != gen0:
            raise AssertionError("epoch 0 served {} != generation 0's {}"
                                 .format(served, gen0))
        report(*ingest_round(root, landing, INGEST_ROUND_FILES[2]))
        rep, secs = ingest_round(root, landing, INGEST_ROUND_FILES[2])
        if not rep["noop"]:
            raise AssertionError("a rescan of an unchanged landing ingested "
                                 "{}".format(rep))
        print("ingest rescan of an unchanged landing: no-op in {:.2f} s"
              .format(secs), flush=True)
        total = epoch_samples(root, 2)

        torch.manual_seed(0)
        cfg = BertConfig.bert_large(attention_dropout=0.0,
                                    attention_impl="auto")
        with torch.device("cuda"):
            model = BertForPreTraining(cfg)
        opt = make_optimizer(model.parameters(), learning_rate=1e-4,
                             warmup_steps=4, total_steps=100)
        step = make_train_step(model, opt)
        steps, served = {}, 0
        zero_launches(fa)
        it = iter(prefetch_to_device(loader))
        try:
            for batch in it:
                served += batch["input_ids"].shape[0]
                l_bin = batch["input_ids"].shape[1]
                if steps.get(l_bin, 0) >= INGEST_STEPS_PER_BIN:
                    continue
                t0 = time.perf_counter()
                loss = float(step(batch, seed=0)["loss"])  # syncs
                dt = time.perf_counter() - t0
                steps[l_bin] = steps.get(l_bin, 0) + 1
                print("ingest step L={} loss={:.4f} {:.1f} ms ({})".format(
                    l_bin, loss, dt * 1e3, card), flush=True)
                if not math.isfinite(loss):
                    raise AssertionError("non-finite loss at L={}".format(
                        l_bin))
        finally:
            it.close()
        launches = read_launches(fa)
        print("follow loader epoch 1: {} samples served, generations 0-2 "
              "hold {}".format(served, total), flush=True)
        if served != total:
            raise AssertionError("epoch 1 served {} != the three "
                                 "generations' {}".format(served, total))
        kernel_steps = sum(n for l_bin, n in steps.items()
                           if fa.single_block_serves(l_bin, 64))
        want = cfg.num_layers * kernel_steps
        if not kernel_steps or launches != dict.fromkeys(KERNELS, 0) | {
                "onekv_fwd": want, "onekv_bwd": want}:
            raise AssertionError("ingest launch counts {} != {} per "
                                 "single-block kernel ({} steps)".format(
                                     launches, want, steps))
        print("ingest bins reached {} (steps a bin); launches: {}".format(
            json.dumps({str(k): v for k, v in sorted(steps.items())}),
            launches), flush=True)
        del model, opt, step

        replay = os.path.join(tmp, "replay")
        t0 = time.perf_counter()
        for n_files in INGEST_ROUND_FILES:
            ingest_round(replay, os.path.join(tmp, "landing_replay"),
                         n_files)
        got, want_tree = file_tree(replay), file_tree(root)
        if got != want_tree:
            raise AssertionError("the replay differs in {}".format(sorted(
                k for k in set(got) | set(want_tree)
                if got.get(k) != want_tree.get(k))[:8]))
        print("ingest replay: {} files byte-equal (shards, .num_samples."
              "json, manifests, journal) in {:.1f} s; corpus {} bytes; "
              "phase rounds {:.1f} s".format(
                  len(got), time.perf_counter() - t0, nbytes,
                  t0 - t_phase), flush=True)
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def lease_holders(out, prefix):
    """{unit: holder} of the lease files under ``out/_leases`` whose unit
    starts with ``prefix`` (a file caught mid-replace or gone is
    skipped)."""
    root = os.path.join(out, "_leases")
    try:
        names = os.listdir(root)
    except OSError:
        return {}
    held = {}
    for n in names:
        if n.startswith(prefix) and n.endswith(".json"):
            try:
                with open(os.path.join(root, n)) as f:
                    held[n[:-len(".json")]] = json.load(f).get("holder")
            except (OSError, ValueError):
                continue
    return held


def metric_total(metrics_dir, name):
    """A counter summed over the last snapshot of each process that
    exported into ``metrics_dir``."""
    total = 0
    for n in sorted(os.listdir(metrics_dir)):
        if n.startswith("metrics-") and n.endswith(".jsonl"):
            with open(os.path.join(metrics_dir, n)) as f:
                lines = [ln for ln in f.read().splitlines() if ln.strip()]
            snap = json.loads(lines[-1])["metrics"].get(name) if lines \
                else None
            if snap:
                total += sum(snap["values"].values())
    return total


def trace_instants(metrics_dir, name):
    """Wall-clock seconds of every instant event ``name`` in the trace
    files of ``metrics_dir``."""
    out = []
    for n in sorted(os.listdir(metrics_dir)):
        if n.startswith("trace-") and n.endswith(".jsonl"):
            with open(os.path.join(metrics_dir, n)) as f:
                for line in f:
                    rec = json.loads(line)
                    if rec.get("name") == name and rec.get("ph") == "i":
                        out.append(rec["ts"] / 1e6)
    return out


def bert_large_bins(fa, loader, per_bin, label, card):
    """bert_large (random weights from seed 0), ``per_bin`` steps in each
    bin of DATA_BINS that ``loader`` reaches within DATA_MAX_BATCHES
    batches (or its epoch), through ``prefetch_to_device``, each loss
    finite. The launch counters are zeroed just before and read just
    after, and must show each single-block kernel 24 times a step of
    L_pad >= 256 and no other kernel. Returns ({bin: steps}, the step
    seconds without each bin's first, the launch counts)."""
    import itertools

    from lddl_tpu_torch.loader import prefetch_to_device
    from lddl_tpu_torch.models import (BertConfig, BertForPreTraining,
                                       make_optimizer, make_train_step)

    torch.manual_seed(0)
    cfg = BertConfig.bert_large(attention_dropout=0.0,
                                attention_impl="auto")
    with torch.device("cuda"):
        model = BertForPreTraining(cfg)
    opt = make_optimizer(model.parameters(), learning_rate=1e-4,
                         warmup_steps=4, total_steps=100)
    step = make_train_step(model, opt)
    steps, timed = {}, []
    zero_launches(fa)
    it = iter(prefetch_to_device(loader))
    try:
        for batch in itertools.islice(it, DATA_MAX_BATCHES):
            l_bin = batch["input_ids"].shape[1]
            if steps.get(l_bin, 0) >= per_bin:
                continue
            t0 = time.perf_counter()
            loss = float(step(batch, seed=0)["loss"])  # syncs
            dt = time.perf_counter() - t0
            if steps.get(l_bin, 0):
                timed.append(dt)  # each bin's first step excluded
            steps[l_bin] = steps.get(l_bin, 0) + 1
            print("{} step L={} loss={:.4f} {:.1f} ms ({})".format(
                label, l_bin, loss, dt * 1e3, card), flush=True)
            if not math.isfinite(loss):
                raise AssertionError("non-finite loss at L={}".format(
                    l_bin))
            if len(steps) == len(DATA_BINS) and min(
                    steps.values()) >= per_bin:
                break
    finally:
        it.close()
    launches = read_launches(fa)
    kernel_steps = sum(n for l_bin, n in steps.items()
                       if fa.single_block_serves(l_bin, 64))
    want = cfg.num_layers * kernel_steps
    if not kernel_steps or launches != dict.fromkeys(KERNELS, 0) | {
            "onekv_fwd": want, "onekv_bwd": want}:
        raise AssertionError("{} launch counts {} != {} per single-block "
                             "kernel ({} steps)".format(label, launches, want,
                                                        steps))
    return steps, timed, launches


def elastic_path(fa, card, shared):
    """Phase 12, elastic scheduling under bert_large: phase 8's preprocess
    CLI over one corpus, static, then as ELASTIC_HOSTS ``--elastic``
    processes on one output directory with the first SIGKILLed (its
    process group, pool workers included) as soon as a lease file names
    it on a gather unit; the survivors must steal its units, exit 0 and
    write the static run's bytes, and no elastic process may open a CUDA
    context. Then the elastic output is balanced and drives bert_large
    steps from the loader. The corpus, vocab and static output stay for
    phase 13 (``shared``; ``main`` removes them). Returns the launch
    counts of the steps."""
    import re
    import signal

    import numpy as np
    from lddl_tpu_torch.balance import balance_shards
    from lddl_tpu_torch.loader import get_bert_pretrain_data_loader
    from lddl_tpu_torch.testing import write_text_corpus, write_vocab

    tmp = tempfile.mkdtemp(prefix="chip_smoke_elastic_")
    shared["elastic_tmp"] = tmp
    procs = {}
    try:
        vocab = os.path.join(tmp, "vocab.txt")
        tokens = write_vocab(vocab, 30522, seed=0)
        nbytes = write_text_corpus(tmp, tokens, ELASTIC_BYTES,
                                   num_files=ELASTIC_FILES, seed=2)
        static = os.path.join(tmp, "static")
        static_s, seen = preprocess_cli(tmp, vocab, static, "numpy",
                                        ELASTIC_WORKERS, card)
        shared.update(elastic_static=static, elastic_vocab=vocab,
                      elastic_static_s=static_s)
        if seen["cuda_procs"]:
            raise AssertionError("the static run: {} processes opened a "
                                 "CUDA context".format(seen["cuda_procs"]))
        print("elastic phase: static preprocess of {} bytes in {:.1f} s "
              "({:.2f} MB/s, {} workers) ({})".format(
                  nbytes, static_s, nbytes / 1e6 / static_s,
                  ELASTIC_WORKERS, card), flush=True)

        out = os.path.join(tmp, "elastic")
        root = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ, PYTHONUNBUFFERED="1",
                   PYTHONPATH=os.pathsep.join(
                       [root] + [p for p in [os.environ.get("PYTHONPATH")]
                                 if p]))
        hosts = ["h{}".format(i) for i in range(ELASTIC_HOSTS)]
        logs = {h: os.path.join(tmp, h + ".log") for h in hosts}
        metrics = {h: os.path.join(tmp, "metrics-" + h) for h in hosts}
        watches = {}
        t0 = time.perf_counter()
        for h in hosts:
            cmd = preprocess_cmd(tmp, vocab, out, "numpy", ELASTIC_WORKERS) \
                + ["--elastic", "--lease-ttl", str(ELASTIC_TTL),
                   "--elastic-host-id", h]
            with open(logs[h], "w") as f:
                procs[h] = subprocess.Popen(
                    cmd, stdout=f, stderr=subprocess.STDOUT, cwd=root,
                    env=dict(env, LDDL_TPU_METRICS_DIR=metrics[h]),
                    start_new_session=True)
            watches[h] = DeviceWatch(procs[h].pid)
        victim = procs[hosts[0]]
        while True:
            if victim.poll() is not None:
                raise AssertionError("{} exited ({}) before it held a "
                                     "gather lease".format(hosts[0],
                                                           victim.returncode))
            held = lease_holders(out, "group-")
            if hosts[0] in held.values():
                os.killpg(victim.pid, signal.SIGKILL)
                kill_wall, kill_t = time.time(), time.perf_counter()
                break
            if time.perf_counter() - t0 > 600:
                raise AssertionError("no gather lease named {} in 600 s"
                                     .format(hosts[0]))
            time.sleep(0.02)
        victim.wait()
        for h in hosts[1:]:
            procs[h].wait(timeout=900)
        elastic_s = time.perf_counter() - t0
        seen = {h: watches[h].stop() for h in hosts}
        text = {}
        for h in hosts:
            with open(logs[h]) as f:
                text[h] = f.read()
        for h in hosts[1:]:
            if procs[h].returncode != 0:
                raise AssertionError("elastic host {} failed ({}):\n{}"
                                     .format(h, procs[h].returncode,
                                             text[h][-4000:]))
        if victim.returncode != -signal.SIGKILL:
            raise AssertionError("{} ended with {}".format(
                hosts[0], victim.returncode))
        if any(s["cuda_procs"] for s in seen.values()):
            raise AssertionError("elastic processes opened a CUDA context: "
                                 "{}".format(seen))
        # Units journaled a holder: the survivors' summaries; the killed
        # host's are the plan's units less theirs (each unit is journaled
        # once).
        units, steals_log, rejects_log = {}, 0, 0
        for h in hosts[1:]:
            m = re.search(r"elastic summary: holder=(\S+) units=(\d+) "
                          r"steals=(\d+) fence_rejects=(\d+)", text[h])
            if m is None:
                raise AssertionError("no summary from {}".format(h))
            units[h] = int(m.group(2))
            steals_log += int(m.group(3))
            rejects_log += int(m.group(4))
        plan = re.search(r"adaptive plan journaled \((\d+) probe\(s\) \+ "
                         r"(\d+) main unit\(s\)", "".join(text.values()))
        groups = re.search(r"-> \d+ blocks \((\d+) spool groups\)",
                           text[hosts[1]])
        total = int(plan.group(1)) + int(plan.group(2)) + int(groups.group(1))
        units[hosts[0]] = total - sum(units.values())
        steals = sum(metric_total(metrics[h], "lease_steals_total")
                     for h in hosts[1:])
        rejects = sum(metric_total(metrics[h], "lease_fence_rejects_total")
                      for h in hosts[1:])
        stolen_at = sorted(t for h in hosts[1:]
                           for t in trace_instants(metrics[h], "lease.steal")
                           if t >= kill_wall)
        if steals < 1 or not stolen_at:
            raise AssertionError("no steal after the SIGKILL: {} counted, "
                                 "{} traced".format(steals, len(stolen_at)))
        names = sorted(os.listdir(static))
        if sorted(os.listdir(out)) != names or ".manifest.json" not in names:
            raise AssertionError("elastic files {} != static {}".format(
                sorted(os.listdir(out))[:8], names[:8]))
        differ = []
        for n in names:
            with open(os.path.join(out, n), "rb") as a, \
                    open(os.path.join(static, n), "rb") as b:
                if a.read() != b.read():
                    differ.append(n)
        if differ:
            raise AssertionError("elastic bytes differ from the static "
                                 "run's in {}".format(differ[:8]))
        print("elastic phase: {} --elastic hosts x {} workers, ttl {} s, {} "
              "SIGKILLed with its process group at {:.1f} s on a gather "
              "lease; the survivors done at {:.1f} s (static {:.1f} s); "
              "units journaled per holder {}; steals {} (their logs: {}), "
              "fence rejects {} ({}); first steal {:.2f} s after the kill; "
              "{} files (shards + .manifest.json) byte-equal to the static "
              "run's; {} CUDA contexts in {} elastic processes ({})".format(
                  ELASTIC_HOSTS, ELASTIC_WORKERS, ELASTIC_TTL, hosts[0],
                  kill_t - t0, elastic_s, static_s,
                  json.dumps(units, sort_keys=True), steals, steals_log,
                  rejects, rejects_log, stolen_at[0] - kill_wall,
                  len(names),
                  sum(s["cuda_procs"] for s in seen.values()),
                  sum(s["procs"] for s in seen.values()), card), flush=True)
        shared["elastic_s"] = elastic_s

        bal = os.path.join(tmp, "balanced")
        t0 = time.perf_counter()
        counts = balance_shards(out, bal, ELASTIC_SHARDS)
        balance_s = time.perf_counter() - t0
        by_bin = {}
        for k, n in counts.items():
            by_bin.setdefault(int(k.rsplit("_", 1)[1]), []).append(n)
        for b, ns in by_bin.items():
            if len(ns) != ELASTIC_SHARDS or max(ns) - min(ns) > 1:
                raise AssertionError("bin {}: {} shards, spread {}".format(
                    b, len(ns), max(ns) - min(ns)))
        print("elastic phase: balance to {} shards ({} a bin) in {:.1f} s "
              "({})".format(len(counts), ELASTIC_SHARDS, balance_s, card),
              flush=True)
        shutil.rmtree(out)

        steps, timed, launches = bert_large_bins(
            fa, get_bert_pretrain_data_loader(
                bal, vocab_file=vocab, batch_size=16,
                fixed_seq_lengths=DATA_BINS, base_seed=12345),
            ELASTIC_STEPS_PER_BIN, "elastic", card)
        print("elastic phase: bins reached {} (steps a bin); bert_large step "
              "{:.1f} ms mean of {} (each bin's first excluded); launches: "
              "{} ({})".format(
                  json.dumps({str(k): v for k, v in sorted(steps.items())}),
                  float(np.mean(timed)) * 1e3, len(timed), launches, card),
              flush=True)
        shutil.rmtree(bal)
        return launches
    finally:
        for p in procs.values():
            if p.poll() is None:
                try:
                    os.killpg(p.pid, signal.SIGKILL)
                except OSError:
                    pass
                p.wait()


FLEET_ENVS = ("LDDL_TPU_FLEET_DIR", "LDDL_TPU_FLEET_HOLDER",
              "LDDL_TPU_FLEET_TTL_S", "LDDL_TPU_FLEET_INTERVAL_S",
              "LDDL_TPU_METRICS_DIR", "LDDL_TPU_METRICS_RANK",
              "LDDL_TPU_FAULTS")


def fleet_env(**extra):
    """The environment of a fleet phase's subprocess: the repo on the
    path, no telemetry or fault variable of this process, the phase's
    heartbeat interval."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items() if k not in FLEET_ENVS}
    env.update(PYTHONUNBUFFERED="1", LDDL_TPU_FLEET_INTERVAL_S=str(
        FLEET_INTERVAL), PYTHONPATH=os.pathsep.join(
            [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    env.update(extra)
    return env


def status_json(root, *extra):
    """``python -m lddl_tpu_torch.tools.pipeline_status <root> --json``
    in a process of its own: (exit code, report, seconds)."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "lddl_tpu_torch.tools.pipeline_status", root,
         "--json", *extra], capture_output=True, text=True, timeout=300,
        cwd=os.path.dirname(os.path.abspath(__file__)), env=fleet_env())
    secs = time.perf_counter() - t0
    try:
        report = json.loads(proc.stdout)
    except ValueError:
        raise AssertionError("pipeline_status ({}): {}\n{}".format(
            proc.returncode, proc.stdout[-2000:], proc.stderr[-2000:]))
    return proc.returncode, report, secs


def spool_bytes(root):
    """{holder: bytes of its spool under <root>/.telemetry/}."""
    tele = os.path.join(root, ".telemetry")
    out = {}
    for h in sorted(os.listdir(tele)):
        d = os.path.join(tele, h)
        if os.path.isdir(d):
            out[h] = sum(os.path.getsize(os.path.join(d, n))
                         for n in os.listdir(d))
    return out


def rollups(report):
    """The per-host rollup lines of a pipeline_status report."""
    rows = {}
    for h, st in sorted(report["hosts"].items()):
        c = st["counters"]
        rows[h] = {"state": "STALLED" if st["stalled"] else (
            "closed" if st["closed"] else "live"),
            "beat_age_s": st["heartbeat_age_s"],
            "units": c["units_completed"], "steals": c["steals"],
            "fence_rejects": c["fence_rejects"], "docs": c["docs"],
            "samples": c["samples"], "events": st["events_total"],
            "torn": st["torn_lines"], "gauges": st["gauges"]}
    return rows


def live_processes(marker):
    """Pids of live (non-zombie) processes whose command line holds every
    string of ``marker``."""
    out = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open("/proc/{}/cmdline".format(pid), "rb") as f:
                cmd = f.read().decode(errors="replace")
            with open("/proc/{}/stat".format(pid)) as f:
                state = f.read().rsplit(")", 1)[1].split()[0]
        except (OSError, IndexError):
            continue
        if state != "Z" and all(m in cmd for m in marker):
            out.append(int(pid))
    return out


def fleet_elastic(card, shared):
    """Phase 13, part 1: phase 12's elastic hosts with
    ``--fleet-telemetry``; the first dies by the kill fault at its first
    gather ledger publish. Returns the part's summary dict."""
    import re
    import signal

    tmp, static, vocab = (shared["elastic_tmp"], shared["elastic_static"],
                          shared["elastic_vocab"])
    out = os.path.join(tmp, "fleet")
    root = os.path.dirname(os.path.abspath(__file__))
    hosts = ["h{}".format(i) for i in range(ELASTIC_HOSTS)]
    logs = {h: os.path.join(tmp, "fleet-" + h + ".log") for h in hosts}
    procs, watches = {}, {}
    t0 = time.perf_counter()
    try:
        for h in hosts:
            cmd = preprocess_cmd(tmp, vocab, out, "numpy", ELASTIC_WORKERS) \
                + ["--elastic", "--lease-ttl", str(ELASTIC_TTL),
                   "--elastic-host-id", h, "--fleet-telemetry"]
            env = fleet_env(**({"LDDL_TPU_FAULTS": FLEET_KILL}
                               if h == hosts[0] else {}))
            with open(logs[h], "w") as f:
                procs[h] = subprocess.Popen(
                    cmd, stdout=f, stderr=subprocess.STDOUT, cwd=root,
                    env=env, start_new_session=True)
            watches[h] = DeviceWatch(procs[h].pid)
        victim = procs[hosts[0]]
        victim.wait(timeout=600)
        kill_wall, kill_t = time.time(), time.perf_counter()
        try:
            os.killpg(victim.pid, signal.SIGKILL)  # its orphaned workers
        except OSError:
            pass
        # The victim's journal: the records of the scatter slices and
        # probes (``scatter-p<k>``) naming it, not the adaptive plan's
        # (``scatter-plan``), read while its stolen gather lease keeps
        # the survivors from finalizing.
        done = os.path.join(out, "_done")
        victim_units = 0
        for n in sorted(os.listdir(done)):
            if re.fullmatch(r"scatter-p?\d+\.json", n):
                with open(os.path.join(done, n)) as f:
                    if json.load(f).get("holder") == hosts[0]:
                        victim_units += 1
        for h in hosts[1:]:
            procs[h].wait(timeout=900)
        elastic_s = time.perf_counter() - t0
    finally:
        for p in procs.values():
            if p.poll() is None:
                try:
                    os.killpg(p.pid, signal.SIGKILL)
                except OSError:
                    pass
                p.wait()
        seen = {h: w.stop() for h, w in watches.items()}
    text = {}
    for h in hosts:
        with open(logs[h]) as f:
            text[h] = f.read()
    if victim.returncode != -signal.SIGKILL:
        raise AssertionError("{} ended with {}:\n{}".format(
            hosts[0], victim.returncode, text[hosts[0]][-4000:]))
    for h in hosts[1:]:
        if procs[h].returncode != 0:
            raise AssertionError("fleet host {} failed ({}):\n{}".format(
                h, procs[h].returncode, text[h][-4000:]))
    if any(s["cuda_procs"] for s in seen.values()):
        raise AssertionError("fleet hosts opened a CUDA context: {}"
                             .format(seen))
    names = sorted(n for n in os.listdir(out) if n != ".telemetry")
    if names != sorted(os.listdir(static)) or ".manifest.json" not in names:
        raise AssertionError("fleet files {} != static {}".format(
            names[:8], sorted(os.listdir(static))[:8]))
    differ = []
    for n in names:
        with open(os.path.join(out, n), "rb") as a, \
                open(os.path.join(static, n), "rb") as b:
            if a.read() != b.read():
                differ.append(n)
    if differ:
        raise AssertionError("fleet bytes differ from phase 12's static "
                             "run's in {}".format(differ[:8]))
    units = {hosts[0]: victim_units}
    for h in hosts[1:]:
        m = re.search(r"elastic summary: holder=(\S+) units=(\d+)", text[h])
        if m is None:
            raise AssertionError("no summary from {}".format(h))
        units[h] = int(m.group(2))

    # The status tool once the victim's last beat is older than its TTL.
    time.sleep(max(0.0, kill_wall + ELASTIC_TTL + 1.0 - time.time()))
    rules = os.path.join(tmp, "fleet-rules.json")
    with open(rules, "w") as f:
        json.dump({"rules": [{"name": "stalled-hosts", "type": "threshold",
                              "metric": "hosts.*.stalled", "op": ">",
                              "value": 0}]}, f)
    rc, report, agg_s = status_json(out, "--alerts", rules)
    health = report["health"]
    if rc != 2 or health["stalled_hosts"] != [hosts[0]] \
            or health["closed_hosts"] != hosts[1:]:
        raise AssertionError("pipeline_status exit {}: stalled {}, closed "
                             "{}".format(rc, health["stalled_hosts"],
                                         health["closed_hosts"]))
    if report["alerts"]["firing"] != ["stalled-hosts"]:
        raise AssertionError("alerts: {}".format(report["alerts"]))
    spool = {h: os.path.join(out, ".telemetry", h) for h in hosts}
    steals = sum(metric_total(spool[h], "lease_steals_total")
                 for h in hosts[1:])
    if report["totals"]["counters"]["steals"] != steals or steals < 1:
        raise AssertionError("report steals {} != the survivors' "
                             "lease_steals_total {}".format(
                                 report["totals"]["counters"]["steals"],
                                 steals))
    got_units = {h: report["hosts"][h]["counters"]["units_completed"]
                 for h in hosts}
    journaled = {h: report["hosts"][h]["event_counts"].get(
        "unit.journaled", 0) for h in hosts}
    if got_units != units or journaled != units:
        raise AssertionError("units per holder: report {}, events {}, "
                             "journal {}".format(got_units, journaled,
                                                 units))
    stolen = sum(report["hosts"][h]["event_counts"].get("unit.stolen", 0)
                 for h in hosts[1:])
    if stolen < 1:
        raise AssertionError("no unit.stolen event from the survivors")
    merged = os.path.join(tmp, "fleet-merged.json")
    t1 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "lddl_tpu_torch.tools.trace_summary", out,
         "--merge", merged], capture_output=True, text=True, timeout=300,
        cwd=root, env=fleet_env())
    merge_s = time.perf_counter() - t1
    if proc.returncode != 0:
        raise AssertionError("trace_summary --merge: {}".format(
            proc.stderr[-2000:]))
    with open(merged) as f:
        events = json.load(f)
    lanes = {ev["args"]["name"] for ev in events
             if ev.get("ph") == "M" and ev.get("name") == "process_name"}
    lane_hosts = sorted({name.split(" ")[0] for name in lanes})
    if lane_hosts != hosts:
        raise AssertionError("merged trace lanes {}".format(sorted(lanes)))
    print("fleet phase, elastic: {} hosts x {} workers with "
          "--fleet-telemetry (heartbeat {} s), {} killed by the kill fault "
          "at {:.1f} s on its first gather publish; the survivors done at "
          "{:.1f} s (phase 12: elastic {:.1f} s, static {:.1f} s); {} files "
          "byte-equal to phase 12's static run; {} CUDA contexts in {} "
          "processes ({})".format(
              ELASTIC_HOSTS, ELASTIC_WORKERS, FLEET_INTERVAL, hosts[0],
              kill_t - t0, elastic_s, shared["elastic_s"],
              shared["elastic_static_s"], len(names),
              sum(s["cuda_procs"] for s in seen.values()),
              sum(s["procs"] for s in seen.values()), card), flush=True)
    print("fleet phase, elastic: pipeline_status exit {} in {:.2f} s: "
          "stalled {}, closed {}, alerts firing {}; steals {} (= the "
          "survivors' lease_steals_total); units per holder {} (= the "
          "journal, = unit.journaled events); unit.stolen events {}; "
          "merged trace {} events in {} lanes over hosts {} ({:.2f} s); "
          "spool bytes {}".format(
              rc, agg_s, health["stalled_hosts"], health["closed_hosts"],
              report["alerts"]["firing"], steals,
              json.dumps(units, sort_keys=True), stolen, len(events),
              len(lanes), lane_hosts, merge_s,
              json.dumps(spool_bytes(out), sort_keys=True)), flush=True)
    print("fleet phase, elastic rollups: {}".format(json.dumps(
        rollups(report), sort_keys=True, default=str)), flush=True)
    shutil.rmtree(out)
    return {"elastic_s": elastic_s, "aggregate_s": agg_s}


def fleet_ingest(card, shared):
    """Phase 13, part 2: ``ingest_watch --elastic --fleet-telemetry
    --autoscale`` over phase 11's round-0 landing, with an SLO below the
    round's document count. Returns (ingest root, the part's summary)."""
    from lddl_tpu_torch.testing import write_text_corpus, write_vocab

    tmp, vocab = shared["elastic_tmp"], shared["elastic_vocab"]
    # Phase 11's corpus: the same vocab (phases 11 and 12 write one from
    # seed 0), seed 1.
    tokens = write_vocab(os.path.join(tmp, "ingest-vocab.txt"), 30522,
                         seed=0)
    corpus = os.path.join(tmp, "ingest-corpus")
    write_text_corpus(corpus, tokens, INGEST_FILES * INGEST_FILE_BYTES,
                      num_files=INGEST_FILES, seed=1)
    landing = os.path.join(tmp, "ingest-landing")
    os.makedirs(os.path.join(landing, "source"))
    for i in range(INGEST_ROUND_FILES[0]):
        shutil.copy(os.path.join(corpus, "source", "{}.txt".format(i)),
                    os.path.join(landing, "source"))
    iroot = os.path.join(tmp, "ingest-root")
    cmd = [sys.executable, "-m", "lddl_tpu_torch.cli.ingest_watch",
           "--landing", landing, "--sink", iroot, "--vocab-file", vocab,
           "--target-seq-length", str(DATA_TARGET), "--bin-size",
           str(DATA_BIN), "--masking", "--num-shards", str(INGEST_SHARDS),
           "--seed", "12345", "--elastic", "--lease-ttl", str(ELASTIC_TTL),
           "--fleet-telemetry", "--autoscale", "--backlog-slo-docs",
           str(FLEET_SLO_DOCS), "--max-helpers", str(FLEET_MAX_HELPERS),
           "--drain-rounds", str(FLEET_DRAIN_ROUNDS), "--max-rounds",
           str(FLEET_ROUNDS), "--interval", str(FLEET_WATCH_INTERVAL)]
    log = os.path.join(tmp, "ingest-watch.log")
    t0 = time.perf_counter()
    with open(log, "w") as f:
        proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT,
                                cwd=os.path.dirname(os.path.abspath(
                                    __file__)), env=fleet_env())
    watch = DeviceWatch(proc.pid)
    try:
        proc.wait(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        seen = watch.stop()
    ingest_s = time.perf_counter() - t0
    with open(log) as f:
        text = f.read()
    if proc.returncode != 0:
        raise AssertionError("ingest_watch --autoscale failed ({}):\n{}"
                             .format(proc.returncode, text[-4000:]))
    left = live_processes(["--join-pending", iroot])
    if left:
        raise AssertionError("helpers left running: {}".format(left))
    if seen["cuda_procs"]:
        raise AssertionError("ingest processes opened a CUDA context: {}"
                             .format(seen))
    got = {k: v for k, v in file_tree(iroot).items()
           if not k.startswith(".telemetry" + os.sep)}
    want = shared["ingest_gen0"]
    if got != want:
        raise AssertionError("generation 0 differs from phase 11's in {}"
                             .format(sorted(k for k in set(got) | set(want)
                                            if got.get(k) != want.get(k))
                                     [:8]))
    rc, report, agg_s = status_json(iroot)
    decisions = []
    for h in sorted(os.listdir(os.path.join(iroot, ".telemetry"))):
        d = os.path.join(iroot, ".telemetry", h)
        for n in sorted(os.listdir(d)):
            if n.startswith("events-pid") and n.endswith(".jsonl"):
                with open(os.path.join(d, n)) as f:
                    for line in f:
                        ev = json.loads(line)
                        if ev["kind"].startswith("autoscale."):
                            decisions.append((ev["wall"], ev["kind"][10:],
                                              ev["args"]["helpers"]))
    decisions.sort()
    ups = sum(1 for _, k, _ in decisions if k == "scale_up")
    downs = sum(1 for _, k, _ in decisions if k == "scale_down")
    if ups < 1 or downs != ups or decisions[-1][2] != 0:
        raise AssertionError("autoscale decisions {}".format(decisions))
    joined = sum(st["event_counts"].get("generation.joined", 0)
                 for st in report["hosts"].values())
    print("fleet phase, ingest: ingest_watch --autoscale, {} rounds at {} "
          "s over phase 11's round-0 landing ({} files), SLO {} docs, at "
          "most {} helpers, drain {} round(s): done in {:.1f} s, exit 0; "
          "helper count over the decisions {} ({} scale-ups, {} "
          "scale-downs, none left running); {} CUDA contexts in {} "
          "processes; {} files of generation 0 byte-equal to phase 11's; "
          "pipeline_status exit {} in {:.2f} s; {} hosts, {} helper joins "
          "of the in-flight generation; spool bytes {} ({})".format(
              FLEET_ROUNDS, FLEET_WATCH_INTERVAL, INGEST_ROUND_FILES[0],
              FLEET_SLO_DOCS, FLEET_MAX_HELPERS, FLEET_DRAIN_ROUNDS,
              ingest_s, [n for _, _, n in decisions], ups, downs,
              seen["cuda_procs"], seen["procs"], len(got), rc, agg_s,
              len(report["hosts"]), joined,
              json.dumps(spool_bytes(iroot), sort_keys=True),
              card), flush=True)
    print("fleet phase, ingest rollups: {}".format(json.dumps(
        rollups(report), sort_keys=True, default=str)), flush=True)
    return iroot, {"ingest_s": ingest_s, "helpers": [
        n for _, _, n in decisions]}


def fleet_steps(fa, card, iroot, vocab):
    """Phase 13, part 3: bert_large under a ``follow_generations``
    loader armed only by ``LDDL_TPU_FLEET_DIR`` (this process joins the
    ingest root's fleet as a host). Returns the launch counts."""
    from lddl_tpu_torch.loader import get_bert_pretrain_data_loader
    from lddl_tpu_torch.observability import fleet

    os.environ["LDDL_TPU_FLEET_DIR"] = iroot
    os.environ["LDDL_TPU_FLEET_INTERVAL_S"] = str(FLEET_INTERVAL)
    try:
        loader = get_bert_pretrain_data_loader(
            iroot, vocab_file=vocab, batch_size=INGEST_BATCH,
            fixed_seq_lengths=DATA_BINS, base_seed=12345,
            follow_generations=True)
        steps, _, launches = bert_large_bins(fa, loader, FLEET_STEPS_PER_BIN,
                                             "fleet", card)
        time.sleep(FLEET_INTERVAL * 1.5)  # one more beat: the gauges
        rc, report, agg_s = status_json(iroot)
        me = [h for h, st in report["hosts"].items()
              if os.getpid() in st["pids"]]
        if len(me) != 1:
            raise AssertionError("this process is no host of {}".format(
                sorted(report["hosts"])))
        st = report["hosts"][me[0]]
        if st["closed"] or st["stalled"] \
                or "padding_efficiency" not in st["gauges"]:
            raise AssertionError("the training host reads {}".format(st))
        print("fleet phase, steps: bins reached {} (steps a bin); "
              "launches: {}; this process is host {} of pipeline_status "
              "(exit {}, {:.2f} s): live, heartbeat age {:.2f} s, padding "
              "efficiency {:.4f}, generations loaded {} ({})".format(
                  json.dumps({str(k): v for k, v in sorted(steps.items())}),
                  launches, me[0], rc, agg_s, st["heartbeat_age_s"],
                  st["gauges"]["padding_efficiency"],
                  st["gauges"].get("generations_loaded"), card), flush=True)
        return launches
    finally:
        fleet.heartbeat(closed=True, reason="phase end")
        fleet._reset_for_tests()
        for name in FLEET_ENVS:
            os.environ.pop(name, None)


def fleet_path(fa, card, shared):
    """Phase 13, fleet telemetry under bert_large: the three parts above,
    each timed. Returns the launch counts of part 3's steps."""
    t0 = time.perf_counter()
    fleet_elastic(card, shared)
    t1 = time.perf_counter()
    iroot, _ = fleet_ingest(card, shared)
    t2 = time.perf_counter()
    launches = fleet_steps(fa, card, iroot, shared["elastic_vocab"])
    print("fleet phase parts: elastic {:.1f} s, ingest {:.1f} s, steps "
          "{:.1f} s ({})".format(t1 - t0, t2 - t1, time.perf_counter() - t2,
                                 card), flush=True)
    return launches


# ---------------------------------------------------------------- phase 14


def _part(n, parts, k):
    """The k-th of ``parts`` near-equal contiguous ranges of ``n``."""
    return range(k * n // parts, (k + 1) * n // parts)


def _flat(text):
    """A document's text as the downloaders' contract writes it: every
    run of whitespace one space."""
    return " ".join(text.split())


def download_corpus(root, tokens):
    """Phase 14's corpus: phase 8's generator (seed 4) writes
    DOWNLOAD_BYTES of documents in one file a source; each file's
    documents are then written in that source's upstream form under
    ``root``. Returns ({source: CLI arguments}, {source: [(sort key of
    the input file, [expected source lines])]}, {source: documents}); the
    expected lines are built here, without the port's code, as the
    contract gives them: ``<id> <flattened text>`` each."""
    import io
    import lzma
    import tarfile

    from lddl_tpu_torch.download.common_crawl import ArticleBuffer
    from lddl_tpu_torch.testing import write_text_corpus

    gen = os.path.join(root, "generated")
    write_text_corpus(gen, tokens, DOWNLOAD_BYTES,
                      num_files=len(DOWNLOAD_SOURCES), seed=4)
    docs = {}
    for i, source in enumerate(DOWNLOAD_SOURCES):
        with open(os.path.join(gen, "source", "{}.txt".format(i)),
                  encoding="utf-8") as f:
            docs[source] = [line.rstrip("\n").split(" ", 1)[1] for line in f]
    shutil.rmtree(gen)
    args, inputs = {}, {}

    # Wikipedia: wikiextractor's AA/wiki_NN files; each article opens
    # with <doc ...>, repeats its title, and closes with </doc>.
    wiki = os.path.join(root, "wiki_extracted")
    os.makedirs(os.path.join(wiki, "AA"))
    texts = docs["wikipedia"]
    inputs["wikipedia"] = []
    for k in range(DOWNLOAD_WIKI_FILES):
        name = "wiki_{:02d}".format(k)
        out, lines = [], []
        for i in _part(len(texts), DOWNLOAD_WIKI_FILES, k):
            words = texts[i].split(" ")
            body = "\n".join(" ".join(words[j:j + 40])
                             for j in range(0, len(words), 40))
            out.append('<doc id="{0}" url="https://en.wikipedia.org/wiki?'
                       'curid={0}" title="Article {0}">\nArticle {0}\n\n{1}'
                       '\n</doc>\n'.format(i + 1, body))
            lines.append("wiki-{} {}\n".format(i + 1, _flat(texts[i])))
        with open(os.path.join(wiki, "AA", name), "w",
                  encoding="utf-8") as f:
            f.write("".join(out))
        inputs["wikipedia"].append(("AA/" + name, lines))
    args["wikipedia"] = ["--no-download", "--no-extract", "--extracted-dir",
                         wiki]

    # Books: books1.tar.gz holding books1/epubtxt/<title>.txt, a book of
    # paragraphs; the id is the file name with its spaces replaced.
    texts = docs["books"]
    arc = os.path.join(root, "books1.tar.gz")
    inputs["books"] = []
    with tarfile.open(arc, "w:gz") as tf:
        for k in range(DOWNLOAD_BOOKS):
            name = "Book {:02d} of the corpus.txt".format(k)
            body = "\n\n".join(texts[i] for i in _part(
                len(texts), DOWNLOAD_BOOKS, k))
            data = body.encode("utf-8")
            info = tarfile.TarInfo("books1/epubtxt/" + name)
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
            inputs["books"].append((name, ["{} {}\n".format(
                name.replace(" ", "-"), _flat(body))]))
    args["books"] = ["--local-archive", arc]

    # OpenWebText: openwebtext.tar.xz holding openwebtext/<subset>.xz,
    # each an xz tar of page files; the id is the page's file name.
    texts = docs["openwebtext"]
    owt = os.path.join(root, "owt", "openwebtext")
    os.makedirs(owt)
    inputs["openwebtext"] = []
    for s in range(DOWNLOAD_OWT_SUBSETS):
        subset = "urlsf_subset{:02d}-{}_data".format(s, s + 1)
        buf = io.BytesIO()
        with tarfile.open(fileobj=buf, mode="w") as sub:
            for i in _part(len(texts), DOWNLOAD_OWT_SUBSETS, s):
                page = "{:07d}-{}".format(i, hashlib.md5(
                    texts[i].encode("utf-8")).hexdigest()[:12])
                data = texts[i].replace(". ", ".\n").encode("utf-8")
                info = tarfile.TarInfo(page + ".txt")
                info.size = len(data)
                sub.addfile(info, io.BytesIO(data))
                inputs["openwebtext"].append((
                    "{}/{}.txt".format(subset, page),
                    ["{} {}\n".format(page, _flat(texts[i]))]))
        with lzma.open(os.path.join(owt, subset + ".xz"), "wb") as f:
            f.write(buf.getvalue())
    arc = os.path.join(root, "openwebtext.tar.xz")
    with tarfile.open(arc, "w:xz") as tf:
        tf.add(owt, arcname="openwebtext")
    shutil.rmtree(os.path.dirname(owt))
    args["openwebtext"] = ["--local-archive", arc]

    # Common Crawl: buffer files written by the port's ArticleBuffer, as
    # a crawl writes them (flushed every DOWNLOAD_CC_PER_WRITE articles);
    # the flush counter in each name says which articles it holds.
    texts = docs["common_crawl"]
    per = -(-len(texts) // DOWNLOAD_CC_FILES)
    txt = os.path.join(root, "cc_txt")
    buffer = ArticleBuffer(txt, "cc", articles_per_write=per)
    for i, text in enumerate(texts):
        buffer.add("cc-https://news.example.com/{}".format(i), text)
    buffer.flush()
    inputs["common_crawl"] = []
    for name in sorted(os.listdir(txt)):
        flush = int(name.split("-")[3])
        inputs["common_crawl"].append((name, [
            "cc-https://news.example.com/{} {}\n".format(i, _flat(texts[i]))
            for i in range(flush * per, min(len(texts), (flush + 1) * per))]))
    args["common_crawl"] = ["--no-newsplease", "--txt-dir", txt]
    return args, inputs, {s: sum(len(lines) for _, lines in inputs[s])
                          for s in DOWNLOAD_SOURCES}


def expected_shards(inputs, prefix):
    """{shard file name: bytes} the contract gives: shard k is the parse
    of the sorted inputs' ``[k::DOWNLOAD_SHARDS]``."""
    ordered = sorted(inputs)
    return {"{}{}.txt".format(prefix, k): "".join(
        line for _, lines in ordered[k::DOWNLOAD_SHARDS]
        for line in lines).encode("utf-8")
        for k in range(DOWNLOAD_SHARDS)}


def download_path(fa, card):
    """Phase 14, part 1: the four downloaders' CLIs over local inputs
    (download and extract steps skipped by the reference's flags) ->
    the preprocess CLI over their four source trees -> balance -> the
    loader -> bert_large, 2 steps a bin. Returns (launch counts, the
    preprocess sink, which part 2's status call reads)."""
    import numpy as np
    from lddl_tpu_torch.balance import balance_shards
    from lddl_tpu_torch.loader import get_bert_pretrain_data_loader
    from lddl_tpu_torch.testing import write_vocab
    from lddl_tpu_torch.utils.cpus import usable_cpu_count

    tmp = tempfile.mkdtemp(prefix="chip_smoke_download_")
    vocab = os.path.join(tmp, "vocab.txt")
    tokens = write_vocab(vocab, 30522, seed=0)
    t0 = time.perf_counter()
    args, inputs, counts = download_corpus(tmp, tokens)
    print("download phase: {} bytes of documents (seed 4) written in each "
          "source's upstream form in {:.1f} s: {}".format(
              DOWNLOAD_BYTES, time.perf_counter() - t0,
              json.dumps(counts, sort_keys=True)), flush=True)
    outs = {}
    for source in DOWNLOAD_SOURCES:
        outs[source] = os.path.join(tmp, "dl_" + source)
        secs, seen = run_cli(
            [sys.executable, "-m", "lddl_tpu_torch.download." + source,
             "--outdir", outs[source], "--num-shards", str(DOWNLOAD_SHARDS),
             "--number-of-sharding-processes", str(DOWNLOAD_WORKERS)]
            + args[source], "download " + source)
        prefix = "en-" if source == "wikipedia" else ""
        want = expected_shards(inputs[source], prefix)
        src = os.path.join(outs[source], "source")
        got = {}
        for name in sorted(os.listdir(src)):
            with open(os.path.join(src, name), "rb") as f:
                got[name] = f.read()
        if got != want:
            bad = sorted(n for n in set(got) | set(want)
                         if got.get(n) != want.get(n))
            raise AssertionError("download {}: shards {} differ from the "
                                 "contract's bytes".format(source, bad))
        n_docs = sum(b.count(b"\n") for b in got.values())
        if n_docs != counts[source]:
            raise AssertionError("download {}: {} documents, {} generated"
                                 .format(source, n_docs, counts[source]))
        if seen["cuda_procs"] or not seen["procs"]:
            raise AssertionError(
                "download {}: {} of {} processes opened a CUDA context"
                .format(source, seen["cuda_procs"], seen["procs"]))
        print("download {}: {:.2f} s, {} documents -> {} shards equal to "
              "the contract's bytes ({} bytes); {} of {} processes opened "
              "a CUDA context ({})".format(
                  source, secs, n_docs, len(got),
                  sum(len(b) for b in got.values()), seen["cuda_procs"],
                  seen["procs"], card), flush=True)

    out = os.path.join(tmp, "pre")
    metrics = os.path.join(tmp, "metrics")
    cmd = preprocess_cmd(outs["wikipedia"], vocab, out, "numpy",
                         min(DOWNLOAD_PRE_WORKERS, usable_cpu_count()))
    cmd[cmd.index("--sample-ratio") + 1] = "1.0"
    cmd += ["--books", outs["books"], "--common-crawl",
            outs["common_crawl"], "--open-webtext", outs["openwebtext"]]
    os.environ["LDDL_TPU_METRICS_DIR"] = metrics
    try:
        pre_s, seen = run_cli(cmd, "preprocess (downloaded)")
    finally:
        os.environ.pop("LDDL_TPU_METRICS_DIR", None)
    read = metric_total(metrics, "preprocess_docs_total")
    if read != sum(counts.values()) or seen["cuda_procs"]:
        raise AssertionError("preprocess read {} of {} downloaded documents"
                             " ({} CUDA processes)".format(
                                 read, sum(counts.values()),
                                 seen["cuda_procs"]))
    print("download phase: preprocess (numpy, sample ratio 1.0) read {} of "
          "{} downloaded documents in {:.1f} s; {} of {} processes opened "
          "a CUDA context ({})".format(read, sum(counts.values()), pre_s,
                                       seen["cuda_procs"], seen["procs"],
                                       card), flush=True)
    for source in DOWNLOAD_SOURCES:
        shutil.rmtree(outs[source])

    bal = os.path.join(tmp, "balanced")
    t0 = time.perf_counter()
    shard_counts = balance_shards(out, bal, DOWNLOAD_BAL_SHARDS)
    balance_s = time.perf_counter() - t0
    print("download phase: balance to {} shards ({} a bin) in {:.1f} s "
          "({})".format(len(shard_counts), DOWNLOAD_BAL_SHARDS, balance_s,
                        card), flush=True)

    t_steps = time.perf_counter()
    steps, timed, launches = bert_large_bins(
        fa, get_bert_pretrain_data_loader(
            bal, vocab_file=vocab, batch_size=16,
            fixed_seq_lengths=DATA_BINS, base_seed=12345),
        DOWNLOAD_STEPS_PER_BIN, "download", card)
    steps_s = time.perf_counter() - t_steps
    if len(steps) != len(DATA_BINS):
        raise AssertionError("download steps reached bins {} of {}".format(
            sorted(steps), DATA_BINS))
    print("download phase: bins reached {} (steps a bin); bert_large step "
          "{:.1f} ms mean of {} (each bin's first excluded), steps part "
          "{:.1f} s; launches: {} ({})".format(
              json.dumps({str(k): v for k, v in sorted(steps.items())}),
              float(np.mean(timed)) * 1e3, len(timed), steps_s, launches,
              card), flush=True)
    shutil.rmtree(bal)
    return launches, tmp, out


def lddl_check(*extra):
    """``python -m lddl_tpu_torch.tools.lddl_check`` in a process of its
    own, from the repo root, which must exit 0: (its JSON report, or None
    without ``--json``; seconds)."""
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "lddl_tpu_torch.tools.lddl_check", *extra],
        capture_output=True, text=True, timeout=300, cwd=root,
        env=fleet_env())
    secs = time.perf_counter() - t0
    report = json.loads(proc.stdout) if "--json" in extra \
        and proc.stdout.strip().startswith("{") else None
    if proc.returncode != 0:
        raise AssertionError("lddl_check {} exited {}:\n{}\n{}".format(
            " ".join(extra), proc.returncode, proc.stdout[-3000:],
            proc.stderr[-2000:]))
    return report, secs


def analyzer_path(card, sink):
    """Phase 14, part 2, on the card's host: the port's analyzer over the
    tree as shipped, cold (no cache) writing the port's SARIF, then with
    its cache (filled, then warm); ``pipeline_status`` over part 1's
    sink must carry its verdict. The cache and SARIF it writes at the
    repo root are removed after."""
    from collections import Counter

    from lddl_tpu_torch import analysis

    root = os.path.dirname(os.path.abspath(__file__))
    sarif = os.path.join(root, analysis.DEFAULT_SARIF)
    cache = os.path.join(root, analysis.DEFAULT_CACHE)
    for path in (sarif, cache):
        if os.path.exists(path):
            os.unlink(path)
    try:
        cold, cold_s = lddl_check("--no-cache", "--json", "--sarif", sarif)
        fill, fill_s = lddl_check("--json")
        warm, warm_s = lddl_check("--json")
        if cold["findings"] or not cold["ok"] \
                or warm["files_cached"] != warm["files"] \
                or fill["files_cached"] != 0 \
                or [warm[k] for k in ("findings", "baselined")] != \
                [cold[k] for k in ("findings", "baselined")]:
            raise AssertionError("analyzer runs disagree: cold {} / warm "
                                 "{}".format(cold, warm))
        rc, report, status_s = status_json(sink)
        sa = report.get("static_analysis")
        if rc != 0 or not sa or sa["new"] != 0 \
                or sa["rules_enabled"] != len(analysis.RULE_IDS) \
                or sa["baselined"] != len(cold["baselined"]):
            raise AssertionError("pipeline_status ({}) static analysis: {}"
                                 .format(rc, sa))
        by_rule = {k: dict(sorted(Counter(
            f["rule"] for f in cold[k]).items()))
            for k in ("findings", "baselined", "suppressed")}
        print("analyzer: {} files, cold (no cache) {:.2f} s (its own clock "
              "{:.2f} s), cache fill {:.2f} s, warm {:.2f} s ({} of {} files "
              "cached, its own clock {:.2f} s); findings by rule: new {}, "
              "baselined {}, suppressed {}; pipeline_status static_analysis "
              "{} in {:.2f} s ({})".format(
                  cold["files"], cold_s, cold["elapsed_s"], fill_s, warm_s,
                  warm["files_cached"], warm["files"], warm["elapsed_s"],
                  json.dumps(by_rule["findings"]),
                  json.dumps(by_rule["baselined"]),
                  json.dumps(by_rule["suppressed"]),
                  json.dumps(sa, sort_keys=True), status_s, card),
              flush=True)
        return {"cold_s": cold_s, "warm_s": warm_s}
    finally:
        for path in (sarif, cache):
            if os.path.exists(path):
                os.unlink(path)


def download_and_analyzer_path(fa, card):
    """Phase 14: all four stages from the downloaders on (part 1), then
    the analyzer (part 2), each timed. Returns part 1's launch counts."""
    t0 = time.perf_counter()
    launches, tmp, sink = download_path(fa, card)
    try:
        t1 = time.perf_counter()
        analyzer_path(card, sink)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print("download phase parts: four stages {:.1f} s, analyzer {:.1f} s "
          "({})".format(t1 - t0, time.perf_counter() - t1, card), flush=True)
    return launches


def pipeline_path(fa, card):
    """bert_large's encoder as a GPipe pipeline on the card: a world of 1
    over NCCL, a {pp: 1, dp: 1} mesh, the 24 layers of a seeded
    bert_large (LayerNorm scales and biases drawn from a seed, so the
    loss depends on every layer) stacked into ``make_pipelined_encoder``
    (``PIPE_MICRO`` microbatches) and ``reference_encoder``; x the
    model's embeddings of a batch of 16 at L=512 from phase 4's shards,
    mask its padded attention mask. Holds the forward and the gradients
    of mean(y.float()**2) for x and every layer parameter, pipelined
    against unpipelined, to PIPE_BAR; counts the single-block kernels of
    each; times both. Returns the pipelined run's launch counts."""
    import torch.distributed as dist

    from lddl_tpu_torch.loader import (get_bert_pretrain_data_loader,
                                       prefetch_to_device)
    from lddl_tpu_torch.models import BertConfig, BertForPreTraining
    from lddl_tpu_torch.parallel import (init_distributed, make_mesh,
                                         make_pipelined_encoder,
                                         reference_encoder,
                                         stack_layer_params)
    from lddl_tpu_torch.testing import write_balanced_shards, write_vocab

    device = init_distributed(
        init_method="tcp://127.0.0.1:{}".format(free_port()), world_size=1,
        rank=0)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_pipe_")
    try:
        if dist.get_backend() != "nccl" or device != torch.device("cuda", 0):
            raise AssertionError("want nccl on cuda:0")
        mesh = make_mesh({"pp": 1, "dp": 1})
        vocab = os.path.join(tmp, "vocab.txt")
        tokens = write_vocab(vocab, 30522, seed=0)
        write_balanced_shards(os.path.join(tmp, "shards"), tokens,
                              num_bins=len(BINS), bin_size=128,
                              shards_per_bin=2, samples_per_shard=64,
                              masking=True, seed=0)
        loader = get_bert_pretrain_data_loader(
            os.path.join(tmp, "shards"), vocab_file=vocab, batch_size=16,
            fixed_seq_lengths=BINS, shuffle_buffer_size=256,
            shuffle_buffer_warmup_factor=4, base_seed=12345)
        it = iter(prefetch_to_device(loader))
        try:
            batch = next(b for b in it if b["input_ids"].shape[1] == 512)
        finally:
            it.close()
        mask = batch["attention_mask"]
        pad = 1.0 - float(mask.float().mean())
        if pad <= 0:
            raise AssertionError("the L=512 batch has no padding")

        torch.manual_seed(0)
        cfg = BertConfig.bert_large(attention_dropout=0.0,
                                    attention_impl="auto")
        with torch.device("cuda"):
            model = BertForPreTraining(cfg).eval()
        with torch.no_grad():
            x = model.embeddings(batch["input_ids"], batch["token_type_ids"])
        stacked = stack_layer_params(model.state_dict(), cfg.num_layers)
        del model
        g = torch.Generator(device="cuda").manual_seed(1)
        for rest, t in stacked.items():
            if rest.endswith("norm.weight") or rest.endswith("norm.bias"):
                t.copy_((1.0 if rest.endswith("weight") else 0.0)
                        + 0.5 * torch.randn(t.shape, generator=g,
                                            device="cuda"))
        with torch.device("cuda"):
            pipe = make_pipelined_encoder(mesh, cfg, PIPE_MICRO)
            flat = reference_encoder(cfg)
        pipe.load_stacked(stacked)
        flat.load_stacked(stacked)
        del stacked

        def run(module):
            xi = x.detach().clone().requires_grad_()
            module.zero_grad(set_to_none=True)
            y = module(xi, mask)
            y.float().pow(2).mean().backward()
            torch.cuda.synchronize()
            return y.detach(), xi.grad

        zero_launches(fa)
        y_p, gx_p = run(pipe)
        launches = read_launches(fa)
        zero_launches(fa)
        y_f, gx_f = run(flat)
        flat_launches = read_launches(fa)
        want = cfg.num_layers * PIPE_MICRO
        print("pipelined encoder launches {}; unpipelined {}".format(
            launches, flat_launches), flush=True)
        if launches != dict.fromkeys(KERNELS, 0) | {
                "onekv_fwd": want, "onekv_bwd": want}:
            raise AssertionError("the pipelined encoder launched {} (want "
                                 "{} of each single-block kernel)".format(
                                     launches, want))
        if flat_launches != dict.fromkeys(KERNELS, 0) | {
                "onekv_fwd": cfg.num_layers, "onekv_bwd": cfg.num_layers}:
            raise AssertionError("the unpipelined stack launched {}".format(
                flat_launches))

        def err(a, b):
            return float((a.float() - b.float()).abs().max()), float(
                b.float().abs().max())

        checks = {"y": err(y_p, y_f), "gx": err(gx_p, gx_f)}
        grads_f = dict(flat.named_parameters())
        layer_max = {}
        for name, p in flat.named_parameters():
            layer = name.split(".")[0]
            layer_max[layer] = max(layer_max.get(layer, 0.0),
                                   float(p.grad.abs().max()))
        for name, p in pipe.named_parameters():
            diff, scale = err(p.grad, grads_f[name].grad)
            if name.endswith("attention.key.bias"):
                scale = layer_max[name.split(".")[0]]
            checks[name] = (diff, scale)
        if not all(torch.isfinite(t).all() for t in (y_p, gx_p)):
            raise AssertionError("non-finite pipelined output or gx")
        ratios = {k: d / s if s > 0 else math.inf
                  for k, (d, s) in checks.items()}
        worst = sorted(ratios, key=ratios.get)[-3:]
        print("pipelined vs unpipelined (pp=1, n_micro={}, B=16, L=512, pad "
              "share {:.4f}): y max |diff| {:.3e} of max {:.3e}; gx {:.3e} of "
              "{:.3e}; {} layer gradients, worst {} (bar {})".format(
                  PIPE_MICRO, pad, *checks["y"], *checks["gx"],
                  len(checks) - 2, {k: "{:.3e}".format(ratios[k])
                                    for k in worst}, PIPE_BAR), flush=True)
        bad = {k: r for k, r in ratios.items() if not r <= PIPE_BAR}
        if bad or len(checks) - 2 != len(grads_f):
            raise AssertionError("pipelined and unpipelined disagree: {}"
                                 .format(bad))
        del y_p, gx_p, y_f, gx_f

        times = {"pipelined": [], "unpipelined": []}
        for i in range(PIPE_REPEATS + 1):
            for what, module in (("pipelined", pipe), ("unpipelined", flat)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run(module)
                if i:
                    times[what].append(time.perf_counter() - t0)
        ms = {k: 1e3 * sum(v) / len(v) for k, v in times.items()}
        print("bert_large encoder forward + backward, B=16, L=512: pipelined "
              "(pp=1, n_micro={}) {:.2f} ms, unpipelined {:.2f} ms, ratio "
              "{:.3f}, mean of {} each after a warm-up, host clock ({})"
              .format(PIPE_MICRO, ms["pipelined"], ms["unpipelined"],
                      ms["pipelined"] / ms["unpipelined"], PIPE_REPEATS,
                      card), flush=True)
        del pipe, flat
        torch.cuda.empty_cache()
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        dist.destroy_process_group()


def run_smoke(name):
    """One CI smoke (``python -m lddl_tpu_torch.tools.<name>_smoke``) at
    its default size through ``watched``: (seconds, exit code, its JSON
    report or None, the pids of its processes that mapped the CUDA
    driver, the smoke process itself included, every pid seen, stderr's
    tail)."""
    secs, rc, stdout, stderr, _, watch = watched(
        [sys.executable, "-m", "lddl_tpu_torch.tools.{}_smoke".format(name)],
        timeout=SMOKE_TIMEOUT)
    lines = stdout.strip().splitlines()
    try:
        report = json.loads(lines[-1]) if lines else None
    except ValueError:
        report = None
    return (secs, rc, report, sorted(watch.cuda_pids), watch.procs,
            stderr[-4000:])


def smoke_contract(name, rc, report):
    """None when a smoke's result holds its contract, else what broke it:
    exit 0 and ``identical: true``, or for the status smoke (which
    compares no bytes) exit 0 and its alert fired and resolved."""
    if rc != 0 or report is None:
        return "exit {}, report {}".format(rc, report)
    key = "alert_fire_resolve" if name == "status" else "identical"
    if report.get(key) is not True:
        return "{} is {!r}".format(key, report.get(key))
    if name == "backend" and report.get("loader_identical") is not True:
        return "loader_identical is {!r}".format(
            report.get("loader_identical"))
    return None


def smoke_device_batches(fa, card):
    """Phase 20 part (2): the cache smoke's dataset (``cache_smoke.build``
    at its default size) published on the mock store with
    LDDL_TPU_MOCK_LATENCY_MS, loaded onto the card through
    ``prefetch_to_device`` under the smoke's sync leg and its default
    (prefetch + cache) leg; the two legs' device batches must be equal
    bit for bit. Then SMOKE_STEPS bert_large train steps (phase 4's model)
    on the default leg's batches, each with a finite loss. Returns the
    launch counts of those steps."""
    from lddl_tpu_torch.loader import (get_bert_pretrain_data_loader,
                                       prefetch_to_device)
    from lddl_tpu_torch.models import (BertConfig, BertForPreTraining,
                                       make_optimizer, make_train_step)
    from lddl_tpu_torch.resilience import backend
    from lddl_tpu_torch.tools import cache_smoke

    knobs = {"LDDL_TPU_STORAGE_BACKEND": "mock",
             "LDDL_TPU_MOCK_LATENCY_MS": SMOKE_LATENCY_MS}
    saved = {k: os.environ.get(k) for k in knobs}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ci_")
    os.environ.update(knobs)
    # The store reads its latency when it is made: make it under the knob.
    backend._instances.pop("mock", None)
    try:
        t0 = time.perf_counter()
        bal, vocab = cache_smoke.build(
            tmp, float(os.environ.get("LDDL_TPU_CACHE_SMOKE_MB", "0.5")))
        build_s = time.perf_counter() - t0
        legs, secs = {}, {}
        for name, env in cache_smoke.LEGS[:2]:
            with cache_smoke.leg_env(env):
                loader = get_bert_pretrain_data_loader(
                    bal, vocab_file=vocab, batch_size=SMOKE_BATCH,
                    num_workers=0, fixed_seq_lengths=SMOKE_L)
                t0 = time.perf_counter()
                it = iter(prefetch_to_device(loader))
                try:
                    legs[name] = list(it)
                finally:
                    it.close()
                torch.cuda.synchronize()
                secs[name] = time.perf_counter() - t0
        sync, cold = (legs[n] for n, _ in cache_smoke.LEGS[:2])
        if not sync or len(sync) != len(cold):
            raise AssertionError("device batches: {} against {}".format(
                len(sync), len(cold)))
        differ = [i for i, (a, b) in enumerate(zip(sync, cold))
                  if a.keys() != b.keys()
                  or not all(a[k].is_cuda and torch.equal(a[k], b[k])
                             for k in a)]
        if differ:
            raise AssertionError("device batches differ between the sync "
                                 "and the prefetch+cache legs at {}".format(
                                     differ[:8]))
        print("ci smokes (2): the cache smoke's {} shards on the mock store "
              "({} ms a data op) built in {:.1f} s; {} device batches of "
              "{} x {} equal bit for bit across the sync leg ({:.2f} s) and "
              "the prefetch+cache leg ({:.2f} s) ({})".format(
                  cache_smoke.SHARDS, SMOKE_LATENCY_MS, build_s, len(sync),
                  SMOKE_BATCH, SMOKE_L, secs["sync"],
                  secs["prefetch_cold"], card), flush=True)

        torch.manual_seed(0)
        cfg = BertConfig.bert_large(attention_dropout=0.0,
                                    attention_impl="auto")
        if max(int(b["input_ids"].max()) for b in cold) >= cfg.vocab_size:
            raise AssertionError("a token id beyond bert_large's vocab")
        with torch.device("cuda"):
            model = BertForPreTraining(cfg)
        opt = make_optimizer(model.parameters(), learning_rate=1e-4,
                             warmup_steps=4, total_steps=100)
        step = make_train_step(model, opt)
        zero_launches(fa)
        for i, batch in enumerate(cold[:SMOKE_STEPS]):
            t0 = time.perf_counter()
            loss = float(step(batch)["loss"])   # syncs the device
            ms = 1e3 * (time.perf_counter() - t0)
            if not math.isfinite(loss):
                raise AssertionError("non-finite loss {} at step {}".format(
                    loss, i))
            print("ci smokes (2): bert_large step {} L={} loss={:.4f} "
                  "{:.1f} ms (host clock; the first a warm-up) ({})".format(
                      i, batch["input_ids"].shape[1], loss, ms, card),
                  flush=True)
        launches = read_launches(fa)
        want = cfg.num_layers * SMOKE_STEPS
        if launches != dict.fromkeys(KERNELS, 0) | {"onekv_fwd": want,
                                                    "onekv_bwd": want}:
            raise AssertionError("launch counts {} != {} of onekv_fwd and "
                                 "onekv_bwd".format(launches, want))
        print("ci smokes (2): launches over {} steps: {}".format(
            SMOKE_STEPS, launches), flush=True)
        return launches
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        backend._instances.pop("mock", None)
        shutil.rmtree(tmp, ignore_errors=True)


def smokes_path(fa, card):
    """Phase 20: (1) the six CI identity smokes in processes of their own
    at their default sizes, each holding its contract with no process
    that mapped the CUDA driver; (2) ``smoke_device_batches``. Returns
    part (2)'s launch counts."""
    t_all = time.perf_counter()
    for name in SMOKES:
        secs, rc, report, holders, procs, stderr = run_smoke(name)
        broken = smoke_contract(name, rc, report)
        if broken:
            raise AssertionError("{} smoke: {}:\n{}".format(name, broken,
                                                           stderr))
        if holders:
            raise AssertionError("{} smoke: processes {} mapped the CUDA "
                                 "driver".format(name, holders))
        _, left = cuda_holders()
        if set(left) & procs:
            raise AssertionError("{} smoke: processes {} still hold the "
                                 "CUDA driver".format(name,
                                                      set(left) & procs))
        print("ci smokes (1): {} {:.1f} s, exit {}, {} processes, none "
              "with the CUDA driver mapped: {} ({})".format(
                  name, secs, rc, len(procs),
                  json.dumps(report, sort_keys=True), card), flush=True)
    part1 = time.perf_counter() - t_all
    t0 = time.perf_counter()
    launches = smoke_device_batches(fa, card)
    print("ci smokes: part (1) {:.1f} s, part (2) {:.1f} s ({})".format(
        part1, time.perf_counter() - t0, card), flush=True)
    return launches


def harness_recipe(card):
    """Phase 21 part (1): ``lddl_tpu_torch/examples/local_example.sh`` at
    its defaults (DATA in a temporary directory) through ``watched``:
    every stage exits 0 (the recipe stops at the first that fails), the
    eight banners, ``validate_seqlen``'s PASS, and no process of the
    recipe with the CUDA driver mapped."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_recipe_")
    try:
        data = os.path.join(tmp, "data")
        secs, rc, stdout, stderr, _, watch = watched(
            ["bash", HARNESS_RECIPE], timeout=HARNESS_TIMEOUT,
            env={"DATA": data})
        if rc != 0:
            raise AssertionError("the recipe failed ({}):\n{}\n{}".format(
                rc, stdout[-3000:], stderr[-3000:]))
        banners = [ln.split(".")[0][3:] for ln in stdout.splitlines()
                   if ln.startswith("== ")]
        if banners != [str(i) for i in range(1, 9)] or \
                stdout.splitlines()[-1] != "example complete: " + data:
            raise AssertionError("the recipe's stages: {}".format(banners))
        verdict = stdout.split("== 6.")[1].split("== 7.")[0].strip()
        if verdict.splitlines()[-1] != "PASS":
            raise AssertionError("validate_seqlen: {}".format(verdict))
        if watch.cuda_pids:
            raise AssertionError("recipe processes {} mapped the CUDA "
                                 "driver".format(sorted(watch.cuda_pids)))
        for line in stdout.splitlines():
            if line.startswith(("loader sustained", "padded-zero",
                                "packed:", "preprocess done",
                                "balanced ", "corpus bytes")):
                print("harness (1): {}".format(line), flush=True)
        print("harness (1): the recipe's 8 stages in {:.1f} s, {} "
              "processes, none with the CUDA driver mapped; "
              "validate_seqlen PASS ({})".format(
                  secs, len(watch.procs), card), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def median_by_len(lens, ms, skip=2):
    """{L: the median of ``ms`` over the steps at L}, the first ``skip``
    steps left out."""
    out = {}
    for n, (length, t) in enumerate(zip(lens, ms)):
        if n >= skip:
            out.setdefault(length, []).append(t)
    return {k: round(sorted(v)[len(v) // 2], 2)
            for k, v in sorted(out.items())}


def harness_run(fa, card, label, argv, want):
    """One ``mock_train.run`` on ``argv``, the launch counters zeroed just
    before and read just after: the last loss must be finite and the
    counts ``want(summary)`` (counter: launches), every other counter 0.
    Returns the counts."""
    from lddl_tpu_torch.tools import mock_train
    args = mock_train.attach_args().parse_args(argv)
    zero_launches(fa)
    t0 = time.perf_counter()
    summary = mock_train.run(args)
    secs = time.perf_counter() - t0
    launches = read_launches(fa)
    losses = summary["losses"]
    if not losses or not math.isfinite(losses[-1]):
        raise AssertionError("harness {}: losses {}".format(label,
                                                            losses[-4:]))
    expected = dict.fromkeys(KERNELS, 0) | want(summary)
    if launches != expected:
        raise AssertionError("harness {}: launch counts {} != {}".format(
            label, launches, expected))
    print("harness (2) {}: {} steps, train step {:.2f} ms avg (host "
          "clock, the first two excluded; median by L {}), loader "
          "sustained {:.1f} samples/s, losses {:.4f} -> {:.4f}, launches "
          "{}, {:.1f} s ({})".format(
              label, len(losses), summary["step_ms"],
              median_by_len(summary["batch_lens"],
                            summary["step_ms_each"]),
              summary["sustained"], losses[0], losses[-1],
              {k: v for k, v in launches.items() if v}, secs, card),
          flush=True)
    return launches


def harness_path(fa, card):
    """Phase 21: (1) ``harness_recipe``; (2) ``mock_train --with-model
    base`` on the card: bert_base binned (the single-block pair 12 times
    each a step, one a layer), on load-time packed rows (the same), and
    bart_base at L=1024 (the online trio 6 times each a step, one an
    encoder layer). The presets keep attention dropout 0.1, which pins
    "auto" to dense in both packages, so the runs ask for flash. Returns
    the launches summed over the three runs."""
    from lddl_tpu_torch.testing import (write_balanced_shards,
                                        write_bart_shards,
                                        write_unbinned_shards, write_vocab)
    t0 = time.perf_counter()
    harness_recipe(card)
    part1 = time.perf_counter() - t0
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_harness_")
    try:
        vocab = os.path.join(tmp, "vocab.txt")
        tokens = write_vocab(vocab, 30522, seed=0)
        write_balanced_shards(os.path.join(tmp, "bal"), tokens, seed=1,
                              **HARNESS_BINNED)
        write_unbinned_shards(os.path.join(tmp, "unb"), tokens, seed=2,
                              **HARNESS_UNBINNED)
        write_bart_shards(os.path.join(tmp, "bart"), len(tokens), seed=3,
                          **HARNESS_BART)
        common = ["--vocab-file", vocab, "--epochs", "1", "--with-model",
                  "base", "--attention-impl", "flash"]
        single = ("onekv_fwd", "onekv_bwd")
        runs = [
            ("bert_base binned",
             ["--path", os.path.join(tmp, "bal"), "--batch-size", "16",
              "--fixed-seq-lengths"] + HARNESS_BINS + [
                  "--seq-len-dir", os.path.join(tmp, "lens")],
             lambda s: dict.fromkeys(single, 12 * len(s["losses"]))),
            ("bert_base packed",
             ["--path", os.path.join(tmp, "unb"), "--batch-size", "16",
              "--pack-seq-length", "512", "--pack-rows", "16"],
             lambda s: dict.fromkeys(single, 12 * len(s["losses"]))),
            ("bart_base",
             ["--family", "bart", "--path", os.path.join(tmp, "bart"),
              "--batch-size", "8", "--fixed-seq-lengths", "1024"],
             lambda s: dict.fromkeys(ONLINE_KERNELS, 6 * len(s["losses"]))),
        ]
        total = dict.fromkeys(KERNELS, 0)
        for label, argv, want in runs:
            for k, v in harness_run(fa, card, label, argv + common,
                                    want).items():
                total[k] += v
        from lddl_tpu_torch.tools import validate_seqlen
        validate_seqlen.main(["--seq-len-dir", os.path.join(tmp, "lens"),
                              "--bin-size", "128"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print("harness: part (1) {:.1f} s, part (2) {:.1f} s ({})".format(
        part1, time.perf_counter() - t0, card), flush=True)
    return total


# The fp32 kernels and the head dims each is built at, by source: the two
# 3xTF32 libraries (fa.f32_source routes the entry points between them).
F32_KERNELS = {
    "attention_f32_fwd": {"onekv_fwd": (64, 128),
                          "online_fwd": (64, 128, 256)},
    "attention_f32_bwd": {"onekv_bwd_dkv": (64, 128),
                          "onekv_bwd_dq": (64, 128),
                          "online_bwd_dq": (64, 128, 256),
                          "online_bwd_dkv": (64, 128, 256)},
}


def check_f32_builds(fa, libs):
    """Phase 2's fp32 part: ptxas's summary of every fp32 kernel at every
    width, which must spill 0 bytes, and each library's TF32 HGMMA in
    every kernel at every width (the 3xTF32 products)."""
    from lddl_tpu_torch.ops import _build
    for source, kernels in F32_KERNELS.items():
        regs = ptxas_summary(_build.build_logs.get(source, ""))
        for kernel, widths in kernels.items():
            for d in widths:
                summary = regs.get((kernel + "_f32_kernel", d),
                                   "not reported")
                print("ptxas summary {} {}_f32_kernel<{}>: {}".format(
                    source, kernel, d, summary), flush=True)
                if " 0 bytes spill stores, 0 bytes spill loads" \
                        not in " " + summary:
                    raise AssertionError("{}_f32_kernel<{}> spills or was "
                                         "not reported: {}".format(
                                             kernel, d, summary))
        hgmma = {fn: sum(n for op, n in c.items()
                         if op.startswith("HGMMA.") and ".TF32" in op)
                 for fn, c in sass_opcodes(libs[source], full=True).items()}
        for fn, n in sorted(hgmma.items()):
            print("sass {}: {} TF32 HGMMA in {}".format(source, n, fn),
                  flush=True)
        for kernel, widths in kernels.items():
            fns = [fn for fn in hgmma if kernel + "_f32_kernel" in fn]
            if len(fns) != len(widths) or not all(hgmma[fn] for fn in fns):
                raise AssertionError("{}_f32_kernel: TF32 HGMMA in the SASS "
                                     "of {} (want {} widths)".format(
                                         kernel, {fn: hgmma[fn]
                                                  for fn in fns},
                                         len(widths)))


def main():
    global torch
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    kernels_only = sys.argv[1:] == ["--kernels-only"]
    if sys.argv[1:] and not kernels_only:
        print("usage: chip_smoke.py [--kernels-only]", file=sys.stderr)
        return 2
    card = card_line()
    print("torch {} CUDA {}".format(torch.__version__, torch.version.cuda),
          flush=True)

    from lddl_tpu_torch.ops import _build
    from lddl_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    libs = _build.build(["attention_fwd", "online_attention_bwd",
                         fa.F32_FWD_SOURCE, fa.F32_BWD_SOURCE])
    print("build: {:.1f} s (one nvcc for each source not built yet, in "
          "parallel; with the D=256 instantiations of the three online "
          "kernels and the fp32 builds of all five)".format(
              time.perf_counter() - t0), flush=True)
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling",
                                       "warning", "wgmma", "setmaxnreg")):
                print("ptxas {}: {}".format(name, line.strip()), flush=True)
    for lib, wanted in (("attention_fwd", ("onekv_fwd_kernel",
                                           "online_fwd_kernel")),
                        ("online_attention_bwd", ("online_bwd_dq_kernel",
                                                  "online_bwd_dkv_kernel",
                                                  "onekv_bwd_dq_kernel",
                                                  "onekv_bwd_dkv_kernel"))):
        regs = ptxas_summary(_build.build_logs.get(lib, ""))
        for kernel in wanted:
            for d in (64, 128, 256):
                if d == 256 and kernel.startswith("onekv"):
                    continue    # the single-block regime stops at D=128
                print("ptxas summary {}<{}>: {}".format(
                    kernel, d, regs.get((kernel, d), "not reported")),
                    flush=True)
                if d == 256 and " 0 bytes spill stores, 0 bytes spill " \
                        "loads" not in " " + regs.get((kernel, d), ""):
                    raise AssertionError("{}<256> spills or was not "
                                         "reported: {}".format(
                                             kernel, regs.get((kernel, d))))
        hgmma = {fn: ops["HGMMA"]
                 for fn, ops in sass_opcodes(libs[lib]).items()}
        for fn, n in sorted(hgmma.items()):
            print("sass {}: {} HGMMA in {}".format(lib, n, fn), flush=True)
        for kernel in wanted:
            found = [n for fn, n in hgmma.items() if kernel in fn]
            if not found or min(found) == 0:
                raise AssertionError("no HGMMA in the SASS of {}: {}".format(
                    kernel, hgmma))
    check_f32_builds(fa, libs)

    kernels = (check_kernels(fa) + check_online_kernels(fa)
               + check_f32_kernels(fa))
    check_padded_widths(fa)
    backward_by_length(fa)
    by_name = {e["name"]: e for e in kernels}
    # (the wrapper's counter, which paths it counts) of each entry
    counting = {n: (e.pop("counter", n),
                    e.pop("counts_path", lambda path: True))
                for n, e in by_name.items()}
    print("forward kernels: " + "; ".join(
        "{} {:.4f} ms vs library {:.4f} ms, ratio {:.2f}".format(
            n, by_name[n]["ms"], by_name[n]["library_ms"],
            by_name[n]["ms"] / by_name[n]["library_ms"])
        for n in ("online_fwd", "onekv_fwd")), flush=True)
    if kernels_only:
        print(json.dumps({"kernels": kernels}))
        return 0
    by_path = {}
    shared = {}  # what 11-12 leave for 13, 4 for 17, 6 for 16, 18-19
    phases = [("4", "bert_binned", lambda: bert_path(fa, card, shared)),
              ("5", "bert_packed", lambda: packed_path(fa, card)),
              ("6", "bart", lambda: bart_path(fa, card, shared)),
              ("7", "bert_sharded", lambda: distributed_path(fa, card)),
              ("8-9", ("bert_data", "bert_loader"),
               lambda: data_path(fa, card)),
              ("10", "bart_data", lambda: bart_data_path(fa, card)),
              ("11", "bert_ingest", lambda: ingest_path(fa, card, shared)),
              ("12", "bert_elastic", lambda: elastic_path(fa, card, shared)),
              ("13", "fleet", lambda: fleet_path(fa, card, shared)),
              ("14", "download",
               lambda: download_and_analyzer_path(fa, card)),
              ("15", "pipeline", lambda: pipeline_path(fa, card)),
              ("16", D256_PATH,
               lambda: bart_path(fa, card, shared, BART_D256_HEADS)),
              ("17", "bert_f32",
               lambda: bert_path(fa, card, shared, torch.float32)),
              ("18", "bart_f32",
               lambda: bart_path(fa, card, shared, dtype=torch.float32)),
              ("19", F32_D256_PATH,
               lambda: bart_path(fa, card, shared, BART_D256_HEADS,
                                 dtype=torch.float32)),
              ("20", "ci_smokes", lambda: smokes_path(fa, card)),
              ("21", "harness", lambda: harness_path(fa, card))]
    try:
        for number, path, run in phases:
            t0 = time.perf_counter()
            if isinstance(path, tuple):
                by_path.update(zip(path, run()))
            else:
                by_path[path] = run()
            print("phase {} ({}): {:.1f} s".format(
                number, path if isinstance(path, str) else "+".join(path),
                time.perf_counter() - t0), flush=True)
    finally:
        if "elastic_tmp" in shared:
            shutil.rmtree(shared["elastic_tmp"], ignore_errors=True)
    for entry in kernels:
        counter, counts_path = counting[entry["name"]]
        entry["launches_by_path"] = {
            path: counts[counter] for path, counts in by_path.items()
            if counts_path(path)}
        entry["launches"] = sum(entry["launches_by_path"].values())
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
