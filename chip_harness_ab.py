#!/usr/bin/env python3
"""Does the loader harness add to the step it times? On one card.

``python3 chip_harness_ab.py`` builds the two bf16 kernel sources, writes
``chip_smoke.py`` phase 21's binned shards (bert_base's 30522-token vocab,
4 bins of 128 tokens, 2 shards of 64 samples a bin) and runs
``lddl_tpu_torch.tools.mock_train`` with ``--with-model base`` at batch
16 over the bins 128-512: twice with flash attention (a cold and a warm
run), once with ``auto`` (the presets' attention dropout 0.1 keeps it
dense) and once with flash over two epochs. Then it loads the same
batches onto the card through ``prefetch_to_device`` and times the same
train step (``make_train_step`` of a ``bert_base`` built from seed 0)
over them in a bare loop, flash and auto. Each step is timed on the host
clock around the step and ``float(loss)``, as the harness times it.
Prints one line a run: the mean without the first two steps, the median
by L (the first two steps left out) and every step, then the card line.
"""

import os
import shutil
import sys
import tempfile
import time


def main():
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    os.chdir(root)
    import torch
    if not torch.cuda.is_available():
        print("chip_harness_ab: no CUDA device is available",
              file=sys.stderr)
        return 1
    import chip_smoke as cs
    cs.torch = torch
    card = cs.card_line()
    from lddl_tpu_torch.loader import (get_bert_pretrain_data_loader,
                                       prefetch_to_device)
    from lddl_tpu_torch.models import (BertConfig, BertForPreTraining,
                                       make_optimizer, make_train_step)
    from lddl_tpu_torch.ops import _build
    from lddl_tpu_torch.testing import write_balanced_shards, write_vocab
    from lddl_tpu_torch.tools import mock_train
    _build.build(["attention_fwd", "online_attention_bwd"])
    tmp = tempfile.mkdtemp(prefix="chip_harness_ab_")
    try:
        vocab = os.path.join(tmp, "vocab.txt")
        bal = os.path.join(tmp, "bal")
        tokens = write_vocab(vocab, 30522, seed=0)
        write_balanced_shards(bal, tokens, seed=1, **cs.HARNESS_BINNED)
        base = ["--path", bal, "--vocab-file", vocab, "--epochs", "1",
                "--with-model", "base", "--batch-size", "16",
                "--fixed-seq-lengths"] + cs.HARNESS_BINS
        for label, extra in (("flash 1", ["--attention-impl", "flash"]),
                             ("flash 2", ["--attention-impl", "flash"]),
                             ("auto", []),
                             ("flash, 2 epochs", ["--attention-impl",
                                                  "flash", "--epochs",
                                                  "2"])):
            s = mock_train.run(mock_train.attach_args().parse_args(
                base + extra))
            print("ab harness {}: {:.2f} ms avg, median by L {}, every "
                  "step {} ({})".format(
                      label, s["step_ms"],
                      cs.median_by_len(s["batch_lens"],
                                       s["step_ms_each"]),
                      [round(x, 1) for x in s["step_ms_each"]], card),
                  flush=True)
        loader = get_bert_pretrain_data_loader(
            bal, vocab_file=vocab, batch_size=16, base_seed=12345,
            fixed_seq_lengths=[int(x) for x in cs.HARNESS_BINS])
        batches = list(prefetch_to_device(loader))
        torch.cuda.synchronize()
        for impl in ("flash", "auto"):
            torch.manual_seed(0)
            with torch.device("cuda"):
                model = BertForPreTraining(
                    BertConfig.bert_base(attention_impl=impl))
            step = make_train_step(model, make_optimizer(model.parameters()))
            lens, ms = [], []
            for b in batches:
                t0 = time.perf_counter()
                float(step(b, seed=12345)["loss"])
                ms.append(1e3 * (time.perf_counter() - t0))
                lens.append(b["input_ids"].shape[1])
            print("ab bare {}: {:.2f} ms avg, median by L {}, every step "
                  "{} ({})".format(
                      impl, sum(ms[2:]) / len(ms[2:]),
                      cs.median_by_len(lens, ms),
                      [round(x, 1) for x in ms], card), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
