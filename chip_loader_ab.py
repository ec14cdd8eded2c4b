#!/usr/bin/env python3
"""Time the port's BERT loader alone at two checkouts, in turns.

``python3 chip_loader_ab.py PARENT_ROOT CHANGE_ROOT`` writes synthetic
balanced binned shards once (``lddl_tpu_torch.testing``: 8 bins of 64
tokens, 16 shards a bin of 1024 samples, bert_large's 30522-token vocab),
then iterates ``get_bert_pretrain_data_loader`` (batch 16, one thread
worker a bin, the bins' lengths fixed, as ``chip_smoke.py`` phase 8 does)
from each checkout in a process of its own, in the order parent, change,
change, parent: the first batch, then 400 batches timed on the host
clock. Prints one line a run and the card line (the loader runs on the
host; the card only names the machine).
"""

import os
import subprocess
import sys
import tempfile

RUN = """
import sys, time
import numpy as np
from lddl_tpu_torch.loader import get_bert_pretrain_data_loader
bal, vocab = sys.argv[1], sys.argv[2]
it = iter(get_bert_pretrain_data_loader(
    bal, vocab_file=vocab, batch_size=16, base_seed=12345,
    fixed_seq_lengths=[64 * (i + 1) for i in range(8)]))
next(it)
padded = 0
t0 = time.perf_counter()
for _ in range(400):
    padded += int(np.prod(next(it)["input_ids"].shape))
secs = time.perf_counter() - t0
it.close()   # join the worker threads before the interpreter exits
print("{:.1f} batches/s, {:.0f} padded tokens/s".format(400 / secs,
                                                        padded / secs))
"""


def main():
    if len(sys.argv) != 3:
        print("usage: chip_loader_ab.py PARENT_ROOT CHANGE_ROOT",
              file=sys.stderr)
        return 2
    roots = {"parent": os.path.abspath(sys.argv[1]),
             "change": os.path.abspath(sys.argv[2])}
    sys.path.insert(0, roots["change"])
    from lddl_tpu_torch.testing import write_balanced_shards, write_vocab
    tmp = tempfile.mkdtemp(prefix="loader_ab_")
    vocab = os.path.join(tmp, "vocab.txt")
    tokens = write_vocab(vocab, 30522, seed=0)
    bal = os.path.join(tmp, "bal")
    write_balanced_shards(bal, tokens, num_bins=8, bin_size=64,
                          shards_per_bin=16, samples_per_shard=1024, seed=0)
    for name in ("parent", "change", "change", "parent"):
        env = dict(os.environ, PYTHONPATH=roots[name])
        out = subprocess.run([sys.executable, "-c", RUN, bal, vocab],
                             env=env, capture_output=True, text=True,
                             check=True, timeout=600, cwd=roots[name])
        print("loader alone, {}: {}".format(name, out.stdout.strip()),
              flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True)
    print(card.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
