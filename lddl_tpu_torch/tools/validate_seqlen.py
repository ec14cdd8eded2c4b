"""Offline validation of sequence binning from ``mock_train`` dumps.

Counterpart of ``benchmarks/validate_seqlen.py``: from the
``lens_<dp_rank>.npz`` files that ``lddl_tpu_torch.tools.mock_train
--seq-len-dir`` writes, checks that (1) each iteration's min/max sequence
lengths stay within one bin width, (2) every dp group chose the SAME bin
each iteration (the loaders' zero-communication sync), and (3) bounds
the padding waste. Prints a text verdict, ``PASS`` or ``FAIL: <n>
violations`` last, and exits 1 on a violation::

    python -m lddl_tpu_torch.tools.validate_seqlen --seq-len-dir <dir> \\
        --bin-size 32 [--plots-dir <dir>]

``--plots-dir`` writes three .png plots with matplotlib, which is
imported only then and is not a dependency of the port.
"""

import argparse
import glob
import os
import sys

import numpy as np


def attach_args():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--seq-len-dir", required=True,
                   help="directory of lens_<dp_rank>.npz dumps")
    p.add_argument("--bin-size", type=int, required=True)
    p.add_argument("--plots-dir", default=None,
                   help="write .png plots here (optional; needs "
                        "matplotlib)")
    return p


def _plot(plots_dir, ranks, sync_diff, bin_size):
    try:
        import matplotlib
    except ImportError:
        raise SystemExit("--plots-dir needs matplotlib, which is not "
                         "installed; the verdict above stands without "
                         "the plots")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    os.makedirs(plots_dir, exist_ok=True)
    fig, ax = plt.subplots()
    for rank, d in sorted(ranks.items()):
        ax.plot(d["max_lens"] - d["min_lens"], label="rank {}".format(rank))
    ax.axhline(bin_size, color="red", linestyle="--", label="bin size")
    ax.set_xlabel("iteration")
    ax.set_ylabel("in-batch seq-len spread")
    ax.legend()
    fig.savefig(os.path.join(plots_dir, "rank_diff.png"))
    fig, ax = plt.subplots()
    ax.plot(sync_diff)
    ax.set_xlabel("iteration")
    ax.set_ylabel("max cross-rank padded-len diff (0 = in sync)")
    fig.savefig(os.path.join(plots_dir, "global_diff.png"))
    fig, ax = plt.subplots()
    lens = np.concatenate([d["max_lens"] for _, d in sorted(ranks.items())])
    ax.hist(lens, bins=32)
    ax.set_xlabel("max seq len per iteration")
    fig.savefig(os.path.join(plots_dir, "seqlen_hist.png"))
    print("plots -> {}".format(plots_dir))


def main(argv=None):
    args = attach_args().parse_args(argv)
    paths = sorted(glob.glob(os.path.join(args.seq_len_dir, "lens_*.npz")))
    if not paths:
        raise SystemExit("no lens_*.npz under {}".format(args.seq_len_dir))
    ranks = {}
    for p in paths:
        rank = int(os.path.basename(p)[len("lens_"):-len(".npz")])
        ranks[rank] = np.load(p)
    print("loaded {} rank dumps".format(len(ranks)))

    failures = 0

    # (1) per-iteration spread within one bin width, per rank.
    for rank, d in sorted(ranks.items()):
        spread = d["max_lens"] - d["min_lens"]
        # Samples inside one (lo, lo+bin_size] bin differ by at most
        # bin_size - 1 tokens, so spread >= bin_size proves a bin mix.
        bad = int((spread >= args.bin_size).sum())
        print("rank {}: max in-batch seq-len spread = {} "
              "(bin size {}) -> {}".format(
                  rank, int(spread.max()), args.bin_size,
                  "OK" if bad == 0 else "{} violations".format(bad)))
        failures += bad

    # (2) all ranks chose the same bin (batch padded len) every iteration.
    lens_matrix = np.stack([d["batch_lens"] for _, d in sorted(ranks.items())])
    sync_diff = lens_matrix.max(axis=0) - lens_matrix.min(axis=0)
    bad_sync = int((sync_diff != 0).sum())
    print("bin sync across ranks: {}".format(
        "OK (identical every iteration)" if bad_sync == 0 else
        "{} iterations diverged".format(bad_sync)))
    failures += bad_sync

    # (3) padding waste.
    total_pad = 0
    total_slots = 0
    for _, d in sorted(ranks.items()):
        # Approximation from min/max: exact per-token stats live in
        # mock_train's printed pad ratio; here we bound it.
        total_pad += int((d["batch_lens"] - d["min_lens"]).sum())
        total_slots += int(d["batch_lens"].sum())
    print("padding upper-bound ratio: {:.4f}".format(
        total_pad / max(total_slots, 1)))

    if args.plots_dir:
        _plot(args.plots_dir, ranks, sync_diff, args.bin_size)

    if failures:
        print("FAIL: {} violations".format(failures))
        sys.exit(1)
    print("PASS")


if __name__ == "__main__":
    main()
