"""Lengths of BERT pretraining samples as google-research/bert's
``create_pretraining_data.py`` cuts them from documents
(``create_instances_from_document``), for a corpus whose documents and
sentences have the lengths a traffic file's ``lengths`` rule states.

The rule, per document: the target is ``max_seq_length - 3`` tokens, or,
with probability ``short_seq_prob`` (drawn once a document), a length
uniform in 2 .. ``max_seq_length - 3``. Sentences accumulate into a chunk
until it reaches the target or the document ends; A is the chunk's first
1 .. m-1 sentences; with probability ``random_next_prob`` (always for a
one-sentence chunk) B is taken from a random point of another document
until it reaches the target less A, and the chunk's unused sentences are
put back; otherwise B is the rest of the chunk. The pair is truncated to
``max_seq_length - 3`` tokens and ``[CLS] A [SEP] B [SEP]`` adds three.

A document holds ``document_sentences`` sentences whose word counts are
lognormal with the stated median and mean (one token a word). Each
target of the rule is run over one such document and its samples are
weighted by that target's probability, so the shares are those of a
corpus of many documents.

    python3 -m portbench.lengths portbench/traffic/<name>.json

prints the shares derived from the file's rule beside those it holds.
"""

import bisect
import json
import math
import sys

import numpy as np


def _words(rng, n, rule):
    median, mean = rule["sentence_words_median"], rule["sentence_words_mean"]
    sigma = math.sqrt(2.0 * math.log(mean / median))
    w = np.rint(rng.lognormal(math.log(median), sigma, n))
    return np.maximum(w, 1).astype(np.int64)


def _cumsum(w):
    return [0] + np.cumsum(w).tolist()


def document_lengths(rng, target, rule):
    """Sample lengths (with the three special tokens) the rule cuts from one
    document at ``target``."""
    n = rule["document_sentences"]
    max_num = rule["max_seq_length"] - 3
    cs = _cumsum(_words(rng, n, rule))
    # Other documents' sentences, B's source after a random start.
    other = _cumsum(_words(rng, 4 * n, rule))
    u = rng.random((2 * n + 2, 3)).tolist()
    out, i, k = [], 0, 0
    while i < n:
        j = min(bisect.bisect_left(cs, cs[i] + target), n) - 1
        m = j - i + 1
        draw_a, draw_next, draw_start = u[k]
        k += 1
        a_end = 1 if m < 2 else 1 + int(draw_a * (m - 1))
        la = cs[i + a_end] - cs[i]
        if m == 1 or draw_next < rule["random_next_prob"]:
            s = int(draw_start * 3 * n)
            stop = bisect.bisect_left(other, other[s] + max(target - la, 1))
            lb = other[stop] - other[s]
            i += a_end
        else:
            lb = cs[j + 1] - cs[i + a_end]
            i = j + 1
        out.append(min(la + lb, max_num) + 3)
    return out


def derive(rule):
    """Shares of the sample lengths 1 .. ``max_seq_length`` (index 0 is
    length 1) under ``rule``, rounded to 9 decimals."""
    rng = np.random.default_rng(rule["seed"])
    top = rule["max_seq_length"]
    max_num = top - 3
    hist = np.zeros(top + 1)
    short = rule["short_seq_prob"]
    weights = {max_num: 1.0 - short}
    for t in range(2, max_num + 1):
        weights[t] = weights.get(t, 0.0) + short / (max_num - 1)
    for t in sorted(weights):
        np.add.at(hist, document_lengths(rng, t, rule), weights[t])
    shares = hist[1:] / hist.sum()
    return [round(float(x), 9) for x in shares]


def bin_shares(shares, bin_size):
    """Each bin's share of the samples (bin k holds lengths
    k*bin_size+1 .. (k+1)*bin_size)."""
    s = np.asarray(shares)
    return [float(s[k:k + bin_size].sum()) for k in range(0, len(s),
                                                           bin_size)]


def main(argv=None):
    path = (argv or sys.argv[1:])[0]
    with open(path) as f:
        traffic = json.load(f)
    got = derive(traffic["lengths"])
    held = traffic["length_shares"]
    print(json.dumps({
        "max_abs_difference": max(abs(a - b) for a, b in zip(got, held)),
        "bins_derived": bin_shares(got, traffic["bin_size"]),
        "bins_held": bin_shares(held, traffic["bin_size"]),
        "mean_length": float(np.dot(np.arange(1, len(got) + 1), got))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
