"""Input data of a cell, made from the run's seed: a vocabulary file and
balanced parquet shards in the layout the preprocess and balancer write.

Frozen copies of the port's test generators (``write_vocab``,
``_bert_columns``, ``write_balanced_shards``, ``write_bart_shards``),
vectorised, and driven by a traffic file's parameters: the share of
each sample length for BERT, chunk and sentence lengths for BART.
Nothing here imports the program; the shards' columns are its file
format.

Both makers also return the index the output check reads: every sample as
it was written, keyed so that a loader row can be found again.
"""

import json
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq

SPECIAL_TOKENS = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]")
PAD, UNK, CLS, SEP, MASK = range(5)
FIRST_ID = len(SPECIAL_TOKENS)


def write_vocab(path, vocab_size, seed):
    """``vocab_size`` unique lower-case WordPiece tokens, specials first, one
    per line (token id = line index). Returns the token list."""
    rng = np.random.default_rng([seed, 0x70CAB])
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    tokens = list(SPECIAL_TOKENS)
    seen = set(tokens)
    while len(tokens) < vocab_size:
        n = 2 * (vocab_size - len(tokens))
        lens = rng.integers(2, 9, n)
        chars = letters[rng.integers(0, 26, int(lens.sum()))]
        ends = np.cumsum(lens)
        cont = rng.random(n) < 0.3
        for i in range(n):
            word = "".join(chars[ends[i] - lens[i]:ends[i]])
            if cont[i]:
                word = "##" + word
            if word not in seen:
                seen.add(word)
                tokens.append(word)
                if len(tokens) == vocab_size:
                    break
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(tokens) + "\n")
    return tokens


def _int32_lists(flat, lens):
    offsets = np.zeros(len(lens) + 1, dtype=np.int32)
    np.cumsum(lens, out=offsets[1:])
    return pa.ListArray.from_arrays(pa.array(offsets),
                                    pa.array(flat.astype(np.int32)))


def _segment_starts(lens):
    return np.cumsum(lens) - lens


def _joined(vocab, widths, flat, lens):
    """Each segment's tokens joined by spaces: one join of all the words,
    cut at the segments' character offsets (``widths``: each token's
    length)."""
    words = vocab[flat]
    full = " ".join(words)
    ends = np.cumsum(widths[flat] + 1)            # past each word's space
    stop = ends[np.cumsum(lens) - 1] - 1 if len(words) else ends
    start = np.concatenate([[0], stop[:-1] + 1])
    return pa.array([full[a:b] for a, b in zip(start.tolist(),
                                               stop.tolist())])


def _write(table, path):
    tmp = path + ".tmp"
    pq.write_table(table, tmp, compression="lz4")
    os.replace(tmp, path)


def _bert_bin(rng, totals, vocab_size, mlm_prob, max_pred):
    """Samples of ``totals`` tokens each ([CLS] A [SEP] B [SEP]), statically
    masked as the preprocess's ``--masking`` stores them: ~``mlm_prob`` of
    the A and B tokens chosen (at least one, at most ``max_pred``), of
    those 80% replaced by [MASK], 10% by a random token, 10% kept; the
    positions are columns of the assembled sample, the labels the
    original ids. Returns a dict of flat arrays and per-sample lengths."""
    n = len(totals)
    a_lens = rng.integers(1, totals - 3)
    b_lens = totals - 3 - a_lens
    body = a_lens + b_lens
    flat = rng.integers(FIRST_ID, vocab_size, int(body.sum())).astype(np.int32)
    k = np.clip(np.rint(mlm_prob * body).astype(np.int64), 1, max_pred)
    # k distinct candidates a sample: the k smallest of one uniform key per
    # candidate, sorted within each sample's segment.
    seg = np.repeat(np.arange(n), body)
    order = np.argsort(seg + rng.random(len(flat)))
    rank = np.arange(len(flat)) - np.repeat(_segment_starts(body), body)
    chosen = np.sort(order[rank < np.repeat(k, body)])    # ascending a sample
    cand = chosen - np.repeat(_segment_starts(body), k)   # index in A+B
    a_of = np.repeat(a_lens, k)
    positions = np.where(cand < a_of, 1 + cand, cand + 2).astype(np.int32)
    labels = flat[chosen].copy()
    r = rng.random(len(chosen))
    masked = flat.copy()
    masked[chosen[r < 0.8]] = MASK
    rand = (r >= 0.8) & (r < 0.9)
    masked[chosen[rand]] = rng.integers(FIRST_ID, vocab_size, int(rand.sum()))
    starts = _segment_starts(body)
    a_idx = np.repeat(starts, a_lens) + _aranges(a_lens)
    b_idx = np.repeat(starts + a_lens, b_lens) + _aranges(b_lens)
    a_parts, b_parts = masked[a_idx], masked[b_idx]
    return {"a": a_parts, "a_lens": a_lens, "b": b_parts, "b_lens": b_lens,
            "positions": positions, "labels": labels, "k": k,
            "is_random_next": rng.random(n) < 0.5, "num_tokens": totals}


def _aranges(lens):
    total = int(lens.sum())
    return np.arange(total) - np.repeat(_segment_starts(lens), lens)


def _slice(s, i, j):
    """Samples i..j-1 of a ``_bert_bin`` dict."""
    out = {}
    for key, lens in (("a", "a_lens"), ("b", "b_lens"),
                      ("positions", "k"), ("labels", "k")):
        starts = np.concatenate([[0], np.cumsum(s[lens])])
        out[key] = s[key][starts[i]:starts[j]]
    for key in ("a_lens", "b_lens", "k", "is_random_next", "num_tokens"):
        out[key] = s[key][i:j]
    return out


def _bert_table(s, vocab, widths, bin_id):
    """Schema-v2 columns of the preprocess's masked output."""
    pos_starts = _segment_starts(s["k"])
    return pa.table({
        "A": _joined(vocab, widths, s["a"], s["a_lens"]),
        "B": _joined(vocab, widths, s["b"], s["b_lens"]),
        "is_random_next": pa.array(s["is_random_next"]),
        "num_tokens": pa.array(s["num_tokens"].astype(np.uint16)),
        "masked_lm_positions": pa.array(
            [b"R<u2" + s["positions"][p:p + n].astype("<u2").tobytes()
             for p, n in zip(pos_starts, s["k"])], pa.binary()),
        "masked_lm_labels": _joined(vocab, widths, s["labels"], s["k"]),
        "A_ids": _int32_lists(s["a"], s["a_lens"]),
        "B_ids": _int32_lists(s["b"], s["b_lens"]),
        "masked_lm_positions_ids": _int32_lists(s["positions"], s["k"]),
        "masked_lm_label_ids": _int32_lists(s["labels"], s["k"]),
        "bin_id": pa.array(np.full(len(s["k"]), bin_id, dtype=np.int64)),
    })


def bert_lengths(traffic):
    """The sample lengths of ``traffic`` (a ``bert_binned`` mix), the same
    for every seed: ``round(share * samples)`` samples of each length of
    ``length_shares`` (lengths 1 ..), each bin cut to a multiple of
    ``shards_per_bin`` by dropping its longest. Returns one sorted array
    a bin."""
    shares = np.asarray(traffic["length_shares"])
    counts = np.rint(shares * traffic["samples"]).astype(np.int64)
    lens = np.repeat(np.arange(1, len(shares) + 1), counts)
    size, per_bin = traffic["bin_size"], traffic["shards_per_bin"]
    out = []
    for k in range(-(-len(shares) // size)):
        b = lens[(lens > k * size) & (lens <= (k + 1) * size)]
        out.append(b[:len(b) - len(b) % per_bin])
    return out


def bert_binned(out_dir, traffic, vocab_size, seed):
    """Balanced, length-binned BERT shards for ``traffic`` (a
    ``bert_binned`` mix): ``shard-<i>.parquet_<bin>`` and the
    ``.num_samples.json`` cache, bin k holding the samples of lengths
    k*bin_size+1 .. (k+1)*bin_size that ``bert_lengths`` gives, in an order
    drawn from the seed. Returns (shards dir, vocab path, index): the index
    maps a sample's stored A and B ids to (bin, A, B, is_random_next,
    masked positions, labels)."""
    os.makedirs(out_dir, exist_ok=True)
    vocab_path = os.path.join(out_dir, "vocab.txt")
    vocab = np.asarray(write_vocab(vocab_path, vocab_size, seed),
                       dtype=object)
    widths = np.array([len(w) for w in vocab])
    shards_dir = os.path.join(out_dir, "shards")
    os.makedirs(shards_dir, exist_ok=True)
    rng = np.random.default_rng([seed, 0xB127])
    per_bin = traffic["shards_per_bin"]
    counts, index = {}, {}
    for k, totals in enumerate(bert_lengths(traffic)):
        if not len(totals):
            continue
        s = _bert_bin(rng, rng.permutation(totals), vocab_size,
                      traffic["mlm_prob"], traffic["max_predictions_per_seq"])
        _index_bert(index, s, k)
        step = len(totals) // per_bin
        for i in range(per_bin):
            name = "shard-{}.parquet_{}".format(i, k)
            _write(_bert_table(_slice(s, i * step, (i + 1) * step), vocab,
                               widths, k),
                   os.path.join(shards_dir, name))
            counts[name] = step
    with open(os.path.join(shards_dir, ".num_samples.json"), "w") as f:
        json.dump(counts, f, sort_keys=True)
    return shards_dir, vocab_path, index


def _index_bert(index, s, bin_id):
    a_st = np.concatenate([[0], np.cumsum(s["a_lens"])])
    b_st = np.concatenate([[0], np.cumsum(s["b_lens"])])
    k_st = np.concatenate([[0], np.cumsum(s["k"])])
    for i in range(len(s["k"])):
        a = s["a"][a_st[i]:a_st[i + 1]]
        b = s["b"][b_st[i]:b_st[i + 1]]
        index[a.tobytes() + b"|" + b.tobytes()] = (
            bin_id, a, b, bool(s["is_random_next"][i]),
            s["positions"][k_st[i]:k_st[i + 1]],
            s["labels"][k_st[i]:k_st[i + 1]])


def bart_chunks(out_dir, traffic, vocab_size, seed):
    """Balanced schema-v2 BART shards for ``traffic`` (a ``bart_chunks``
    mix): ``chunks`` chunks over ``shards`` files, each chunk sentences of
    ``sentence_tokens`` (inclusive range) ids until at least
    ``min_chunk_tokens``, stored as the BART preprocess stores them
    (``sentences`` text, ``sentence_ids``, ``sentence_lens``). Returns
    (shards dir, vocab path, index): the index maps a chunk's first 16 ids
    to its ids."""
    os.makedirs(out_dir, exist_ok=True)
    vocab_path = os.path.join(out_dir, "vocab.txt")
    write_vocab(vocab_path, vocab_size, seed)
    shards_dir = os.path.join(out_dir, "shards")
    os.makedirs(shards_dir, exist_ok=True)
    rng = np.random.default_rng([seed, 0xBA27])
    words = np.array(["w{}".format(i) for i in range(vocab_size)],
                     dtype=object)
    lo, hi = traffic["sentence_tokens"]
    n_chunks, n_shards = traffic["chunks"], traffic["shards"]
    per_shard = n_chunks // n_shards
    min_tokens = traffic["min_chunk_tokens"]
    # Enough sentences that every chunk reaches min_tokens: draw them in
    # bulk, then cut the stream into chunks.
    counts, index = {}, {}
    for i in range(n_shards):
        sent_lens = rng.integers(lo, hi + 1, per_shard * (min_tokens // lo
                                                          + 2))
        ends = np.cumsum(sent_lens)
        texts, ids, lens = [], [], []
        first = 0
        for _ in range(per_shard):
            start = 0 if first == 0 else ends[first - 1]
            last = int(np.searchsorted(ends, start + min_tokens))
            sl = sent_lens[first:last + 1]
            first = last + 1
            chunk = rng.integers(FIRST_ID, vocab_size,
                                 int(sl.sum())).astype(np.int32)
            strs = words[chunk]
            stops = np.cumsum(sl) - 1
            strs[stops] = [w + "." for w in strs[stops]]
            texts.append(" ".join(strs))
            ids.append(chunk)
            lens.append(sl.astype(np.int32))
            index[chunk[:16].tobytes()] = chunk
        id_lens = np.array([len(c) for c in ids])
        table = pa.table({
            "sentences": pa.array(texts),
            "sentence_ids": _int32_lists(np.concatenate(ids), id_lens),
            "sentence_lens": _int32_lists(np.concatenate(lens),
                                          np.array([len(x) for x in lens]))})
        name = "shard-{}.parquet".format(i)
        _write(table, os.path.join(shards_dir, name))
        counts[name] = per_shard
    with open(os.path.join(shards_dir, ".num_samples.json"), "w") as f:
        json.dump(counts, f, sort_keys=True)
    return shards_dir, vocab_path, index
