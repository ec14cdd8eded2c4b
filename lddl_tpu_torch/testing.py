"""Synthetic data for tests and the chip smoke run.

- ``fake_pretrain_batch``, ``fake_bart_batch``: numpy batches in the BERT
  and BART loaders' contracts (counterparts of
  ``lddl_tpu/models/testing.py``).
- ``write_vocab``: a ``vocab.txt`` made from a seed, the five special
  tokens first.
- ``write_balanced_shards``: balanced, length-binned schema-v2 BERT shards
  (``shard-<i>.parquet_<bin>`` plus ``.num_samples.json``) in the columns
  of the README's "Data format" table, made from a seed. A data maker,
  not a preprocessor: its samples are random ids, not text.
- ``write_unbinned_shards``: the same samples unbinned
  (``shard-<i>.parquet``), the input of load-time packing.
- ``write_packed_shards``: offline-packed balanced shards, the samples
  packed into rows by the port's ``preprocess.packing.pack_columns``.
- ``write_bart_shards``: balanced schema-v2 BART shards
  (``shard-<i>.parquet`` plus ``.num_samples.json``) in the columns the
  BART preprocess writes with a tokenizer, made from a seed.
"""

import json
import os

import numpy as np

from .preprocess.arrowcols import int32_list_array

SPECIAL_TOKENS = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]")


def fake_pretrain_batch(vocab_size, batch, seq_len, seed=0,
                        segment_split=False):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, vocab_size, (batch, seq_len)).astype(np.int32)
    segment = np.zeros((batch, seq_len), np.int32)
    if segment_split:
        segment[:, seq_len // 2:] = 1
    return {
        "input_ids": ids,
        "token_type_ids": segment,
        "attention_mask": np.ones((batch, seq_len), np.int32),
        "labels": np.where(rng.random((batch, seq_len)) < 0.15, ids,
                           -1).astype(np.int32),
        "next_sentence_labels": rng.integers(0, 2, (batch,)).astype(np.int32),
    }


def fake_bart_batch(vocab_size, batch, seq_len, seed=0):
    """A numpy batch in the BART loader's contract: input_ids,
    attention_mask, decoder_input_ids, labels."""
    rng = np.random.default_rng(seed)
    dec = rng.integers(5, vocab_size, (batch, seq_len)).astype(np.int32)
    labels = np.roll(dec, -1, axis=1).astype(np.int32)
    labels[:, -1] = -1
    return {
        "input_ids": rng.integers(5, vocab_size,
                                  (batch, seq_len)).astype(np.int32),
        "attention_mask": np.ones((batch, seq_len), np.int32),
        "decoder_input_ids": dec,
        "labels": labels,
    }


def write_vocab(path, vocab_size=30522, seed=0):
    """Write ``vocab_size`` unique tokens, one per line, specials first;
    returns the token list (token id = line index)."""
    rng = np.random.default_rng(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    tokens = list(SPECIAL_TOKENS)
    seen = set(tokens)
    while len(tokens) < vocab_size:
        word = "".join(rng.choice(letters, int(rng.integers(2, 9))))
        if rng.random() < 0.3:
            word = "##" + word
        if word not in seen:
            seen.add(word)
            tokens.append(word)
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(tokens) + "\n")
    return tokens


def _samples_of_bin(rng, n, lo, hi, vocab_size, masking, mlm_prob=0.15):
    """``n`` samples of lo..hi tokens (specials included) as flat id
    arrays + lengths, statically masked when ``masking``."""
    totals = rng.integers(lo, hi + 1, n)
    a_lens = np.array([int(rng.integers(1, t - 3)) for t in totals])
    b_lens = totals - 3 - a_lens
    a_ids = [rng.integers(5, vocab_size, a).astype(np.int32) for a in a_lens]
    b_ids = [rng.integers(5, vocab_size, b).astype(np.int32) for b in b_lens]
    positions, labels = [], []
    if masking:
        mask_id = SPECIAL_TOKENS.index("[MASK]")
        for a, b in zip(a_ids, b_ids):
            # Candidate columns of [CLS] A [SEP] B [SEP]: A then B.
            cand = np.concatenate([1 + np.arange(len(a)),
                                   len(a) + 2 + np.arange(len(b))])
            k = max(1, int(round(mlm_prob * len(cand))))
            pos = np.sort(rng.choice(cand, k, replace=False))
            seq = np.concatenate([[0], a, [0], b, [0]]).astype(np.int32)
            labels.append(seq[pos].copy())
            r = rng.random(k)
            seq[pos[r < 0.8]] = mask_id
            rand = (r >= 0.8) & (r < 0.9)
            seq[pos[rand]] = rng.integers(5, vocab_size, int(rand.sum()))
            a[:] = seq[1:1 + len(a)]
            b[:] = seq[len(a) + 2:len(a) + 2 + len(b)]
            positions.append(pos.astype(np.int32))
    nsp = rng.random(n) < 0.5
    return a_ids, b_ids, nsp, totals, positions, labels


def _int32_lists(arrays):
    return int32_list_array(
        np.concatenate(arrays) if arrays else np.zeros(0, np.int32),
        [len(a) for a in arrays])


def _bert_columns(rng, n, lo, hi, tokens, masking):
    """Schema-v2 columns of ``n`` samples of lo..hi tokens: the text
    columns and the token-id columns, statically masked when
    ``masking``."""
    import pyarrow as pa
    vocab = np.asarray(tokens, dtype=object)
    a_ids, b_ids, nsp, totals, pos, labels = _samples_of_bin(
        rng, n, lo, hi, len(tokens), masking)
    cols = {
        "A": pa.array([" ".join(vocab[a]) for a in a_ids]),
        "B": pa.array([" ".join(vocab[b]) for b in b_ids]),
        "is_random_next": pa.array(nsp),
        "num_tokens": pa.array(totals.astype(np.uint16)),
    }
    if masking:
        cols["masked_lm_positions"] = pa.array(
            [b"R<u2" + p.astype("<u2").tobytes() for p in pos], pa.binary())
        cols["masked_lm_labels"] = pa.array(
            [" ".join(vocab[lab]) for lab in labels])
    cols["A_ids"] = _int32_lists(a_ids)
    cols["B_ids"] = _int32_lists(b_ids)
    if masking:
        cols["masked_lm_positions_ids"] = _int32_lists(pos)
        cols["masked_lm_label_ids"] = _int32_lists(labels)
    return cols


def _write_num_samples(out_dir, counts):
    tmp = os.path.join(out_dir, ".num_samples.json.tmp")
    with open(tmp, "w") as f:
        json.dump(counts, f, sort_keys=True)
    os.replace(tmp, os.path.join(out_dir, ".num_samples.json"))


def write_balanced_shards(out_dir, tokens, num_bins=4, bin_size=128,
                          shards_per_bin=2, samples_per_shard=64,
                          masking=True, seed=0):
    """Write ``num_bins`` x ``shards_per_bin`` balanced schema-v2 shards
    (bin k holds samples of k*bin_size+1 .. (k+1)*bin_size tokens) and the
    ``.num_samples.json`` cache; returns {basename: count}."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    counts = {}
    for k in range(num_bins):
        lo = max(k * bin_size + 1, 8)
        hi = (k + 1) * bin_size
        for i in range(shards_per_bin):
            n = samples_per_shard
            cols = _bert_columns(rng, n, lo, hi, tokens, masking)
            cols["bin_id"] = pa.array(np.full(n, k, dtype=np.int64))
            name = "shard-{}.parquet_{}".format(i, k)
            pq.write_table(pa.table(cols), os.path.join(out_dir, name),
                           compression="lz4")
            counts[name] = n
    _write_num_samples(out_dir, counts)
    return counts


def write_unbinned_shards(out_dir, tokens, num_shards=2,
                          samples_per_shard=64, min_tokens=8,
                          max_tokens=512, masking=True, seed=0):
    """Write ``num_shards`` balanced unbinned schema-v2 shards
    (``shard-<i>.parquet``) of samples of ``min_tokens`` ..
    ``max_tokens`` tokens (specials included) and the
    ``.num_samples.json`` cache; returns {basename: count}."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    counts = {}
    for i in range(num_shards):
        cols = _bert_columns(rng, samples_per_shard, min_tokens, max_tokens,
                             tokens, masking)
        name = "shard-{}.parquet".format(i)
        pq.write_table(pa.table(cols), os.path.join(out_dir, name),
                       compression="lz4")
        counts[name] = samples_per_shard
    _write_num_samples(out_dir, counts)
    return counts


def write_packed_shards(out_dir, tokens, num_samples=1024, num_shards=2,
                        pack_seq_length=512, pack_max_per_row=8,
                        min_tokens=8, max_tokens=512, masking=True, seed=0):
    """Write offline-packed balanced shards: ``num_samples`` samples of
    ``min_tokens`` .. ``max_tokens`` tokens packed first-fit-decreasing
    into rows of ``pack_seq_length`` by the port's ``pack_columns``, the
    rows dealt round-robin over ``num_shards`` ``shard-<i>.parquet``
    files (row counts equal or one apart) with the row shape stamped into
    each footer, and the ``.num_samples.json`` cache of row counts.
    Returns (counts {basename: rows}, stats of ``pack_columns``)."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    from .preprocess.packing import pack_columns, packed_schema
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    a_ids, b_ids, nsp, totals, pos, labels = _samples_of_bin(
        rng, num_samples, min_tokens, max_tokens, len(tokens), masking)
    cols = {"A_ids": _int32_lists(a_ids), "B_ids": _int32_lists(b_ids),
            "is_random_next": nsp, "num_tokens": totals}
    if masking:
        cols["masked_lm_positions_ids"] = _int32_lists(pos)
        cols["masked_lm_label_ids"] = _int32_lists(labels)
    packed, n_rows, stats = pack_columns(
        cols, num_samples, pack_seq_length, pack_max_per_row,
        cls_id=SPECIAL_TOKENS.index("[CLS]"),
        sep_id=SPECIAL_TOKENS.index("[SEP]"), masking=masking)
    schema = packed_schema(masking, pack_seq_length, pack_max_per_row)
    table = pa.table({name: packed[name] for name in schema.names},
                     schema=schema)
    counts = {}
    for i in range(num_shards):
        name = "shard-{}.parquet".format(i)
        rows = table.take(np.arange(i, n_rows, num_shards))
        pq.write_table(rows, os.path.join(out_dir, name),
                       compression="lz4")
        counts[name] = rows.num_rows
    _write_num_samples(out_dir, counts)
    return counts, stats


def write_bart_shards(out_dir, vocab_size, num_shards=2,
                      samples_per_shard=64, seed=0, min_tokens=1100):
    """Write ``num_shards`` balanced schema-v2 BART shards of
    ``samples_per_shard`` chunks each, laid out as the BART preprocess
    writes them with a tokenizer: ``sentences`` (the chunk's text),
    ``sentence_ids`` (its token ids, sentence after sentence) and
    ``sentence_lens`` (tokens per sentence); then the
    ``.num_samples.json`` cache. Every chunk holds at least
    ``min_tokens`` ids (5 .. vocab_size - 1), so with the default a
    loader window of up to 1022 clean tokens is always full. Returns
    {basename: count}."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    counts = {}
    for i in range(num_shards):
        texts, ids, lens = [], [], []
        for _ in range(samples_per_shard):
            sent_lens = []
            while sum(sent_lens) < min_tokens:
                sent_lens.append(int(rng.integers(8, 120)))
            chunk = rng.integers(5, vocab_size,
                                 sum(sent_lens)).astype(np.int32)
            ends = np.cumsum(sent_lens)
            texts.append(" ".join(
                " ".join("w{}".format(t) for t in chunk[e - n:e]) + "."
                for n, e in zip(sent_lens, ends)))
            ids.append(chunk)
            lens.append(np.asarray(sent_lens, dtype=np.int32))
        table = pa.table({"sentences": pa.array(texts),
                          "sentence_ids": _int32_lists(ids),
                          "sentence_lens": _int32_lists(lens)})
        name = "shard-{}.parquet".format(i)
        pq.write_table(table, os.path.join(out_dir, name),
                       compression="lz4")
        counts[name] = samples_per_shard
    _write_num_samples(out_dir, counts)
    return counts
