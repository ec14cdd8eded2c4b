"""Synthetic data for tests and the chip smoke run.

- ``fake_pretrain_batch``, ``fake_packed_pretrain_batch``,
  ``fake_bart_batch``: numpy batches in the BERT, packed BERT and BART
  loaders' contracts (counterparts of ``lddl_tpu/models/testing.py``);
  ``fake_hidden_states``: a random encoder input.
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
- ``write_text_corpus``: a raw text corpus in the downloaders' contract
  (``source/<i>.txt``, one ``<doc-id> <text>`` document per line) made
  from a seed over a vocab's words: the input of the preprocess.
- ``make_corpus`` (with ``make_lexicon``): the same contract over a
  procedural Zipf lexicon with accents, digits and CJK, the corpus of
  the CI smokes (``tools/*_smoke.py``); a seed gives the bytes the
  repository's root ``bench.py`` writes for it.
"""

import json
import os

import numpy as np

from .preprocess.arrowcols import int32_list_array
from .resilience.io import atomic_write, write_table_atomic

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


def fake_packed_pretrain_batch(vocab_size, rows, seq_len, max_per_row,
                               seed=0):
    """A numpy batch in the packed loader's contract
    (``loader.bert.BertPackedCollate`` / ``BertPrepackedCollate``): two
    samples a row (one when ``max_per_row`` is 1), block-diagonal
    segments, per-slot NSP labels padded with -1; the input keys of
    ``BertForPreTrainingPacked``."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, vocab_size, (rows, seq_len)).astype(np.int32)
    n_samples = min(2, max_per_row)
    half = seq_len // 2 if n_samples == 2 else seq_len
    segments = np.ones((rows, seq_len), np.int32)
    segments[:, half:] = n_samples
    position_ids = np.concatenate(
        [np.arange(half), np.arange(seq_len - half)]).astype(np.int32)
    position_ids = np.broadcast_to(position_ids, (rows, seq_len)).copy()
    cls_positions = np.zeros((rows, max_per_row), np.int32)
    if n_samples == 2:
        cls_positions[:, 1] = half
    nsp = np.full((rows, max_per_row), -1, np.int32)
    nsp[:, :n_samples] = rng.integers(0, 2,
                                      (rows, n_samples)).astype(np.int32)
    return {
        "input_ids": ids,
        "token_type_ids": np.zeros((rows, seq_len), np.int32),
        "attention_mask": np.ones((rows, seq_len), np.int32),
        "segments": segments,
        "position_ids": position_ids,
        "cls_positions": cls_positions,
        "next_sentence_labels": nsp,
        "labels": np.where(rng.random((rows, seq_len)) < 0.15, ids,
                           -1).astype(np.int32),
    }


def fake_hidden_states(batch, seq_len, hidden, seed=0):
    """Standard-normal float32 activations [batch, seq_len, hidden] from
    ``np.random.default_rng(seed)``: an encoder stack's input, as the
    reference dryrun's pipeline leg draws it."""
    return np.random.default_rng(seed).standard_normal(
        (batch, seq_len, hidden)).astype(np.float32)


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
    atomic_write(os.path.join(out_dir, ".num_samples.json"),
                 json.dumps(counts, sort_keys=True))


def write_balanced_shards(out_dir, tokens, num_bins=4, bin_size=128,
                          shards_per_bin=2, samples_per_shard=64,
                          masking=True, seed=0):
    """Write ``num_bins`` x ``shards_per_bin`` balanced schema-v2 shards
    (bin k holds samples of k*bin_size+1 .. (k+1)*bin_size tokens) and the
    ``.num_samples.json`` cache; returns {basename: count}."""
    import pyarrow as pa
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
            write_table_atomic(pa.table(cols), os.path.join(out_dir, name),
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
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    counts = {}
    for i in range(num_shards):
        cols = _bert_columns(rng, samples_per_shard, min_tokens, max_tokens,
                             tokens, masking)
        name = "shard-{}.parquet".format(i)
        write_table_atomic(pa.table(cols), os.path.join(out_dir, name),
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
        write_table_atomic(rows, os.path.join(out_dir, name),
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
        write_table_atomic(table, os.path.join(out_dir, name),
                           compression="lz4")
        counts[name] = samples_per_shard
    _write_num_samples(out_dir, counts)
    return counts


# Words the rules splitter must not split after, and decimals it must
# not split inside.
_ABBREVIATIONS = ("Dr.", "Mr.", "e.g.", "i.e.", "etc.", "U.S.", "vs.",
                  "No.", "Jan.", "approx.")
_ACCENTED = str.maketrans("aeiouc", "àéîöüç")


def write_text_corpus(root, tokens, total_bytes, num_files=64, seed=0,
                      sentences=(5, 60), words=(4, 24)):
    """Write about ``total_bytes`` of text under ``root/source/`` in
    ``num_files`` files, one document per line (``<doc-id> <text>``), each
    document ``sentences`` (inclusive range) sentences of ``words`` words;
    returns the bytes written.

    Words are the vocab's whole-word tokens (``tokens`` as
    ``write_vocab`` returns them), drawn with Zipf-like weights
    (1 / (rank + 10)). Some carry a glued ``##`` continuation piece, some
    are capitalised and some accented (WordPiece splitting and the
    normaliser's case and accent folds); sentences end in ``.``, ``?`` or
    ``!`` and hold some abbreviations and decimals (the rules splitter's
    guards)."""
    rng = np.random.default_rng(seed)
    whole = np.array([t for t in tokens[len(SPECIAL_TOKENS):]
                      if not t.startswith("##")], dtype=object)
    pieces = np.array([t[2:] for t in tokens if t.startswith("##")],
                      dtype=object)
    weights = 1.0 / (np.arange(len(whole)) + 10.0)
    weights /= weights.sum()
    caps = np.array([w.capitalize() for w in whole], dtype=object)
    accented = np.array([w.translate(_ACCENTED) for w in whole],
                        dtype=object)
    source = os.path.join(root, "source")
    os.makedirs(source, exist_ok=True)
    per_file = max(1, total_bytes // num_files)
    written = 0
    doc = 0
    for f in range(num_files):
        lines, size = [], 0
        while size < per_file:
            n_sent = int(rng.integers(sentences[0], sentences[1] + 1))
            lens = rng.integers(words[0], words[1] + 1, n_sent)
            n = int(lens.sum())
            idx = rng.choice(len(whole), n, p=weights)
            form = rng.random(n)
            ws = np.where(form < 0.04, caps[idx],
                          np.where(form < 0.06, accented[idx], whole[idx]))
            glue = rng.random(n) < 0.05
            ws[glue] = ws[glue] + pieces[rng.integers(0, len(pieces),
                                                      int(glue.sum()))]
            extra = rng.random(n)
            ws[extra < 0.01] = np.array(_ABBREVIATIONS, dtype=object)[
                rng.integers(0, len(_ABBREVIATIONS),
                             int((extra < 0.01).sum()))]
            dec = (extra >= 0.01) & (extra < 0.015)
            ws[dec] = ["{}.{}".format(a, b) for a, b in zip(
                rng.integers(0, 100, int(dec.sum())),
                rng.integers(0, 100, int(dec.sum())))]
            ends = np.cumsum(lens)
            starts = ends - lens
            ws[starts] = [w.capitalize() for w in ws[starts]]
            ws[ends - 1] = ws[ends - 1] + np.array(
                [".", ".", ".", "?", "!"], dtype=object)[
                    rng.integers(0, 5, n_sent)]
            line = "doc-{} {}\n".format(doc, " ".join(ws))
            doc += 1
            lines.append(line)
            size += len(line.encode("utf-8"))
        with open(os.path.join(source, "{}.txt".format(f)), "w",
                  encoding="utf-8") as fh:
            fh.write("".join(lines))
        written += size
    return written


# make_corpus's letters (English frequencies), accents and CJK characters.
_ACCENTS = list("éàüñöçåèêôîûáíóúäß")
_CJK = [chr(c) for c in range(0x4E00, 0x4E60)]
_LETTERS = "etaoinshrdlucmfwypvbgkqjxz"
_LETTER_P = np.array([
    12.7, 9.1, 8.2, 7.5, 7.0, 6.7, 6.3, 6.1, 6.0, 4.3, 4.0, 2.8, 2.8, 2.4,
    2.4, 2.4, 2.0, 2.0, 1.9, 1.5, 1.0, 0.8, 0.15, 0.15, 0.15, 0.07])
_LETTER_P = _LETTER_P / _LETTER_P.sum()


def make_lexicon(g, n_types=30000):
    """Procedural word types drawn from generator ``g``:
    letter-frequency-weighted latin strings, some accented, some with
    digits, some CJK runs, so a vocab trained on a sample must split the
    tail into several pieces."""
    lengths = g.integers(2, 13, size=n_types)
    letters = np.array(list(_LETTERS))
    words = []
    for i in range(n_types):
        n = int(lengths[i])
        w = "".join(letters[g.choice(26, size=n, p=_LETTER_P)])
        r = g.random()
        if r < 0.05:  # accented
            pos = int(g.integers(0, n))
            w = (w[:pos] + _ACCENTS[int(g.integers(0, len(_ACCENTS)))]
                 + w[pos + 1:])
        elif r < 0.07:  # digits (years, measures)
            w = str(int(g.integers(0, 10000))) if g.random() < 0.5 else (
                w + str(int(g.integers(0, 100))))
        elif r < 0.075:  # a CJK run
            w = "".join(_CJK[int(g.integers(0, len(_CJK)))]
                        for _ in range(int(g.integers(1, 4))))
        words.append(w)
    return words


def make_corpus(out_root, target_mb, shards=4, seed=0, n_types=30000,
                zipf_a=1.07):
    """Write about ``target_mb`` MiB of Wikipedia-like text under
    ``out_root/source/<i>.txt`` (``shards`` files, one ``wiki-<n> <text>``
    document per line, words Zipf(``zipf_a``)-distributed over
    ``make_lexicon``'s types). Returns (bytes written, distinct types)."""
    source = os.path.join(out_root, "source")
    os.makedirs(source)
    g = np.random.default_rng(seed)
    lexicon = np.asarray(make_lexicon(g, n_types=n_types), dtype=object)
    ranks = np.arange(1, n_types + 1, dtype=np.float64)
    cdf = np.cumsum(1.0 / ranks ** zipf_a)
    cdf /= cdf[-1]
    punct = np.array([".", ".", ".", ".", "!", "?"], dtype=object)
    target_bytes = int(target_mb * 1024 * 1024)
    written = 0
    doc_id = 0
    files = [open(os.path.join(source, "{}.txt".format(i)), "w",
                  encoding="utf-8") for i in range(shards)]
    try:
        while written < target_bytes:
            n_sents = int(g.integers(8, 40))
            sent_lens = g.integers(6, 32, size=n_sents)
            total = int(sent_lens.sum())
            doc_words = lexicon[np.searchsorted(cdf, g.random(total))]
            sents = []
            pos = 0
            for sl in sent_lens:
                s = " ".join(doc_words[pos:pos + int(sl)])
                pos += int(sl)
                sents.append(s.capitalize()
                             + str(punct[int(g.integers(0, len(punct)))]))
            line = "wiki-{} {}\n".format(doc_id, " ".join(sents))
            files[doc_id % shards].write(line)
            written += len(line.encode("utf-8"))
            doc_id += 1
    finally:
        for f in files:
            f.close()
    return written, len(set(lexicon.tolist()))
