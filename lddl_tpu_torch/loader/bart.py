"""BART denoising data loader: decode, text infilling and sentence
permutation, factory.

Counterpart of ``lddl_tpu/loader/bart.py`` (``decode_record_batch``,
``BartCollate``, ``get_bart_pretrain_data_loader``). Schema-v2 shards
store each chunk's per-sentence token ids (``sentence_ids``/
``sentence_lens``) and decode to int32 views; schema-v1 shards store the
chunk text (``sentences``), which the collate splits into sentences
(``preprocess.sentences.split_sentences``) and tokenizes with the native
engine, every epoch, as the reference does with its tokenizer. The noise
draws from the per-(epoch, dp group, worker) stream that ``DataLoader``
binds into the collate, in the reference's order, so batches are numpy
int32 dicts byte for byte the reference loader's:

- sentence permutation: the chunk's sentences are shuffled;
- text infilling: token spans with Poisson(lambda=3) lengths are each
  replaced by a single [MASK] until ~``mask_ratio`` of the tokens are
  covered (0-length spans insert a lone [MASK]).

Batch keys: input_ids (noised), attention_mask, decoder_input_ids
(shift-right of the clean sequence), labels (clean ids, ignore_index on
padding).
"""

import numpy as np

from .. import observability as obs
from ..utils import rng as lrng
from ..utils.fs import get_all_parquets_under
from ..utils.logging import DatasetLogger
from .bert import _list_views
from .dataloader import DataLoader
from .datasets import (ParquetDataset, annotate_quarantine,
                       verified_shard_paths)


def round_up(n, multiple):
    return ((n - 1) // multiple + 1) * multiple


def decode_record_batch(b):
    """Schema-v2 BART rows as ``(flat_ids, sent_lens)`` int32 view pairs;
    schema-v1 rows as their chunk strings. The schema is read per
    shard."""
    names = b.schema.names
    if "sentence_ids" in names:
        obs.inc("loader_decode_columnar_batches_total")
        flat, off = _list_views(b.column("sentence_ids"))
        lens_v, lens_off = _list_views(b.column("sentence_lens"))
        for i in range(len(off) - 1):
            yield (flat[off[i]:off[i + 1]],
                   lens_v[lens_off[i]:lens_off[i + 1]])
        return
    obs.inc("loader_decode_legacy_batches_total")
    yield from b.column("sentences").to_pylist()


class BartCollate:
    """samples -> noised encoder/decoder numpy batch dict; the noise draws
    from the worker stream ``g``."""

    needs_rng = True

    def __init__(self, tokenizer, max_seq_length=128, mask_ratio=0.3,
                 poisson_lambda=3.0, permute_sentences=True,
                 sequence_length_alignment=8, fixed_seq_length=None,
                 ignore_index=-1, decoder_start_token_id=None):
        self._tokenizer = tokenizer
        self._native = None   # built at the first schema-v1 batch
        self._max_seq_length = max_seq_length
        self._mask_ratio = mask_ratio
        self._poisson_lambda = poisson_lambda
        self._permute_sentences = permute_sentences
        self._align = sequence_length_alignment
        self._fixed_seq_length = fixed_seq_length
        self._ignore_index = ignore_index
        self._mask_id = tokenizer.convert_tokens_to_ids("[MASK]")
        self._cls_id = tokenizer.convert_tokens_to_ids("[CLS]")
        self._sep_id = tokenizer.convert_tokens_to_ids("[SEP]")
        self._pad_id = tokenizer.convert_tokens_to_ids("[PAD]")
        self._decoder_start = (decoder_start_token_id
                               if decoder_start_token_id is not None
                               else self._cls_id)

    def __getstate__(self):
        state = self.__dict__.copy()
        state["_native"] = None   # rebuilt where it is used
        return state

    def _tokenize_sentences(self, sentences):
        """Token ids of each sentence, as a vocab-file BertTokenizerFast
        gives them without special tokens: ``native.tokenize_sentences``,
        the function the BART preprocess stores schema-v2 ids with."""
        from ..native import NativeTokenizer, tokenize_sentences
        if self._native is None:
            vocab = self._tokenizer.get_vocab()
            id_to_token = [""] * (max(vocab.values()) + 1)
            for tok, i in vocab.items():
                id_to_token[i] = tok
            self._native = NativeTokenizer(
                id_to_token, self._tokenizer.convert_tokens_to_ids("[UNK]"),
                getattr(self._tokenizer, "do_lower_case", True))
        ids, lens = tokenize_sentences(self._native, sentences)
        ends = np.cumsum(lens)
        return [ids[e - n:e].tolist() for n, e in zip(lens.tolist(),
                                                       ends.tolist())]

    def _sentence_ids(self, samples):
        """Per sample, its sentences' token-id sequences: slices of the
        stored ids (schema v2), or split and tokenized chunk text (v1)."""
        per_sample = [None] * len(samples)
        strings = [i for i, c in enumerate(samples) if isinstance(c, str)]
        for i, c in enumerate(samples):
            if not isinstance(c, str):
                flat_ids, sent_lens = c
                ends = np.cumsum(sent_lens)
                per_sample[i] = [flat_ids[e - l:e]
                                 for l, e in zip(sent_lens, ends)]
        if strings:
            from ..preprocess.sentences import split_sentences
            per_sent = [split_sentences(samples[i]) for i in strings]
            enc = self._tokenize_sentences(
                [s for sents in per_sent for s in sents])
            k = 0
            for i, sents in zip(strings, per_sent):
                per_sample[i] = enc[k:k + len(sents)]
                k += len(sents)
        return per_sample

    def _noise_ids(self, ids, g):
        """Text infilling over one id list; returns the noised list."""
        n = len(ids)
        if n == 0:
            return list(ids)
        budget = int(round(n * self._mask_ratio))
        out = list(ids)
        # Inserts (0-length spans) sit at gap positions 0..n; a replacement
        # span (s, e) owns tokens s..e-1 and interior gaps s+1..e-1. Spans
        # and inserts stay off each other's territory, so the right-to-left
        # application below never swallows an inserted [MASK] and the spent
        # budget equals the masked token count.
        covered = np.zeros(n, dtype=bool)
        gap_covered = np.zeros(n + 1, dtype=bool)
        insert_at = np.zeros(n + 1, dtype=bool)
        spans = []
        tries = 0
        while budget > 0 and tries < 4 * n:
            tries += 1
            length = int(g.poisson(self._poisson_lambda))
            start = int(g.integers(0, n))
            if length == 0:
                if gap_covered[start]:
                    continue
                insert_at[start] = True
                spans.append((start, 0))
                budget -= 1
                continue
            end = min(n, start + length)
            if covered[start:end].any() or insert_at[start + 1:end].any():
                continue
            covered[start:end] = True
            gap_covered[start + 1:end] = True
            spans.append((start, end - start))
            budget -= (end - start)
        # Right to left so indices stay valid; at equal start the
        # replacement sorts after the insert and applies first.
        for start, length in sorted(spans, reverse=True):
            out[start:start + length] = [self._mask_id]
        return out

    def __call__(self, samples, g=None):
        if g is None:
            raise ValueError("BART noising needs a worker RNG")
        limit = self._max_seq_length - 2
        clean, noisy = [], []
        for sample_ids in self._sentence_ids(samples):
            # Truncate to the clean window first, then permute and infill:
            # encoder input and labels cover the same tokens.
            sent_ids = []
            budget = limit
            for ids in sample_ids:
                if budget <= 0:
                    break
                ids = ids[:budget]
                if len(ids):
                    sent_ids.append(ids)
                    budget -= len(ids)
            clean.append([i for s in sent_ids for i in s])
            if self._permute_sentences and len(sent_ids) > 1:
                lrng.shuffle(g, sent_ids)
            permuted = [i for s in sent_ids for i in s]
            # Inserts can grow the sequence: clamp back to the window.
            noisy.append(self._noise_ids(permuted, g)[:limit])

        n = len(samples)
        longest = max(max(len(x) for x in noisy),
                      max(len(x) for x in clean)) + 2
        if self._fixed_seq_length is not None:
            if longest > self._fixed_seq_length:
                raise ValueError(
                    "sample of {} tokens exceeds fixed_seq_length {}".format(
                        longest, self._fixed_seq_length))
            seq_len = self._fixed_seq_length
        else:
            seq_len = round_up(longest, self._align)

        input_ids = np.full((n, seq_len), self._pad_id, dtype=np.int32)
        attention_mask = np.zeros((n, seq_len), dtype=np.int32)
        decoder_input_ids = np.full((n, seq_len), self._pad_id,
                                    dtype=np.int32)
        labels = np.full((n, seq_len), self._ignore_index, dtype=np.int32)
        for i, (nz, cl) in enumerate(zip(noisy, clean)):
            e = [self._cls_id] + nz + [self._sep_id]
            d = [self._cls_id] + cl + [self._sep_id]
            input_ids[i, :len(e)] = e
            attention_mask[i, :len(e)] = 1
            # Teacher forcing: the decoder sees the clean sequence shifted
            # right.
            decoder_input_ids[i, 0] = self._decoder_start
            decoder_input_ids[i, 1:len(d)] = d[:-1]
            labels[i, :len(d)] = d
        return {
            "input_ids": input_ids,
            "attention_mask": attention_mask,
            "decoder_input_ids": decoder_input_ids,
            "labels": labels,
        }


def get_bart_pretrain_data_loader(
    path,
    dp_rank=0,
    num_dp_groups=1,
    batch_size=64,
    num_workers=1,
    shuffle_buffer_size=16384,
    shuffle_buffer_warmup_factor=16,
    tokenizer=None,
    vocab_file=None,
    tokenizer_name=None,
    max_seq_length=128,
    mask_ratio=0.3,
    poisson_lambda=3.0,
    permute_sentences=True,
    sequence_length_alignment=8,
    fixed_seq_length=None,
    ignore_index=-1,
    base_seed=12345,
    start_epoch=0,
    log_dir=None,
    log_level=None,
    return_raw_samples=False,
    prefetch=2,
    comm=None,
    worker_mode="thread",
    on_corrupt=None,
):
    """The BART denoising loader over balanced BART shards at ``path``
    (schema v1 or v2). ``dp_rank``/``num_dp_groups`` name this process's
    data-parallel group; all processes of a group receive identical
    batches. The vocabulary comes from ``tokenizer``, ``vocab_file`` or
    ``tokenizer_name`` (see get_bert_pretrain_data_loader) and must be
    the one the shards were tokenized with. ``fixed_seq_length`` pads
    every batch to that length (it must cover ``max_seq_length``'s
    window). ``worker_mode``, ``on_corrupt``, ``comm``, ``log_dir`` and
    ``log_level`` are as for the BERT loader."""
    import logging
    if tokenizer is None:
        from ..preprocess.tokenizer import get_tokenizer
        tokenizer = get_tokenizer(vocab_file=vocab_file,
                                  pretrained_model_name=tokenizer_name)
    logger = DatasetLogger(
        log_dir=log_dir,
        log_level=log_level if log_level is not None else logging.WARNING,
        rank=dp_rank)
    file_paths = get_all_parquets_under(path)
    if not file_paths:
        raise ValueError("no parquet shards under {}".format(path))
    n_before = len(file_paths)
    file_paths = verified_shard_paths(path, file_paths,
                                      on_corrupt=on_corrupt, logger=logger,
                                      comm=comm)
    n_quarantined = n_before - len(file_paths)
    try:
        dataset = ParquetDataset(
            file_paths,
            base_seed=base_seed,
            start_epoch=start_epoch,
            dp_rank=dp_rank,
            num_dp_groups=num_dp_groups,
            num_workers=num_workers,
            shuffle_buffer_size=shuffle_buffer_size,
            shuffle_buffer_warmup_factor=shuffle_buffer_warmup_factor,
            decode_record_batch=decode_record_batch,
            comm=comm,
            logger=logger)
    except ValueError as e:
        if n_quarantined:
            raise annotate_quarantine(e, n_quarantined) from e
        raise
    collate = None if return_raw_samples else BartCollate(
        tokenizer,
        max_seq_length=max_seq_length,
        mask_ratio=mask_ratio,
        poisson_lambda=poisson_lambda,
        permute_sentences=permute_sentences,
        sequence_length_alignment=sequence_length_alignment,
        fixed_seq_length=fixed_seq_length,
        ignore_index=ignore_index,
    )
    return DataLoader(dataset, batch_size, collate_fn=collate,
                      prefetch=prefetch, worker_mode=worker_mode)
