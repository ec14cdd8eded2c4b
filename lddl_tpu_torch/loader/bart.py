"""BART denoising data loader: schema-v2 decode, text infilling and
sentence permutation, factory.

Counterpart of ``lddl_tpu/loader/bart.py`` (``decode_record_batch``,
``BartCollate``, ``get_bart_pretrain_data_loader``) for schema-v2 BART
shards, whose ``sentence_ids``/``sentence_lens`` columns hold each chunk's
per-sentence token ids. Schema-v1 shards (the ``sentences`` text column
alone) need a sentence splitter and a tokenizer at load time and are
refused. The noise draws from the per-(epoch, dp group, worker) stream
that ``DataLoader`` binds into the collate, in the reference's order, so
batches are numpy int32 dicts byte for byte the reference loader's:

- sentence permutation: the chunk's sentences are shuffled;
- text infilling: token spans with Poisson(lambda=3) lengths are each
  replaced by a single [MASK] until ~``mask_ratio`` of the tokens are
  covered (0-length spans insert a lone [MASK]).

Batch keys: input_ids (noised), attention_mask, decoder_input_ids
(shift-right of the clean sequence), labels (clean ids, ignore_index on
padding).
"""

import numpy as np

from ..utils import rng as lrng
from ..utils.fs import get_all_parquets_under
from .bert import _list_views
from .dataloader import DataLoader
from .datasets import ParquetDataset
from .vocab import Vocab


def round_up(n, multiple):
    return ((n - 1) // multiple + 1) * multiple


def decode_record_batch(b):
    """Schema-v2 BART rows as ``(flat_ids, sent_lens)`` int32 ndarray-view
    pairs; raises on a schema-v1 (text-only) shard."""
    names = b.schema.names
    if "sentence_ids" not in names or "sentence_lens" not in names:
        raise ValueError(
            "only schema-v2 BART shards (sentence_ids/sentence_lens "
            "columns, written by a preprocess run with a tokenizer) are "
            "supported; found columns {}".format(names))
    flat, off = _list_views(b.column("sentence_ids"))
    lens_v, lens_off = _list_views(b.column("sentence_lens"))
    for i in range(len(off) - 1):
        yield (flat[off[i]:off[i + 1]], lens_v[lens_off[i]:lens_off[i + 1]])


class BartCollate:
    """samples -> noised encoder/decoder numpy batch dict; the noise draws
    from the worker stream ``g``."""

    needs_rng = True

    def __init__(self, tokenizer, max_seq_length=128, mask_ratio=0.3,
                 poisson_lambda=3.0, permute_sentences=True,
                 sequence_length_alignment=8, fixed_seq_length=None,
                 ignore_index=-1, decoder_start_token_id=None):
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
        for flat_ids, sent_lens in samples:
            # Truncate to the clean window first, then permute and infill:
            # encoder input and labels cover the same tokens.
            ends = np.cumsum(sent_lens)
            sent_ids = []
            budget = limit
            for l, e in zip(sent_lens, ends):
                if budget <= 0:
                    break
                ids = flat_ids[e - l:e][:budget]
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
    vocab_file=None,
    max_seq_length=128,
    mask_ratio=0.3,
    poisson_lambda=3.0,
    permute_sentences=True,
    sequence_length_alignment=8,
    fixed_seq_length=None,
    ignore_index=-1,
    base_seed=12345,
    start_epoch=0,
    prefetch=2,
):
    """The BART denoising loader over balanced schema-v2 shards at
    ``path``. ``dp_rank``/``num_dp_groups`` name this process's
    data-parallel group; all processes of a group receive identical
    batches. The special-token ids come from ``vocab_file``, which must be
    the vocabulary the shards were tokenized with. ``fixed_seq_length``
    pads every batch to that length (it must cover ``max_seq_length``'s
    window)."""
    if vocab_file is None:
        raise ValueError("need vocab_file")
    tokenizer = Vocab(vocab_file)
    file_paths = get_all_parquets_under(path)
    if not file_paths:
        raise ValueError("no parquet shards under {}".format(path))
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
    )
    collate = BartCollate(
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
                      prefetch=prefetch)
