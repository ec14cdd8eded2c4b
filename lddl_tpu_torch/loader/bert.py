"""BERT pretraining data loader: schema-v2 decode, collation, dynamic
masking, factory.

Counterpart of ``lddl_tpu/loader/bert.py`` (``_decode_columnar``,
``BertCollate`` with ``_mask_tokens``, ``BertPretrainBinned``,
``get_bert_pretrain_data_loader``) for balanced schema-v2 shards, binned
or not, with static masking (5-tuples from the stored
``masked_lm_*_ids`` columns) or dynamic masking (3-tuples, masked in the
collate from the per-worker stream). Batches are numpy int32 dicts, byte
for byte the reference loader's; ``dataloader.prefetch_to_device`` moves
them to the card.
"""

import numpy as np

from ..utils.fs import (get_all_bin_ids, get_all_parquets_under,
                        get_file_paths_for_bin_id)
from .dataloader import Binned, DataLoader
from .datasets import ParquetDataset
from .vocab import Vocab


def _list_views(col):
    """(values, offsets) numpy views of an Arrow ``list<int32>`` column."""
    lens = col.value_lengths().to_numpy(zero_copy_only=False)
    values = col.flatten().to_numpy(zero_copy_only=True)
    offsets = np.zeros(len(lens) + 1, dtype=np.int64)
    np.cumsum(lens, out=offsets[1:])
    return values, offsets


def _decode_columnar(b, names):
    """Schema-v2 rows as int32 ndarray views: (A_ids, B_ids,
    is_random_next[, masked_lm_positions_ids, masked_lm_label_ids])."""
    flat_a, off_a = _list_views(b.column("A_ids"))
    flat_b, off_b = _list_views(b.column("B_ids"))
    rn = b.column("is_random_next").to_numpy(zero_copy_only=False)
    n = len(rn)
    if "masked_lm_positions_ids" in names:
        pos_v, pos_off = _list_views(b.column("masked_lm_positions_ids"))
        lab_v, lab_off = _list_views(b.column("masked_lm_label_ids"))
        for i in range(n):
            yield (flat_a[off_a[i]:off_a[i + 1]],
                   flat_b[off_b[i]:off_b[i + 1]], rn[i],
                   pos_v[pos_off[i]:pos_off[i + 1]],
                   lab_v[lab_off[i]:lab_off[i + 1]])
    else:
        for i in range(n):
            yield (flat_a[off_a[i]:off_a[i + 1]],
                   flat_b[off_b[i]:off_b[i + 1]], rn[i])


def decode_record_batch(b):
    """Sample tuples from a schema-v2 parquet RecordBatch."""
    names = b.schema.names
    if "pack_a_lens" in names or "A_ids" not in names:
        raise ValueError(
            "only unpacked schema-v2 BERT shards (A_ids/B_ids columns) are "
            "supported; found columns {}".format(names))
    yield from _decode_columnar(b, names)


def _concat_aranges(lens):
    """[arange(l) for l in lens] concatenated, without a Python loop."""
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    starts = np.cumsum(lens) - lens
    return np.arange(total, dtype=np.int64) - np.repeat(starts, lens)


def _flat_and_lens(seqs):
    """One flat int32 array + per-item lengths of a list of id views."""
    lens = np.fromiter(map(len, seqs), dtype=np.int64, count=len(seqs))
    flat = np.concatenate(seqs) if seqs else np.zeros(0, dtype=np.int32)
    return np.ascontiguousarray(flat, dtype=np.int32), lens


class BertCollate:
    """samples -> encoded numpy batch dict with keys input_ids,
    token_type_ids, attention_mask, next_sentence_labels, labels. Static
    masking (5-tuples) places the stored labels; dynamic masking
    (3-tuples) masks with the worker stream."""

    needs_rng = True

    def __init__(self, tokenizer, sequence_length_alignment=8,
                 fixed_seq_length=None, ignore_index=-1, mlm_prob=0.15):
        self._align = sequence_length_alignment
        self._fixed_seq_length = fixed_seq_length
        self._ignore_index = ignore_index
        self._mlm_prob = mlm_prob
        self._mask_id = tokenizer.convert_tokens_to_ids("[MASK]")
        self._cls_id = tokenizer.convert_tokens_to_ids("[CLS]")
        self._sep_id = tokenizer.convert_tokens_to_ids("[SEP]")
        self._vocab_size = len(tokenizer)

    def _batch_seq_len(self, longest):
        if self._fixed_seq_length is not None:
            if longest > self._fixed_seq_length:
                raise ValueError(
                    "sample of {} tokens exceeds fixed_seq_length {}".format(
                        longest, self._fixed_seq_length))
            return self._fixed_seq_length
        return ((longest - 1) // self._align + 1) * self._align

    def __call__(self, samples, g=None):
        n = len(samples)
        static = len(samples[0]) == 5
        flat_a, lens_a = _flat_and_lens([s[0] for s in samples])
        flat_b, lens_b = _flat_and_lens([s[1] for s in samples])
        ends = lens_a + lens_b + 3
        seq_len = self._batch_seq_len(int(ends.max()))

        rows = np.arange(n, dtype=np.int64)
        col = np.arange(seq_len, dtype=np.int64)[None, :]
        # Flat scatter targets of the A and B segments.
        idx_a = (np.repeat(rows, lens_a) * seq_len
                 + 1 + _concat_aranges(lens_a))
        idx_b = (np.repeat(rows * seq_len + 2 + lens_a, lens_b)
                 + _concat_aranges(lens_b))

        input_ids = np.zeros((n, seq_len), dtype=np.int32)
        input_ids[:, 0] = self._cls_id
        input_ids.flat[idx_a] = flat_a
        input_ids.flat[idx_b] = flat_b
        input_ids[rows, 1 + lens_a] = self._sep_id
        input_ids[rows, ends - 1] = self._sep_id

        token_type_ids = ((col >= (2 + lens_a)[:, None])
                          & (col < ends[:, None])).astype(np.int32)
        attention_mask = (col < ends[:, None]).astype(np.int32)

        labels = np.full((n, seq_len), self._ignore_index, dtype=np.int32)
        if static:
            pos = [s[3] for s in samples]
            pos_lens = np.fromiter(map(len, pos), dtype=np.int64, count=n)
            flat_pos = np.concatenate(pos).astype(np.int64, copy=False)
            flat_labels, lens_m = _flat_and_lens([s[4] for s in samples])
            if not np.array_equal(pos_lens, lens_m):
                raise ValueError(
                    "masked_lm_positions/masked_lm_labels length mismatch "
                    "in sample(s) {}".format(
                        np.flatnonzero(pos_lens != lens_m).tolist()))
            labels[np.repeat(rows, lens_m), flat_pos] = flat_labels
        else:
            if g is None:
                raise ValueError("dynamic masking needs a worker RNG")
            special_tokens_mask = np.ones((n, seq_len), dtype=bool)
            special_tokens_mask.flat[idx_a] = False
            special_tokens_mask.flat[idx_b] = False
            input_ids, labels = self._mask_tokens(
                input_ids, special_tokens_mask, g)

        return {
            "input_ids": input_ids,
            "token_type_ids": token_type_ids,
            "attention_mask": attention_mask,
            "next_sentence_labels": np.asarray(
                [int(s[2]) for s in samples], dtype=np.int32),
            "labels": labels,
        }

    def _mask_tokens(self, input_ids, special_tokens_mask, g):
        """Vectorized dynamic masking: select ~mlm_prob of non-special
        tokens; of those 80% -> [MASK], 10% -> random token, 10% kept."""
        shape = input_ids.shape
        masked = (g.random(shape) < self._mlm_prob) & ~special_tokens_mask
        labels = np.where(masked, input_ids,
                          self._ignore_index).astype(np.int32)
        r = g.random(shape)
        out = input_ids.copy()
        out[masked & (r < 0.8)] = self._mask_id
        random_sel = masked & (r >= 0.8) & (r < 0.9)
        random_words = g.integers(0, self._vocab_size, shape, dtype=np.int32)
        out[random_sel] = random_words[random_sel]
        return out, labels


class BertPretrainBinned(Binned):

    def _get_batch_size(self, batch):
        return len(batch["input_ids"])


def get_bert_pretrain_data_loader(
    path,
    dp_rank=0,
    num_dp_groups=1,
    batch_size=64,
    num_workers=1,
    shuffle_buffer_size=16384,
    shuffle_buffer_warmup_factor=16,
    vocab_file=None,
    sequence_length_alignment=8,
    fixed_seq_lengths=None,
    ignore_index=-1,
    mlm_prob=0.15,
    base_seed=12345,
    start_epoch=0,
    prefetch=2,
):
    """The BERT pretraining loader over balanced schema-v2 shards at
    ``path``. Binned vs unbinned comes from the shard filenames, static vs
    dynamic masking from the parquet schema. ``fixed_seq_lengths`` pads
    every batch of a bin to that bin's length (an int, or one entry per
    bin). ``dp_rank``/``num_dp_groups`` name this process's data-parallel
    group; all processes of a group receive identical batches. The
    special-token ids and the vocabulary size come from ``vocab_file``."""
    if vocab_file is None:
        raise ValueError("need vocab_file")
    tokenizer = Vocab(vocab_file)
    file_paths = get_all_parquets_under(path)
    if not file_paths:
        raise ValueError("no parquet shards under {}".format(path))
    bin_ids = get_all_bin_ids(file_paths)

    def make_dataset(paths):
        return ParquetDataset(
            paths,
            base_seed=base_seed,
            start_epoch=start_epoch,
            dp_rank=dp_rank,
            num_dp_groups=num_dp_groups,
            num_workers=num_workers,
            shuffle_buffer_size=shuffle_buffer_size,
            shuffle_buffer_warmup_factor=shuffle_buffer_warmup_factor,
            decode_record_batch=decode_record_batch,
        )

    def make_collate(fixed_seq_length):
        return BertCollate(
            tokenizer,
            sequence_length_alignment=sequence_length_alignment,
            fixed_seq_length=fixed_seq_length,
            ignore_index=ignore_index,
            mlm_prob=mlm_prob,
        )

    if bin_ids:
        if fixed_seq_lengths is None:
            fixed_seq_lengths = [None] * len(bin_ids)
        elif len(fixed_seq_lengths) != len(bin_ids):
            raise ValueError(
                "fixed_seq_lengths has {} entries for {} bins".format(
                    len(fixed_seq_lengths), len(bin_ids)))
        loaders = [
            DataLoader(make_dataset(get_file_paths_for_bin_id(file_paths, b)),
                       batch_size,
                       collate_fn=make_collate(fixed_seq_lengths[b]),
                       prefetch=prefetch)
            for b in bin_ids
        ]
        return BertPretrainBinned(loaders, base_seed=base_seed,
                                  start_epoch=start_epoch)
    fixed = fixed_seq_lengths
    if isinstance(fixed, (list, tuple)):
        if len(fixed) != 1:
            raise ValueError("unbinned data takes a single fixed_seq_length")
        fixed = fixed[0]
    return DataLoader(make_dataset(file_paths), batch_size,
                      collate_fn=make_collate(fixed), prefetch=prefetch)
