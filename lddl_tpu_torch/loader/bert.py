"""BERT pretraining data loader: decode, collation, dynamic masking,
sequence packing, generation following, factory.

Counterpart of ``lddl_tpu/loader/bert.py``. Shards of schema v2 decode to
int32 views of their token-id columns; shards of schema v1 decode to the
stored strings (space-joined tokens, serialized masked positions), which
the collate maps to ids through the vocab. Binned or not, static masking
(5-tuples) or dynamic (3-tuples, masked in the collate from the
per-worker stream), and packed rows: packed at load time from unbinned
shards (``pack_seq_length`` + ``pack_rows``) or offline-packed shards,
detected from the manifest or a shard's footer. Batches are numpy int32
dicts, byte for byte the reference loader's;
``dataloader.prefetch_to_device`` moves them to the card.

``follow_generations=True`` serves a streaming-ingestion directory as a
growing dataset: each epoch boundary re-reads the root manifest's
generation gate (``generation_gate_filter``) and picks up newly published
``gen-<NNNN>/`` shards.

Nothing here imports torch: process-mode workers unpickle the decode and
the collates.
"""

import numpy as np

from .. import observability as obs
from ..ops.packing import StreamPacker, packed_layout_arrays
from ..utils import rng as lrng
from ..utils.fs import (deserialize_np_array, get_all_bin_ids,
                        get_all_parquets_under, get_file_paths_for_bin_id,
                        get_generation_of_path)
from ..utils.logging import DatasetLogger
from .dataloader import Binned, DataLoader
from .datasets import (ParquetDataset, annotate_quarantine,
                       verified_shard_paths)


def generation_gate_filter(root, paths):
    """The generation pickup gate: the root ``.manifest.json``'s
    ``__meta__`` generation is the last thing an ingest publish writes,
    so shards under newer generation directories are excluded even when
    their files exist (a generation mid-publish is never visible). A
    directory without a generation in its meta gates nothing. Returns
    (filtered_paths, gate)."""
    from ..resilience.integrity import read_manifest
    manifest = read_manifest(root)
    meta = manifest.get("__meta__") if manifest else None
    gate = meta.get("generation") if isinstance(meta, dict) else None
    if gate is not None:
        paths = [p for p in paths if get_generation_of_path(root, p) <= gate]
    return paths, gate


def packed_shape_of_dir(path, file_paths=None):
    """(pack_seq_length, pack_max_per_row) of an offline-packed shard
    directory, or None. The root ``.manifest.json``'s
    ``__meta__.packed`` entry is authoritative; without one, the first
    shard's footer metadata is sniffed."""
    from ..preprocess.packing import pack_shape_of_parquet
    from ..resilience.integrity import read_manifest
    manifest = read_manifest(path)
    meta = (manifest.get("__meta__") if manifest else None) or {}
    packed = meta.get("packed")
    if isinstance(packed, dict):
        try:
            return (int(packed["pack_seq_length"]),
                    int(packed["pack_max_per_row"]))
        except (KeyError, TypeError, ValueError):
            return None
    if file_paths is None:
        file_paths = get_all_parquets_under(path)
    if file_paths:
        return pack_shape_of_parquet(sorted(file_paths)[0])
    return None


class GenerationSnapshot:
    """One gate + listing read shared by every bin's follower within one
    epoch boundary (keyed by the boundary's epoch), so a publish landing
    between two bins' refreshes cannot give one epoch a mixed view."""

    def __init__(self, root):
        self.root = root
        self._key = None
        self._value = None

    def get(self, key):
        if key is None or key != self._key:
            self._value = generation_gate_filter(
                self.root, get_all_parquets_under(self.root))
            self._key = key
        return self._value


class GenerationFollower:
    """Picklable refresh callable of a generation-following dataset (one
    bin, or the unbinned whole): the currently published, verified shard
    list."""

    def __init__(self, root, bin_id=None, on_corrupt=None, snapshot=None):
        self.root = root
        self.bin_id = bin_id
        self.on_corrupt = on_corrupt
        self.snapshot = snapshot or GenerationSnapshot(root)
        self.last_gate = None
        self._epoch_key = None
        self._last = None  # (gated bin paths, verified result)

    def set_epoch_key(self, key):
        """The boundary's epoch, set by the dataset before the refresh."""
        self._epoch_key = key

    def __call__(self):
        paths, gate = self.snapshot.get(self._epoch_key)
        self.last_gate = gate
        # Filter the bin before verifying, and serve an unchanged set from
        # the memo: verification is a startup/pickup check, not a CRC
        # re-scan every epoch.
        paths = get_file_paths_for_bin_id(paths, self.bin_id)
        if self._last is not None and self._last[0] == paths:
            return list(self._last[1])
        verified = verified_shard_paths(self.root, paths,
                                        on_corrupt=self.on_corrupt)
        self._last = (paths, verified)
        return list(verified)


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


class PackedRow(tuple):
    """One offline-packed shard row decoded to views:
    ``(ids, tok3, content, samp, mlm2)``. ``ids`` is the stored
    interleaved row content; ``tok3`` stacks the per-token
    ``[segments, position_ids, token_type]`` and ``samp`` the per-sample
    ``[a_lens, b_lens, off, nsp(, mask_lens)]``, both computed once per
    decode chunk; ``content`` marks content (not special) tokens for
    dynamic masking; ``mlm2`` stacks ``[positions, labels]`` (row-relative
    positions; None for dynamic masking). A type of its own, so that a
    collate can check it was given packed rows."""

    __slots__ = ()

    ids = property(lambda s: s[0])
    seg = property(lambda s: s[1][0])
    pos = property(lambda s: s[1][1])
    typ = property(lambda s: s[1][2])
    content = property(lambda s: s[2])
    a_lens = property(lambda s: s[3][0])
    b_lens = property(lambda s: s[3][1])
    off = property(lambda s: s[3][2])
    nsp = property(lambda s: s[3][3])
    mask_lens = property(lambda s: s[3][4] if len(s[3]) > 4 else None)
    mlm_pos = property(lambda s: s[4][0] if s[4] is not None else None)
    mlm_labels = property(lambda s: s[4][1] if s[4] is not None else None)


# Decode-chunk token budget: the per-token arrays derived from the
# boundary columns are materialized per chunk of rows, not per record
# batch (a row group may span a whole shard).
_DECODE_CHUNK_TOKENS = 1 << 20


def _decode_prepacked(b, names):
    """Offline-packed rows: one zero-copy buffer grab per column, the
    per-token and per-sample arrays computed once per chunk of rows, then
    one PackedRow of views per parquet row."""
    ids_v, ids_off = _list_views(b.column("input_ids"))
    al_v, al_off = _list_views(b.column("pack_a_lens"))
    nsp_v, _ = _list_views(b.column("pack_nsp"))
    bl_v, _ = _list_views(b.column("pack_b_lens"))
    static = "pack_mask_lens" in names
    if static:
        pos_v, pos_off = _list_views(b.column("masked_lm_positions_ids"))
        lab_v, _ = _list_views(b.column("masked_lm_label_ids"))
        ml_v, _ = _list_views(b.column("pack_mask_lens"))
    n = b.num_rows
    row = 0
    while row < n:
        end = row + 1
        while end < n and ids_off[end + 1] - ids_off[row] \
                <= _DECODE_CHUNK_TOKENS:
            end += 1
        # Chunk-relative arrays for rows [row, end), stacked so that a row
        # is five slices and a batch four axis-1 concatenates.
        s0, s1 = int(al_off[row]), int(al_off[end])
        al = al_v[s0:s1].astype(np.int64)
        bl = bl_v[s0:s1].astype(np.int64)
        spr = (al_off[row:end + 1] - s0).astype(np.int64)
        samples_per_row = np.diff(spr)
        tot = al + bl + 3
        slot = _concat_aranges(samples_per_row)
        pos64 = _concat_aranges(tot)
        tok3 = np.empty((3, len(pos64)), dtype=np.int32)
        tok3[0] = np.repeat(slot + 1, tot)                  # segments
        tok3[1] = pos64                                     # position_ids
        tok3[2] = pos64 >= np.repeat(2 + al, tot)           # token_type
        content = ((pos64 != 0)
                   & (pos64 != np.repeat(1 + al, tot))
                   & (pos64 != np.repeat(tot - 1, tot)))
        cum = np.cumsum(tot) - tot              # token start per sample
        samp = np.empty((5 if static else 4, len(al)), dtype=np.int32)
        samp[0] = al_v[s0:s1]
        samp[1] = bl_v[s0:s1]
        samp[2] = cum - np.repeat(cum[spr[:-1]], samples_per_row)
        samp[3] = nsp_v[s0:s1]
        if static:
            samp[4] = ml_v[s0:s1]
            m0 = int(pos_off[row])
            mlm2 = np.empty((2, int(pos_off[end]) - m0), dtype=np.int32)
            mlm2[0] = pos_v[m0:int(pos_off[end])]
            mlm2[1] = lab_v[m0:int(pos_off[end])]
            mb = (pos_off[row:end + 1] - m0).tolist()
        # Slice bounds as plain ints, once per chunk.
        idsb = ids_off[row:end + 1].tolist()
        trow = (ids_off[row:end + 1] - ids_off[row]).tolist()
        sprl = spr.tolist()
        for i in range(end - row):
            mlm = mlm2[:, mb[i]:mb[i + 1]] if static else None
            yield PackedRow((
                ids_v[idsb[i]:idsb[i + 1]],
                tok3[:, trow[i]:trow[i + 1]], content[trow[i]:trow[i + 1]],
                samp[:, sprl[i]:sprl[i + 1]], mlm))
        row = end


def decode_record_batch(b):
    """Samples from a parquet RecordBatch: one PackedRow per row of an
    offline-packed shard (``pack_a_lens`` present); schema-v2 tuples
    (A_ids, B_ids, is_random_next[, positions, labels]) of int32 views;
    or, for schema v1, the stored strings (A, B, is_random_next[,
    masked_lm_positions, masked_lm_labels]). The schema is read per
    shard, so a directory may mix them."""
    names = b.schema.names
    if "pack_a_lens" in names:
        obs.inc("loader_decode_packed_batches_total")
        yield from _decode_prepacked(b, names)
        return
    if "A_ids" in names:
        obs.inc("loader_decode_columnar_batches_total")
        yield from _decode_columnar(b, names)
        return
    obs.inc("loader_decode_legacy_batches_total")
    cols = ["A", "B", "is_random_next"]
    if "masked_lm_positions" in names:
        cols += ["masked_lm_positions", "masked_lm_labels"]
    yield from zip(*(b.column(c).to_pylist() for c in cols))


def _concat_aranges(lens):
    """[arange(l) for l in lens] concatenated, without a Python loop."""
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    starts = np.cumsum(lens) - lens
    return np.arange(total, dtype=np.int64) - np.repeat(starts, lens)


class BertCollate:
    """samples -> encoded numpy batch dict with keys input_ids,
    token_type_ids, attention_mask, next_sentence_labels, labels, and
    with ``emit_loss_mask`` also ``loss_mask`` (1 where a label is set).
    Static masking (5-tuples) places the stored labels; dynamic masking
    (3-tuples) masks with the worker stream."""

    needs_rng = True

    def __init__(self, tokenizer, sequence_length_alignment=8,
                 fixed_seq_length=None, ignore_index=-1, mlm_prob=0.15,
                 emit_loss_mask=False):
        self._align = sequence_length_alignment
        self._fixed_seq_length = fixed_seq_length
        self._ignore_index = ignore_index
        self._mlm_prob = mlm_prob
        self._emit_loss_mask = emit_loss_mask
        self._mask_id = tokenizer.convert_tokens_to_ids("[MASK]")
        self._cls_id = tokenizer.convert_tokens_to_ids("[CLS]")
        self._sep_id = tokenizer.convert_tokens_to_ids("[SEP]")
        self._vocab_size = len(tokenizer)
        # Schema-v1 token strings map to ids with one dict lookup each.
        self._vocab = dict(tokenizer.get_vocab())
        self._unk_id = tokenizer.convert_tokens_to_ids(
            getattr(tokenizer, "unk_token", None) or "[UNK]")

    def _batch_seq_len(self, longest):
        if self._fixed_seq_length is not None:
            if longest > self._fixed_seq_length:
                raise ValueError(
                    "sample of {} tokens exceeds fixed_seq_length {}".format(
                        longest, self._fixed_seq_length))
            return self._fixed_seq_length
        return ((longest - 1) // self._align + 1) * self._align

    def _token_ids_and_lens(self, seqs):
        """One flat int32 id array + per-item lengths. Items are int32
        id views (schema v2) or space-joined token strings (schema v1),
        freely mixed."""
        vocab_get, unk = self._vocab.get, self._unk_id
        arrs = [s if not isinstance(s, str) else
                np.fromiter((vocab_get(t, unk) for t in s.split()),
                            dtype=np.int32)
                for s in seqs]
        lens = np.fromiter(map(len, arrs), dtype=np.int64, count=len(arrs))
        flat = np.concatenate(arrs) if arrs else np.zeros(0, dtype=np.int32)
        return np.ascontiguousarray(flat, dtype=np.int32), lens

    @staticmethod
    def _positions_and_lens(samples):
        """Flat masked-lm positions + per-sample counts: int32 views
        (schema v2) or ``serialize_np_array`` bytes (schema v1)."""
        pos = [s[3] if not isinstance(s[3], (bytes, bytearray))
               else deserialize_np_array(s[3]) for s in samples]
        lens = np.fromiter(map(len, pos), dtype=np.int64, count=len(pos))
        flat = (np.concatenate(pos).astype(np.int64, copy=False) if pos
                else np.zeros(0, dtype=np.int64))
        return flat, lens

    def _finish(self, batch):
        if self._emit_loss_mask:
            batch["loss_mask"] = (batch["labels"] != self._ignore_index
                                  ).astype(np.int32)
        return batch

    def __call__(self, samples, g=None):
        n = len(samples)
        static = len(samples[0]) == 5
        flat_a, lens_a = self._token_ids_and_lens([s[0] for s in samples])
        flat_b, lens_b = self._token_ids_and_lens([s[1] for s in samples])
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
            flat_pos, pos_lens = self._positions_and_lens(samples)
            flat_labels, lens_m = self._token_ids_and_lens(
                [s[4] for s in samples])
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

        return self._finish({
            "input_ids": input_ids,
            "token_type_ids": token_type_ids,
            "attention_mask": attention_mask,
            "next_sentence_labels": np.asarray(
                [int(s[2]) for s in samples], dtype=np.int32),
            "labels": labels,
        })

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


class BertPackedCollate(BertCollate):
    """samples + packed layout -> packed batch: several samples per row of
    exactly ``pack_seq_length``, with per-token ``segments`` (slot + 1, 0
    = pad) for block-diagonal attention, ``position_ids`` restarting at
    each sample, each sample's [CLS] column in ``cls_positions`` [R, P]
    and NSP labels [R, P] padded with ignore_index."""

    def __init__(self, tokenizer, pack_seq_length, pack_rows,
                 pack_max_per_row, ignore_index=-1, mlm_prob=0.15,
                 emit_loss_mask=False):
        super().__init__(tokenizer, fixed_seq_length=pack_seq_length,
                         ignore_index=ignore_index, mlm_prob=mlm_prob,
                         emit_loss_mask=emit_loss_mask)
        self._rows = pack_rows
        self._max_per_row = pack_max_per_row

    def __call__(self, layout_rows, samples, g=None):
        """(batch, stats): ``stats`` counts pad tokens, total tokens and
        samples."""
        L, P, R = self._fixed_seq_length, self._max_per_row, self._rows
        n = len(samples)
        static = len(samples[0]) == 5
        layout = packed_layout_arrays(layout_rows, L, P)
        if layout["n_rows"] > R or n != len(layout["row_of"]):
            raise ValueError("layout/sample mismatch: {} rows > {} or "
                             "{} != {}".format(layout["n_rows"], R, n,
                                               len(layout["row_of"])))

        flat_a, lens_a = self._token_ids_and_lens([s[0] for s in samples])
        flat_b, lens_b = self._token_ids_and_lens([s[1] for s in samples])
        totals = lens_a + lens_b + 3
        row_of, offset_of = layout["row_of"], layout["offset_of"]
        slot_of = layout["slot_of"]

        base = row_of * L + offset_of              # flat start per sample
        idx_a = np.repeat(base + 1, lens_a) + _concat_aranges(lens_a)
        idx_b = (np.repeat(base + 2 + lens_a, lens_b)
                 + _concat_aranges(lens_b))
        idx_all = np.repeat(base, totals) + _concat_aranges(totals)

        input_ids = np.zeros((R, L), dtype=np.int32)
        input_ids.flat[idx_a] = flat_a
        input_ids.flat[idx_b] = flat_b
        input_ids.flat[base] = self._cls_id
        input_ids.flat[base + 1 + lens_a] = self._sep_id
        input_ids.flat[base + totals - 1] = self._sep_id

        token_type_ids = np.zeros((R, L), dtype=np.int32)
        # Type 1 spans B and its trailing [SEP], as unpacked.
        idx_b_ext = (np.repeat(base + 2 + lens_a, lens_b + 1)
                     + _concat_aranges(lens_b + 1))
        token_type_ids.flat[idx_b_ext] = 1

        attention_mask = np.zeros((R, L), dtype=np.int32)
        attention_mask.flat[idx_all] = 1
        segments = np.zeros((R, L), dtype=np.int32)
        segments.flat[idx_all] = np.repeat(slot_of + 1, totals)
        position_ids = np.zeros((R, L), dtype=np.int32)
        position_ids.flat[idx_all] = _concat_aranges(totals)

        cls_positions = np.zeros((R, P), dtype=np.int32)
        nsp = np.full((R, P), self._ignore_index, dtype=np.int32)
        cls_positions[row_of, slot_of] = offset_of
        nsp[row_of, slot_of] = np.asarray([int(s[2]) for s in samples],
                                          dtype=np.int32)

        labels = np.full((R, L), self._ignore_index, dtype=np.int32)
        if static:
            flat_pos, _ = self._positions_and_lens(samples)
            flat_labels, lens_m = self._token_ids_and_lens(
                [s[4] for s in samples])
            labels.flat[np.repeat(base, lens_m) + flat_pos] = flat_labels
        else:
            if g is None:
                raise ValueError("dynamic masking needs a worker RNG")
            special = np.ones((R, L), dtype=bool)
            special.flat[idx_a] = False
            special.flat[idx_b] = False
            input_ids, labels = self._mask_tokens(input_ids, special, g)

        batch = self._finish({
            "input_ids": input_ids,
            "token_type_ids": token_type_ids,
            "attention_mask": attention_mask,
            "segments": segments,
            "position_ids": position_ids,
            "cls_positions": cls_positions,
            "next_sentence_labels": nsp,
            "labels": labels,
        })
        stats = {"pad_tokens": int(layout["pad_tokens"]
                                   + (R - layout["n_rows"]) * L),
                 "total_tokens": R * L, "n_samples": n}
        return batch, stats


class BertPrepackedCollate(BertCollate):
    """Collate for offline-packed shards: each input is one PackedRow
    (``decode_record_batch``), already packed, so the encode is a few
    concatenates and flat scatters. Batches are ``len(rows)`` x
    ``pack_seq_length`` in the packed batch contract above."""

    def __init__(self, tokenizer, pack_seq_length, pack_max_per_row,
                 ignore_index=-1, mlm_prob=0.15, emit_loss_mask=False):
        super().__init__(tokenizer, fixed_seq_length=pack_seq_length,
                         ignore_index=ignore_index, mlm_prob=mlm_prob,
                         emit_loss_mask=emit_loss_mask)
        self._max_per_row = pack_max_per_row

    def __call__(self, rows, g=None):
        if not rows or not isinstance(rows[0], PackedRow):
            raise TypeError(
                "BertPrepackedCollate consumes PackedRow samples from "
                "offline-packed shards; got {}".format(
                    type(rows[0]).__name__ if rows else "an empty batch"))
        static = rows[0][4] is not None
        L, P, R = self._fixed_seq_length, self._max_per_row, len(rows)

        ids_rows = [r[0] for r in rows]
        used = np.fromiter(map(len, ids_rows), dtype=np.int64, count=R)
        bases = np.arange(R, dtype=np.int64) * L
        idx_all = np.repeat(bases, used) + _concat_aranges(used)
        tok3 = np.concatenate([r[1] for r in rows], axis=1)
        samp = np.concatenate([r[3] for r in rows], axis=1)

        input_ids = np.zeros((R, L), dtype=np.int32)
        input_ids.flat[idx_all] = np.concatenate(ids_rows)
        # The three per-token planes land in one assignment (the batch's
        # arrays are views of one backing array); packed rows fill a
        # prefix of each row, so the attention mask is a compare.
        out3 = np.zeros((3, R, L), dtype=np.int32)
        out3.reshape(3, R * L)[:, idx_all] = tok3
        segments, position_ids, token_type_ids = out3
        attention_mask = (np.arange(L, dtype=np.int64)[None, :]
                          < used[:, None]).astype(np.int32)

        samples_per_row = np.fromiter(
            (r[3].shape[1] for r in rows), dtype=np.int64, count=R)
        row_of = np.repeat(np.arange(R, dtype=np.int64), samples_per_row)
        slot_of = _concat_aranges(samples_per_row)
        cls_positions = np.zeros((R, P), dtype=np.int32)
        nsp = np.full((R, P), self._ignore_index, dtype=np.int32)
        cls_positions[row_of, slot_of] = samp[2]
        nsp[row_of, slot_of] = samp[3]

        labels = np.full((R, L), self._ignore_index, dtype=np.int32)
        if static:
            mlm2 = np.concatenate([r[4] for r in rows], axis=1)
            mask_counts = np.fromiter(
                (r[4].shape[1] for r in rows), dtype=np.int64, count=R)
            labels.flat[np.repeat(bases, mask_counts) + mlm2[0]] = mlm2[1]
        else:
            if g is None:
                raise ValueError("dynamic masking needs a worker RNG")
            special = np.ones((R, L), dtype=bool)
            special.flat[idx_all] = ~np.concatenate([r[2] for r in rows])
            input_ids, labels = self._mask_tokens(input_ids, special, g)

        return self._finish({
            "input_ids": input_ids,
            "token_type_ids": token_type_ids,
            "attention_mask": attention_mask,
            "segments": segments,
            "position_ids": position_ids,
            "cls_positions": cls_positions,
            "next_sentence_labels": nsp,
            "labels": labels,
        })


class PackedBertLoader:
    """Streams raw samples from an inner DataLoader through a
    StreamPacker and emits packed batches of exactly ``pack_rows`` x
    ``pack_seq_length``. Packing is deterministic (first-fit in stream
    order) and carries leftover samples across batch boundaries, so no
    sample is dropped; the last batch pads with empty rows. Each batch's
    dynamic masking draws from its own stream, keyed by (seed, epoch, dp
    rank, batch index). ``pad_ratio`` is pad over total tokens of the
    epoch so far."""

    _PACK_RNG_TAG = 0xACED  # dynamic-masking stream domain for packed mode

    def __init__(self, inner, collate, pack_seq_length, pack_rows,
                 pack_max_per_row, pack_horizon=None):
        self._inner = inner
        self._collate = collate
        self._L = pack_seq_length
        self._R = pack_rows
        self._P = pack_max_per_row
        self._horizon = pack_horizon
        self.pad_tokens = 0
        self.total_tokens = 0
        self.n_samples = 0

    @property
    def pad_ratio(self):
        return self.pad_tokens / max(self.total_tokens, 1)

    def __iter__(self):
        ds = self._inner.dataset
        inner_it = iter(self._inner)   # advances the epoch
        packer = StreamPacker(self._L, self._R, self._P,
                              horizon=self._horizon)
        store = {}                     # global ordinal -> sample
        self.pad_tokens = self.total_tokens = self.n_samples = 0
        batch_idx = 0

        def encode(rows):
            nonlocal batch_idx
            # Global ordinals -> batch-local 0..n-1, in stream order.
            ordinals = sorted(o for row in rows for o, _ in row)
            local = {o: i for i, o in enumerate(ordinals)}
            rows_local = [[(local[o], length) for o, length in row]
                          for row in rows]
            samples = [store.pop(o) for o in ordinals]
            g = lrng.sample_rng(ds.base_seed, self._PACK_RNG_TAG, ds.epoch,
                                ds.dp_rank, batch_idx)
            batch_idx += 1
            batch, stats = self._collate(rows_local, samples, g=g)
            self.pad_tokens += stats["pad_tokens"]
            self.total_tokens += stats["total_tokens"]
            self.n_samples += stats["n_samples"]
            if obs_on:
                # Packed batches bypass the DataLoader's padding counters:
                # account them from the packer's layout.
                obs.inc("loader_real_tokens_total",
                        stats["total_tokens"] - stats["pad_tokens"])
                obs.inc("loader_padded_slots_total", stats["total_tokens"])
                obs.set_gauge("loader_padding_efficiency",
                              1.0 - self.pad_ratio)
            return batch

        def seg_len(v):
            # v2: an id view; v1: a space-joined token string.
            return len(v) if not isinstance(v, str) else len(v.split())

        obs_on = obs.enabled()
        try:
            for raw_batch in inner_it:
                for sample in raw_batch:
                    length = seg_len(sample[0]) + seg_len(sample[1]) + 3
                    ordinal = packer.add(length)
                    if ordinal is None:
                        yield encode(packer.emit_fullest())
                        ordinal = packer.add(length)
                    store[ordinal] = sample
        finally:
            inner_it.close()   # an abandoned epoch ends its workers now
        while packer.open_rows:
            yield encode(packer.emit_fullest())
        if store:
            raise RuntimeError("{} packed samples were never emitted"
                               .format(len(store)))


class BertPretrainBinned(Binned):

    def _get_batch_size(self, batch):
        # Encoded batches are dicts; return_raw_samples batches are lists.
        if isinstance(batch, dict):
            return len(batch["input_ids"])
        return len(batch)


def get_bert_pretrain_data_loader(
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
    sequence_length_alignment=8,
    fixed_seq_lengths=None,
    ignore_index=-1,
    mlm_prob=0.15,
    emit_loss_mask=False,
    base_seed=12345,
    start_epoch=0,
    log_dir=None,
    log_level=None,
    return_raw_samples=False,
    prefetch=2,
    comm=None,
    pack_seq_length=None,
    pack_rows=None,
    pack_max_per_row=8,
    pack_horizon=None,
    pack_allow_uneven_epochs=False,
    worker_mode="thread",
    on_corrupt=None,
    follow_generations=False,
):
    """The BERT pretraining loader over balanced shards at ``path``.

    Binned vs unbinned comes from the shard filenames, static vs dynamic
    masking and schema v1 vs v2 from the parquet schema.
    ``fixed_seq_lengths`` pads every batch of a bin to that bin's length
    (an int, or one entry per bin). ``dp_rank``/``num_dp_groups`` name
    this process's data-parallel group; all processes of a group receive
    identical batches. ``return_raw_samples`` yields lists of decoded
    samples instead of batches; ``emit_loss_mask`` adds ``loss_mask`` (1
    where a label is set) to every batch.

    The vocabulary: ``tokenizer`` (any object with the ``Vocab``
    interface), else ``vocab_file``, else ``tokenizer_name``, a local
    directory holding ``vocab.txt`` (what ``from_pretrained`` reads from a
    directory; the port downloads nothing).

    ``worker_mode``: ``"thread"`` (default) or ``"process"`` (persistent
    spawned workers; falls back to threads, with a warning, without two
    spare cores unless ``LDDL_TPU_FORCE_PROCESS_WORKERS`` is set).
    ``on_corrupt``: the startup shard-integrity policy, ``"fail"`` or
    ``"quarantine"`` (None defers to ``LDDL_TPU_ON_CORRUPT``, then
    ``"fail"``), checked against the ``.manifest.json`` the producer
    published. ``follow_generations=True``: pick up newly published
    generations of a streaming-ingestion directory at each epoch boundary
    (never mid-epoch). ``log_dir``/``log_level``: the dataset logger's
    files and level (default WARNING). ``comm``: a ``parallel``
    communicator for the census and the startup verification across
    ranks.

    Sequence packing (``pack_seq_length`` + ``pack_rows``, over unbinned
    shards): several samples share each row of exactly
    ``pack_seq_length`` tokens, at most ``pack_max_per_row`` of them,
    first-fit over the sample stream with ``pack_horizon`` rows open
    (default 4 x ``pack_rows``); each batch holds ``pack_rows`` rows and
    gains the keys ``segments``, ``position_ids`` and ``cls_positions``,
    NSP labels become [rows, pack_max_per_row], and the consumer is
    ``models.BertForPreTrainingPacked``. Packed batch counts differ
    between dp groups, so ``num_dp_groups > 1`` needs
    ``pack_allow_uneven_epochs=True``.

    Offline-packed directories (``__meta__.packed`` in the manifest, or
    the row shape in a shard's footer) stream their stored rows: the
    stored row width is authoritative (``pack_seq_length``, if passed,
    must match) and ``pack_rows`` (default ``batch_size``) sets rows per
    batch.

    Shards are read through ``shardcache`` (``LDDL_TPU_LOADER_PREFETCH_
    SHARDS`` read-ahead depth, ``LDDL_TPU_LOADER_CACHE_BYTES`` cache
    budget); batches are the same with it on or off."""
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
    if follow_generations:
        # The startup set obeys the gate a refresh does.
        file_paths, _ = generation_gate_filter(path, file_paths)
    n_before = len(file_paths)
    file_paths = verified_shard_paths(path, file_paths,
                                      on_corrupt=on_corrupt, logger=logger,
                                      comm=comm)
    n_quarantined = n_before - len(file_paths)
    try:
        bin_ids = get_all_bin_ids(file_paths)
    except ValueError as e:
        if n_quarantined:
            raise annotate_quarantine(e, n_quarantined) from e
        raise
    # One snapshot for the whole loader: every bin's follower reads the
    # gate and listing from the same per-epoch cache.
    gen_snapshot = GenerationSnapshot(path) if follow_generations else None

    def make_dataset(paths, bin_id=None):
        try:
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
                comm=comm,
                logger=logger,
                refresh=(GenerationFollower(path, bin_id=bin_id,
                                            on_corrupt=on_corrupt,
                                            snapshot=gen_snapshot)
                         if follow_generations else None))
        except ValueError as e:
            # Divisibility/balance errors after a quarantine name it.
            if n_quarantined:
                raise annotate_quarantine(e, n_quarantined) from e
            raise

    packed_shape = packed_shape_of_dir(path, file_paths)
    if packed_shape is not None:
        L, P = packed_shape
        if pack_seq_length is not None and int(pack_seq_length) != L:
            raise ValueError(
                "shards under {} were packed offline at pack_seq_length="
                "{}, which the stored rows fix; requested {}".format(
                    path, L, pack_seq_length))
        if bin_ids:
            raise ValueError("offline-packed shards cannot be binned")
        if return_raw_samples:
            raise ValueError(
                "return_raw_samples over offline-packed shards is not "
                "supported (rows are packed training rows, not samples)")
        if fixed_seq_lengths is not None:
            raise ValueError(
                "offline-packed shards fix the row width at {}; "
                "fixed_seq_lengths does not apply".format(L))
        rows = int(pack_rows) if pack_rows is not None else int(batch_size)
        return DataLoader(
            make_dataset(file_paths), rows,
            collate_fn=BertPrepackedCollate(
                tokenizer, L, P, ignore_index=ignore_index,
                mlm_prob=mlm_prob, emit_loss_mask=emit_loss_mask),
            prefetch=prefetch, worker_mode=worker_mode)

    packing = pack_seq_length is not None or pack_rows is not None
    if packing:
        if pack_seq_length is None or pack_rows is None:
            raise ValueError("packing needs BOTH pack_seq_length and "
                             "pack_rows")
        if num_dp_groups > 1 and not pack_allow_uneven_epochs:
            raise ValueError(
                "sequence packing with num_dp_groups > 1 yields uneven "
                "per-group batch counts; pass "
                "pack_allow_uneven_epochs=True and bound your step loop "
                "(e.g. islice to the min batch count across groups)")
        if bin_ids:
            raise ValueError(
                "packing requires unbinned shards (rows are always exactly "
                "pack_seq_length wide, which subsumes binning); preprocess "
                "without --bin-size")
        if return_raw_samples:
            raise ValueError("return_raw_samples and packing are exclusive")

    def make_collate(fixed_seq_length):
        if return_raw_samples:
            return None
        return BertCollate(
            tokenizer,
            sequence_length_alignment=sequence_length_alignment,
            fixed_seq_length=fixed_seq_length,
            ignore_index=ignore_index,
            mlm_prob=mlm_prob,
            emit_loss_mask=emit_loss_mask,
        )

    if bin_ids:
        if fixed_seq_lengths is None:
            fixed_seq_lengths = [None] * len(bin_ids)
        elif len(fixed_seq_lengths) != len(bin_ids):
            raise ValueError(
                "fixed_seq_lengths has {} entries for {} bins".format(
                    len(fixed_seq_lengths), len(bin_ids)))
        loaders = [
            DataLoader(make_dataset(get_file_paths_for_bin_id(file_paths, b),
                                    bin_id=b),
                       batch_size,
                       collate_fn=make_collate(fixed_seq_lengths[b]),
                       prefetch=prefetch, worker_mode=worker_mode)
            for b in bin_ids
        ]
        return BertPretrainBinned(loaders, base_seed=base_seed,
                                  start_epoch=start_epoch, logger=logger)
    if packing:
        inner = DataLoader(make_dataset(file_paths), batch_size,
                           collate_fn=None, prefetch=prefetch,
                           worker_mode=worker_mode)
        return PackedBertLoader(
            inner,
            BertPackedCollate(tokenizer, pack_seq_length, pack_rows,
                              pack_max_per_row, ignore_index=ignore_index,
                              mlm_prob=mlm_prob,
                              emit_loss_mask=emit_loss_mask),
            pack_seq_length, pack_rows, pack_max_per_row,
            pack_horizon=pack_horizon)
    fixed = fixed_seq_lengths
    if isinstance(fixed, (list, tuple)):
        if len(fixed) != 1:
            raise ValueError("unbinned data takes a single fixed_seq_length")
        fixed = fixed[0]
    return DataLoader(make_dataset(file_paths), batch_size,
                      collate_fn=make_collate(fixed), prefetch=prefetch,
                      worker_mode=worker_mode)
