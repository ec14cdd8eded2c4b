"""Offline sequence packing: first-fit-decreasing packed rows.

The port's own copy of the pure part of
``lddl_tpu/preprocess/packing.py``: ``ffd_pack``, ``pack_columns``,
``pack_meta_of``, ``pack_shape_of_schema``, ``pack_shape_of_parquet``
(local files) and the ``PACK_META_*`` keys, plus ``packed_schema``
(``binning.make_packed_schema`` there) and ``write_packed_shard``, the
offline-packed shard sink with the reference's fill telemetry.

A packed row is one training row, stored as (all ``list<int32>`` but
``num_tokens``):

    input_ids                  the row's interleaved content,
                               [CLS] A [SEP] B [SEP] per sample
    pack_a_lens / pack_b_lens  per-sample boundaries
    pack_nsp                   per-sample is_random_next
    num_tokens                 uint16, used tokens in the row
    masked_lm_positions_ids    (static masking) ROW-relative positions
    masked_lm_label_ids        and label ids
    pack_mask_lens             per-sample masking counts

The row shape ``(pack_seq_length, pack_max_per_row)`` is stamped into the
parquet schema metadata. FFD is pure sorting and first-fit (no RNG, no
clock), so packed bytes are a function of the input columns.
"""

import os

import numpy as np

from .. import observability as obs
from .arrowcols import concat_aranges, gather_list_slices, int32_list_array

# Parquet schema-metadata keys stamping the packed row shape into every
# packed shard (read back by pack_shape_of_schema).
PACK_META_SEQ_LENGTH = b"lddl_pack_seq_length"
PACK_META_MAX_PER_ROW = b"lddl_pack_max_per_row"


def ffd_pack(lengths, budget, max_per_row):
    """First-fit-decreasing packing of ``lengths`` into rows of capacity
    ``budget`` holding at most ``max_per_row`` samples.

    Samples are visited in (length desc, original index) order and each
    drops into the FIRST open row with room (rows in creation order).
    Returns ``(sample_order, samples_per_row)``: every row's sample
    indices in placement order, concatenated, and each row's count."""
    lengths = np.asarray(lengths, dtype=np.int64)
    n = len(lengths)
    if n == 0:
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64)
    if int(lengths.max()) > budget:
        raise ValueError(
            "sample of {} tokens exceeds pack budget {}".format(
                int(lengths.max()), budget))
    if max_per_row < 1:
        raise ValueError("max_per_row must be >= 1")
    order = np.lexsort((np.arange(n), -lengths))
    free = np.empty(n, dtype=np.int64)      # capacity left per open row
    counts = np.empty(n, dtype=np.int64)    # samples per open row
    rows = []
    nrows = 0
    for idx in order:
        length = int(lengths[idx])
        fit = np.flatnonzero((free[:nrows] >= length)
                             & (counts[:nrows] < max_per_row))
        if len(fit):
            r = int(fit[0])
            rows[r].append(int(idx))
            free[r] -= length
            counts[r] += 1
        else:
            rows.append([int(idx)])
            free[nrows] = budget - length
            counts[nrows] = 1
            nrows += 1
    sample_order = np.concatenate(
        [np.asarray(row, dtype=np.int64) for row in rows])
    return sample_order, counts[:nrows].copy()


def _column_views(col):
    """(flat_values, per_row_lens) of a ``list<int32>`` column."""
    lens = col.value_lengths().to_numpy(zero_copy_only=False).astype(
        np.int64)
    values = col.flatten().to_numpy(zero_copy_only=True)
    return values, lens


def pack_columns(columns, n, pack_seq_length, max_per_row, cls_id, sep_id,
                 masking=False):
    """Per-sample schema-v2 columns (``A_ids``, ``B_ids``,
    ``is_random_next``, ``num_tokens``[, ``masked_lm_positions_ids``,
    ``masked_lm_label_ids``]) -> packed-row columns. Returns
    ``(packed_columns, n_rows, stats)``, ``stats`` the placed tokens,
    budget slots, samples and rows."""
    if "A_ids" not in columns:
        raise ValueError(
            "offline packing requires the schema-v2 token-id columns "
            "(A_ids/B_ids)")
    num_tokens = np.asarray(columns["num_tokens"], dtype=np.int64)
    sample_order, samples_per_row = ffd_pack(num_tokens, pack_seq_length,
                                             max_per_row)
    n_rows = len(samples_per_row)
    row_starts = np.cumsum(samples_per_row) - samples_per_row

    def gathered(col):
        values, lens = _column_views(col)
        return gather_list_slices(values, lens, sample_order)

    flat_a, a_sel = gathered(columns["A_ids"])
    flat_b, b_sel = gathered(columns["B_ids"])
    tot_sel = a_sel + b_sel + 3
    if not np.array_equal(tot_sel, num_tokens[sample_order]):
        raise ValueError("num_tokens disagrees with the A/B id lengths")
    # Rows tile their samples contiguously, so the concatenated row
    # contents are the samples laid out at their global offsets.
    global_off = np.cumsum(tot_sel) - tot_sel
    content = np.empty(int(tot_sel.sum()), dtype=np.int32)
    content[global_off] = cls_id
    content[global_off + 1 + a_sel] = sep_id
    content[global_off + tot_sel - 1] = sep_id
    content[np.repeat(global_off + 1, a_sel)
            + concat_aranges(a_sel)] = flat_a
    content[np.repeat(global_off + 2 + a_sel, b_sel)
            + concat_aranges(b_sel)] = flat_b

    rn = np.asarray(columns["is_random_next"]).astype(np.int32)
    row_tokens = (np.add.reduceat(tot_sel, row_starts) if n_rows
                  else np.zeros(0, dtype=np.int64))
    packed = {
        "input_ids": int32_list_array(content, row_tokens),
        "pack_a_lens": int32_list_array(a_sel, samples_per_row),
        "pack_b_lens": int32_list_array(b_sel, samples_per_row),
        "pack_nsp": int32_list_array(rn[sample_order], samples_per_row),
        "num_tokens": row_tokens.astype(np.uint16),
    }
    if masking:
        flat_pos, m_sel = gathered(columns["masked_lm_positions_ids"])
        flat_lab, _ = gathered(columns["masked_lm_label_ids"])
        # Row-relative positions: the sample's offset inside its row is
        # its global offset minus the row's global base.
        row_base = np.cumsum(row_tokens) - row_tokens
        off_in_row = global_off - np.repeat(row_base, samples_per_row)
        pos_rowrel = flat_pos + np.repeat(off_in_row, m_sel)
        # Per-row masked counts via cumsum differences (np.add.reduceat
        # mishandles empty segments).
        cum_m = np.zeros(len(m_sel) + 1, dtype=np.int64)
        np.cumsum(m_sel, out=cum_m[1:])
        bounds = np.append(row_starts, len(m_sel))
        row_mask = cum_m[bounds[1:]] - cum_m[bounds[:-1]]
        packed["masked_lm_positions_ids"] = int32_list_array(pos_rowrel,
                                                             row_mask)
        packed["masked_lm_label_ids"] = int32_list_array(flat_lab, row_mask)
        packed["pack_mask_lens"] = int32_list_array(m_sel, samples_per_row)
    stats = {
        "tokens": int(tot_sel.sum()),
        "slots": int(n_rows) * int(pack_seq_length),
        "samples": int(n),
        "rows": int(n_rows),
    }
    return packed, n_rows, stats


def packed_schema(masking, pack_seq_length, max_per_row):
    """The Arrow schema of an offline-packed shard, the row shape
    (``pack_seq_length``, ``max_per_row``) stamped into its metadata."""
    import pyarrow as pa
    ids = pa.list_(pa.int32())
    fields = [("input_ids", ids), ("pack_a_lens", ids),
              ("pack_b_lens", ids), ("pack_nsp", ids),
              ("num_tokens", pa.uint16())]
    if masking:
        fields += [("masked_lm_positions_ids", ids),
                   ("masked_lm_label_ids", ids), ("pack_mask_lens", ids)]
    return pa.schema(fields, metadata={
        PACK_META_SEQ_LENGTH: str(int(pack_seq_length)).encode(),
        PACK_META_MAX_PER_ROW: str(int(max_per_row)).encode(),
    })


def pack_meta_of(pack_seq_length, max_per_row):
    """The manifest ``__meta__`` fragment recording the packed row
    shape."""
    return {"pack_seq_length": int(pack_seq_length),
            "pack_max_per_row": int(max_per_row)}


def pack_shape_of_schema(schema):
    """(pack_seq_length, pack_max_per_row) off a parquet/arrow schema's
    metadata, or None for unpacked shards."""
    md = schema.metadata or {}
    if PACK_META_SEQ_LENGTH not in md:
        return None
    try:
        return (int(md[PACK_META_SEQ_LENGTH]),
                int(md.get(PACK_META_MAX_PER_ROW, b"8")))
    except (TypeError, ValueError):
        return None


def pack_shape_of_parquet(path):
    """Packed row shape off one shard's footer, or None (an unreadable
    footer is not the sniffer's to report). On a non-local storage
    backend the footer arrives by ranged reads (``utils.fs``), so the
    sniff never fetches a whole object."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    from ..resilience.io import backend_if_nonlocal
    try:
        if backend_if_nonlocal() is not None:
            from ..utils.fs import read_footer_metadata
            return pack_shape_of_schema(read_footer_metadata(path).schema
                                        .to_arrow_schema())
        return pack_shape_of_schema(pq.read_schema(path))
    except (OSError, RuntimeError, pa.ArrowInvalid):
        return None


def _record_fill(stats):
    """Cumulative pack-fill telemetry: the gauge is placed tokens over
    budget slots across every bucket this process packed so far (the
    fleet aggregator recomputes the cluster-wide ratio from the two
    counters, so per-host and fleet numbers agree by construction)."""
    if not obs.enabled():
        return
    obs.inc("preprocess_pack_tokens_total", stats["tokens"])
    obs.inc("preprocess_pack_slot_tokens_total", stats["slots"])
    obs.inc("preprocess_pack_rows_total", stats["rows"])
    reg = obs.registry()
    slots = reg.counter("preprocess_pack_slot_tokens_total").total()
    if slots:
        obs.set_gauge(
            "preprocess_pack_fill_ratio",
            reg.counter("preprocess_pack_tokens_total").total() / slots)


def write_packed_shard(columns, n, out_dir, part_id, pack_seq_length,
                       max_per_row, cls_id, sep_id, masking=False,
                       compression=None):
    """Pack one bucket's columns and publish ``part.<id>.parquet`` whose
    rows are budget-sized packed sequences (schema metadata stamps the
    row shape). Empty buckets produce no file, like the binned sink.
    Returns {written_path: packed_row_count}."""
    import pyarrow as pa

    from ..utils.io import write_table_atomic
    from . import binning as binning_mod
    if compression is None:
        compression = binning_mod.DEFAULT_PARQUET_COMPRESSION
    if n == 0:
        return {}
    packed, n_rows, stats = pack_columns(
        columns, n, pack_seq_length, max_per_row, cls_id, sep_id,
        masking=masking)
    schema = packed_schema(masking, pack_seq_length, max_per_row)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "part.{}.parquet".format(part_id))
    write_table_atomic(
        pa.table({name: packed[name] for name in schema.names},
                 schema=schema),
        path, compression=compression,
        **binning_mod.write_options_for_names(schema.names))
    _record_fill(stats)
    return {path: n_rows}


__all__ = [
    "PACK_META_MAX_PER_ROW",
    "PACK_META_SEQ_LENGTH",
    "ffd_pack",
    "pack_columns",
    "pack_meta_of",
    "pack_shape_of_parquet",
    "pack_shape_of_schema",
    "packed_schema",
    "write_packed_shard",
]
