"""Sequence-length binning math + binned parquet sink.

The port's own copy of ``lddl_tpu/preprocess/binning.py``: group a
bucket's rows by bin id and write one table per bin named
``part.N.parquet_<bin_id>``; the offline-packed sink is
``preprocess.packing.write_packed_shard``.

Bin math (must match the loader and balancer):
    nbins  = target_seq_length // bin_size
    bin_id = min((num_tokens - 1) // bin_size, nbins - 1)
so bin k holds sequences of length (k*bin_size, (k+1)*bin_size], and the
last bin also absorbs any longer stragglers. The loader pads bin k to
(k+1)*bin_size, so a step sees at most nbins shapes.
"""

import os

import numpy as np
import pyarrow as pa

from ..utils.io import write_table_atomic

BASE_SCHEMA = {
    "A": pa.string(),
    "B": pa.string(),
    "is_random_next": pa.bool_(),
    "num_tokens": pa.uint16(),
}
MASKING_SCHEMA = {
    "masked_lm_positions": pa.binary(),
    "masked_lm_labels": pa.string(),
}
# Schema v2: token-id columnar twins of the text columns, ALONGSIDE them
# (a v2 shard is a strict superset of a v1 shard, so v1 readers keep
# working). The loader consumes these zero-copy instead of re-tokenizing
# the strings every epoch.
TOKEN_ID_SCHEMA = {
    "A_ids": pa.list_(pa.int32()),
    "B_ids": pa.list_(pa.int32()),
}
MASKING_TOKEN_ID_SCHEMA = {
    "masked_lm_positions_ids": pa.list_(pa.int32()),
    "masked_lm_label_ids": pa.list_(pa.int32()),
}
# Column names whose presence marks a schema-v2 shard (BERT / BART /
# offline-packed — packed shards are inherently id-columnar).
SCHEMA_V2_MARKERS = ("A_ids", "sentence_ids", "pack_a_lens")

# Column whose presence marks an offline-packed shard
# (preprocess/packing.py; its ``packed_schema`` is the packed schema).
PACKED_MARKER = "pack_a_lens"


def schema_version_of_names(names):
    """1 or 2 from a parquet schema's column names (per-shard detection:
    the loader and the manifest's ``__meta__`` entry both use this)."""
    names = set(names)
    return 2 if any(m in names for m in SCHEMA_V2_MARKERS) else 1


def write_options_for_names(names):
    """The pq.write_table layout options for a shard with these column
    names: the tuned v2 layout for id-columnar schemas, the legacy
    (byte-pinned) layout for v1. One rule so the sink and the balancer's
    row-wise rewrites cannot drift."""
    return (dict(V2_PARQUET_WRITE_OPTIONS)
            if schema_version_of_names(names) == 2 else {})


def num_bins(target_seq_length, bin_size):
    if bin_size is None:
        return 1
    if bin_size <= 0 or target_seq_length % bin_size != 0:
        raise ValueError(
            "bin_size must divide target_seq_length ({} % {} != 0)".format(
                target_seq_length, bin_size))
    return target_seq_length // bin_size


def bin_id_of_num_tokens(num_tokens, bin_size, nbins):
    """Scalar or ndarray; the ONE definition of the bin formula (loader,
    balancer, and both sink paths must agree)."""
    return np.minimum(np.maximum(num_tokens - 1, 0) // bin_size, nbins - 1)


def make_schema(masking=False, binned=False, token_ids=False):
    fields = dict(BASE_SCHEMA)
    if masking:
        fields.update(MASKING_SCHEMA)
    if token_ids:
        fields.update(TOKEN_ID_SCHEMA)
        if masking:
            fields.update(MASKING_TOKEN_ID_SCHEMA)
    if binned:
        fields["bin_id"] = pa.int64()
    return pa.schema(list(fields.items()))


# The shard codec and, for the id-columnar schemas (v2 and packed), the
# page layout: the reference's choices, kept so the port writes its
# bytes. v1 shards keep pyarrow's default layout. Both feed the resume
# fingerprints.
DEFAULT_PARQUET_COMPRESSION = "lz4"

V2_PARQUET_WRITE_OPTIONS = {
    "use_dictionary": False,
    "write_statistics": False,
    "data_page_version": "2.0",
}
SINK_PROFILE_V2 = "lz4.dpv2.nodict.nostats"


def write_shard_columns(columns, n, out_dir, part_id, masking=False,
                        bin_size=None, target_seq_length=128,
                        compression=DEFAULT_PARQUET_COMPRESSION,
                        pack_seq_length=None, pack_max_per_row=8,
                        pack_special_ids=None):
    """Write one block's COLUMNS ({name: list-or-ndarray}) as
    part.<part_id>.parquet[_<bin>] files — the columnar fast path (no
    per-row dicts anywhere between sample construction and arrow).

    Returns {written_path: num_rows}. With binning enabled, only non-empty
    bins produce a file (ref: binning.py:353-431); the balancer later
    equalizes the global per-bin file sets. With ``pack_seq_length`` set
    (mutually exclusive with binning — packing subsumes it), the sink
    first-fit-decreasing-packs the bucket into fixed-budget rows and the
    row count IS the packed row count (preprocess/packing.py).
    """
    if pack_seq_length is not None:
        if bin_size is not None:
            raise ValueError("pack_seq_length and bin_size are exclusive "
                             "(packing subsumes binning)")
        if pack_special_ids is None:
            raise ValueError("the packed sink needs pack_special_ids="
                             "(cls_id, sep_id) to interleave row content")
        from .packing import write_packed_shard
        return write_packed_shard(columns, n, out_dir, part_id,
                                  pack_seq_length, pack_max_per_row,
                                  pack_special_ids[0], pack_special_ids[1],
                                  masking=masking, compression=compression)
    os.makedirs(out_dir, exist_ok=True)
    written = {}
    token_ids = "A_ids" in columns  # schema v2 sniffed off the columns
    write_options = write_options_for_names(columns)
    if bin_size is None:
        schema = make_schema(masking=masking, binned=False,
                             token_ids=token_ids)
        path = os.path.join(out_dir, "part.{}.parquet".format(part_id))
        write_table_atomic(
            pa.table({name: columns.get(name, []) for name in schema.names},
                     schema=schema),
            path, compression=compression, **write_options)
        written[path] = n
        return written

    if n == 0:  # binned: empty buckets produce no files (like the old
        return written  # row path and ref binning.py:353-431)

    nbins = num_bins(target_seq_length, bin_size)
    schema = make_schema(masking=masking, binned=True, token_ids=token_ids)
    num_tokens = np.asarray(columns["num_tokens"], dtype=np.int64)
    bins = bin_id_of_num_tokens(num_tokens, bin_size, nbins)
    # ONE stable sort by bin + zero-copy slices per bin, instead of one
    # gather per (bin, column): row order within a bin is identical
    # (stable sort of equal keys == nonzero order), so shard bytes are
    # unchanged while Arrow takes drop from bins x columns to columns.
    order = np.argsort(bins, kind="stable")
    bins_sorted = bins[order]
    sorted_cols = {}
    for name in schema.names:
        if name == "bin_id":
            continue
        col = columns[name]
        if isinstance(col, pa.Array):
            sorted_cols[name] = col.take(order)
        elif isinstance(col, np.ndarray):
            sorted_cols[name] = col[order]
        else:
            # numpy integer indices subscript plain lists directly —
            # no need to materialize the order as a Python list first.
            sorted_cols[name] = [col[i] for i in order]
    boundaries = np.searchsorted(bins_sorted, np.arange(nbins + 1))
    for b in np.unique(bins):
        lo, hi = int(boundaries[b]), int(boundaries[b + 1])
        sub = {}
        for name in schema.names:
            if name == "bin_id":
                sub[name] = np.full(hi - lo, b, dtype=np.int64)
                continue
            col = sorted_cols[name]
            if isinstance(col, pa.Array):
                sub[name] = col.slice(lo, hi - lo)  # zero-copy
            else:
                sub[name] = col[lo:hi]
        path = os.path.join(out_dir,
                            "part.{}.parquet_{}".format(part_id, int(b)))
        # Atomic publish (tmp + fsync + replace): a SIGKILLed worker can
        # never leave a torn shard under its final name for the resume's
        # exact-prefix cleanup to miss.
        write_table_atomic(pa.table(sub, schema=schema), path,
                           compression=compression, **write_options)
        written[path] = hi - lo
    return written

