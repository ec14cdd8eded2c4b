"""Vectorized Arrow columns from flat numpy buffers.

The port's own copy of ``lddl_tpu/preprocess/arrowcols.py``
(``concat_aranges``, ``joined_token_strings``, ``int32_list_array``,
``gather_list_slices``, ``serialized_u16_binary``): no per-row Python
object is created on the way to a parquet column. The joined token
strings come from the native engine's memcpy join only (the reference's
numpy byte-gather fallback is not ported).
"""

import numpy as np


def concat_aranges(lens):
    """[arange(l) for l in lens] concatenated, without a Python loop."""
    lens = np.asarray(lens, dtype=np.int64)
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    starts = np.cumsum(lens) - lens
    return np.arange(total, dtype=np.int64) - np.repeat(starts, lens)


def _offsets32(row_bytes):
    offsets = np.zeros(len(row_bytes) + 1, dtype=np.int64)
    np.cumsum(row_bytes, out=offsets[1:])
    if offsets[-1] >= 1 << 31:
        raise ValueError(
            "column exceeds 2GiB in one bucket; raise --num-blocks so "
            "buckets shrink")
    return offsets.astype(np.int32)


def joined_token_strings(flat_ids, row_lens, table):
    """StringArray: row i = space-joined tokens of its slice of
    ``flat_ids`` (row-major, ``row_lens[i]`` ids per row), filled by the
    native memcpy join. ``table`` is TokenizerInfo.token_byte_table()."""
    import pyarrow as pa

    from .. import native
    flat_ids = np.asarray(flat_ids, dtype=np.int64)
    row_lens = np.asarray(row_lens, dtype=np.int64)
    tl = table.lens[flat_ids]
    n_nonempty = int(np.count_nonzero(row_lens))
    total = int(tl.sum()) + len(flat_ids) - n_nonempty
    if total >= 1 << 31:
        raise ValueError(
            "column exceeds 2GiB in one bucket; raise --num-blocks so "
            "buckets shrink")
    data, offsets = native.join_tokens(flat_ids, row_lens, table.blob,
                                       table.starts, table.lens, total)
    return pa.Array.from_buffers(
        pa.utf8(), len(row_lens),
        [None, pa.py_buffer(offsets), pa.py_buffer(data)])


def int32_list_array(flat_vals, row_lens):
    """``list<int32>`` ListArray: row i = its slice of ``flat_vals``
    (row-major, ``row_lens[i]`` values per row)."""
    import pyarrow as pa
    row_lens = np.asarray(row_lens, dtype=np.int64)
    n = len(row_lens)
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(row_lens, out=offsets[1:])
    if offsets[-1] >= 1 << 31:
        raise ValueError("column exceeds 2^31 values in one table")
    offsets = offsets.astype(np.int32)
    values = np.ascontiguousarray(np.asarray(flat_vals, dtype=np.int32))
    child = pa.Array.from_buffers(pa.int32(), len(values),
                                  [None, pa.py_buffer(values)])
    return pa.Array.from_buffers(pa.list_(pa.int32()), n,
                                 [None, pa.py_buffer(offsets)],
                                 children=[child])


def gather_list_slices(values, lens, order):
    """Re-gather a flat-values + per-row-lens list column into the row
    ``order``: returns ``(values_in_order, lens_in_order)``, row
    ``order[i]``'s slice landing contiguously at position ``i``."""
    values = np.asarray(values)
    lens = np.asarray(lens, dtype=np.int64)
    order = np.asarray(order, dtype=np.int64)
    starts = np.cumsum(lens) - lens
    sel = lens[order]
    src = np.repeat(starts[order], sel) + concat_aranges(sel)
    return values[src], sel


_U16_HEADER = np.frombuffer(b"R<u2", dtype=np.uint8)


def serialized_u16_binary(flat_vals, row_lens):
    """BinaryArray: row i = the serialize_np_array fast format (4-byte
    ``R<u2`` tag + raw little-endian uint16 payload, utils/fs.py) of its
    slice of ``flat_vals``."""
    import pyarrow as pa
    row_lens = np.asarray(row_lens, dtype=np.int64)
    n = len(row_lens)
    payload = np.ascontiguousarray(
        np.asarray(flat_vals).astype("<u2")).view(np.uint8)
    row_bytes = 4 + 2 * row_lens
    offsets = _offsets32(row_bytes)
    out = np.empty(int(offsets[-1]), dtype=np.uint8)
    head_pos = (offsets[:-1].astype(np.int64)[:, None]
                + np.arange(4)[None, :]).reshape(-1)
    out[head_pos] = np.tile(_U16_HEADER, n)
    pl = 2 * row_lens
    dest = np.repeat(offsets[:-1].astype(np.int64) + 4, pl) + concat_aranges(pl)
    out[dest] = payload
    return pa.Array.from_buffers(
        pa.binary(), n, [None, pa.py_buffer(offsets), pa.py_buffer(out)])
