"""Vectorized Arrow ``list<int32>`` columns from flat numpy buffers.

The port's own copy of ``concat_aranges``, ``int32_list_array`` and
``gather_list_slices`` from ``lddl_tpu/preprocess/arrowcols.py``: no
per-row Python object is created on the way to a parquet column.
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
