"""Filesystem, shard-naming and sample-count helpers.

Counterpart of ``lddl_tpu/utils/fs.py`` (local files only). The bin-id
filename protocol: a shard of sequence-length bin ``k`` carries the
extension ``.parquet_<k>``, and bin ids are contiguous from 0. The
balancer writes ``.num_samples.json`` ({basename: count}) beside the
shards so loader startup need not read every parquet footer.
"""

import io
import json
import os

import numpy as np

from .io import atomic_write

# Cache of per-shard sample counts written by the balancer.
NUM_SAMPLES_CACHE_NAME = ".num_samples.json"
# Reserved cache key holding {basename: byte_length} (growing directories).
NUM_SAMPLES_SIZES_KEY = "__sizes__"


def mkdir(d):
    os.makedirs(d, exist_ok=True)


def expand_outdir_and_mkdir(outdir):
    outdir = os.path.abspath(os.path.expanduser(outdir))
    mkdir(outdir)
    return outdir


def get_all_files_paths_under(root):
    """All file paths under ``root``, sorted; hidden directories skipped."""
    out = []
    # Walk order is unobservable: the list is sorted before it is returned.
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if not d.startswith(".")]
        out.extend(os.path.join(dirpath, f) for f in filenames)
    return sorted(out)


def _is_parquet_path(path):
    name = os.path.basename(path)
    if name.startswith("."):
        return False
    ext = name.split(".")[-1]
    return ext == "parquet" or ext.startswith("parquet_")


def get_all_parquets_under(path):
    """All parquet shards (binned or not) under ``path``."""
    return [p for p in get_all_files_paths_under(path) if _is_parquet_path(p)]


def get_bin_id_of_path(path):
    """Bin id encoded in the file extension, or None for unbinned shards."""
    ext = os.path.basename(path).split(".")[-1]
    if ext.startswith("parquet_"):
        suffix = ext[len("parquet_"):]
        if suffix.isdigit():
            return int(suffix)
    return None


def get_all_bin_ids(file_paths):
    """The sorted bin ids present; raises unless contiguous from 0."""
    bin_ids = sorted({b for b in map(get_bin_id_of_path, file_paths)
                      if b is not None})
    if bin_ids != list(range(len(bin_ids))):
        raise ValueError(
            "bin ids must be contiguous from 0; found {}".format(bin_ids))
    return bin_ids


def get_file_paths_for_bin_id(file_paths, bin_id):
    return [p for p in file_paths if get_bin_id_of_path(p) == bin_id]


def get_num_samples_of_parquet(path):
    """Rows in a parquet shard, from its footer (no data read)."""
    import pyarrow.parquet as pq
    try:
        return pq.ParquetFile(path).metadata.num_rows
    except OSError:
        raise
    except Exception as e:
        raise ValueError("corrupt or truncated parquet shard {}: {}: {}"
                         .format(path, type(e).__name__, e)) from e


def read_num_samples_cache(dir_path):
    """The directory's ``.num_samples.json`` as a dict, or None when it is
    absent or unreadable (the caller then counts from footers)."""
    cache_path = os.path.join(dir_path, NUM_SAMPLES_CACHE_NAME)
    if not os.path.isfile(cache_path):
        return None
    try:
        with open(cache_path, "r") as f:
            cache = json.load(f)
    except (OSError, ValueError):
        return None
    return cache if isinstance(cache, dict) else None


def trusted_num_samples_entries(dir_path, cache):
    """Split one directory's cache into (trusted {basename: count},
    untrusted basenames on disk). A cache without ``__sizes__`` is trusted
    only as a whole, when its key set equals the shards on disk; a sized
    cache is trusted per entry whose byte length matches the file."""
    try:
        names = sorted(os.listdir(dir_path))
    except OSError:
        return {}, set()
    on_disk = [n for n in names if _is_parquet_path(n)]
    if cache is None:
        return {}, set(on_disk)
    sizes = cache.get(NUM_SAMPLES_SIZES_KEY)
    if not isinstance(sizes, dict):
        keys = {k for k in cache if k != NUM_SAMPLES_SIZES_KEY}
        if keys != set(on_disk):
            return {}, set(on_disk)
        return dict(cache), set()
    trusted, untrusted = {}, set()
    for name in on_disk:
        try:
            ok = (name in cache and name in sizes and os.path.getsize(
                os.path.join(dir_path, name)) == sizes[name])
        except OSError:
            ok = False
        if ok:
            trusted[name] = cache[name]
        else:
            untrusted.add(name)
    return trusted, untrusted


def write_num_samples_cache(dir_path, counts):
    """Store {basename: count} next to the shards, durably and atomically
    (``utils.io.atomic_write``)."""
    atomic_write(os.path.join(dir_path, NUM_SAMPLES_CACHE_NAME),
                 json.dumps(dict(counts), sort_keys=True))


def serialize_np_array(a):
    """numpy 1-D array -> bytes for a parquet column: a 4-byte tag
    (``R`` + the dtype code, e.g. ``R<u2``) and the raw little-endian
    payload; other shapes and dtypes use the ``.npy`` container."""
    a = np.ascontiguousarray(a)
    code = a.dtype.str.encode()
    if len(code) != 3 or a.ndim != 1:
        buf = io.BytesIO()
        np.save(buf, a, allow_pickle=False)
        return buf.getvalue()
    return b"R" + code + a.tobytes()


def deserialize_np_array(b):
    """Inverse of ``serialize_np_array``; raises ``ValueError`` on a
    truncated or corrupt payload."""
    if b[:1] == b"R":
        if len(b) < 4:
            raise ValueError(
                "truncated array payload: {} byte(s) with 'R' tag, need at "
                "least 4 (1-byte tag + 3-byte dtype code)".format(len(b)))
        try:
            dtype = np.dtype(b[1:4].decode())
        except (TypeError, UnicodeDecodeError) as e:
            raise ValueError(
                "corrupt array payload: 'R' tag with invalid dtype code "
                "{!r} ({} bytes total)".format(bytes(b[1:4]), len(b))) from e
        if (len(b) - 4) % dtype.itemsize:
            raise ValueError(
                "truncated array payload: {} data byte(s) after the "
                "'R{}' tag is not a multiple of itemsize {}".format(
                    len(b) - 4, dtype.str, dtype.itemsize))
        return np.frombuffer(b, dtype=dtype, offset=4)
    if not bytes(b[:6]) == b"\x93NUMPY":
        raise ValueError(
            "array payload of {} byte(s) has neither the 'R' raw tag nor "
            "the .npy magic; the shard bytes are likely truncated or "
            "corrupt".format(len(b)))
    return np.load(io.BytesIO(b), allow_pickle=False)
