"""Filesystem, shard-naming and sample-count helpers.

Counterpart of ``lddl_tpu/utils/fs.py``. The bin-id filename protocol: a
shard of sequence-length bin ``k`` carries the extension
``.parquet_<k>``, and bin ids are contiguous from 0. The balancer writes
``.num_samples.json`` ({basename: count}) beside the shards so loader
startup need not read every parquet footer; the census that fills it
(``get_num_samples_of_parquet``) reads footers through the resilient I/O
layer: retries, the ``open``/``read`` fault sites, and footer-only
ranged reads on a non-local storage backend.
"""

import io
import json
import os
import re

import numpy as np

from ..resilience import faults
from ..resilience.io import atomic_write, with_retries

# Cache of per-shard sample counts written by the balancer.
NUM_SAMPLES_CACHE_NAME = ".num_samples.json"
# Reserved cache key holding {basename: byte_length} (growing directories).
NUM_SAMPLES_SIZES_KEY = "__sizes__"
# A streaming-ingestion generation's shard directory under the dataset
# root; generation 0 is the root itself.
GENERATION_DIR_RE = re.compile(r"^gen-(\d{4,})$")


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


def generation_dir_name(generation):
    """Directory name of one ingest generation's shards under the dataset
    root. Generation 0 is the root itself, so only generations >= 1 get
    a subdirectory."""
    if generation < 1:
        raise ValueError(
            "generation 0 lives in the dataset root, not a subdirectory")
    return "gen-{:04d}".format(generation)


def get_generation_of_path(root, path):
    """The ingest generation a shard belongs to: N under
    ``<root>/gen-<NNNN>/``, 0 directly in the root."""
    rel = os.path.relpath(os.path.abspath(path), os.path.abspath(root))
    m = GENERATION_DIR_RE.match(rel.split(os.sep, 1)[0])
    return int(m.group(1)) if m else 0


def read_footer_metadata(path):
    """Parquet ``FileMetaData`` by footer-first ranged reads through the
    active storage backend: an 8-byte tail probe (footer length + magic),
    then the footer itself, so a metadata consumer (the census, the
    packed-shape sniff) never fetches a whole object. Retries happen
    inside ``read_range``; an implausible footer raises RuntimeError."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from ..resilience.io import object_head, read_range
    size, _ = object_head(path)
    if size is None:
        raise FileNotFoundError(path)
    if size < 12:
        raise RuntimeError(
            "parquet shard implausibly small ({} byte(s))".format(size))
    tail = read_range(path, size - 8, 8)
    if len(tail) != 8 or tail[4:8] != b"PAR1":
        raise RuntimeError("bad parquet footer magic")
    footer_len = int.from_bytes(tail[:4], "little")
    if footer_len <= 0 or footer_len + 8 > size:
        raise RuntimeError(
            "implausible parquet footer length {}".format(footer_len))
    foot = read_range(path, size - 8 - footer_len, footer_len + 8)
    return pq.read_metadata(pa.BufferReader(foot))


def get_num_samples_of_parquet(path):
    """Rows in a parquet shard, from its footer (no data read; footer-only
    ranged reads on a non-local storage backend). Transient storage
    errors retry; a corrupt or truncated footer, or an injected
    ``truncate`` at the ``read`` site, raises a ValueError naming the
    shard."""

    def _read():
        faults.fault_point("open", path)
        if faults.fault_point("read", path) == "truncate":
            raise RuntimeError("injected truncated footer read")
        from ..resilience.io import backend_if_nonlocal
        if backend_if_nonlocal() is not None:
            return read_footer_metadata(path).num_rows
        import pyarrow.parquet as pq
        return pq.ParquetFile(path).metadata.num_rows

    try:
        return with_retries(_read, desc="parquet footer {}".format(path))
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


def num_samples_cache_is_stale(dir_path, cache):
    """True when the cache's key set differs from the parquet shards on
    disk (a crash window or a partial re-balance can publish a cache of
    another shard set); a stale cache is recounted."""
    if cache is None:
        return True
    try:
        names = sorted(os.listdir(dir_path))
    except OSError:
        return True
    on_disk = {n for n in names if _is_parquet_path(n)}
    return {k for k in cache if k != NUM_SAMPLES_SIZES_KEY} != on_disk


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
        if num_samples_cache_is_stale(dir_path, cache):
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


def write_num_samples_cache(dir_path, counts, with_sizes=False):
    """Store {basename: count} next to the shards, durably and atomically.
    ``with_sizes=True`` (the ingest service's mode) also records each
    shard's byte length under ``__sizes__``, so a growing directory is
    validated per entry (``trusted_num_samples_entries``)."""
    payload = dict(counts)
    if with_sizes:
        sizes = {}
        for name in sorted(counts):
            try:
                sizes[name] = os.path.getsize(os.path.join(dir_path, name))
            except OSError:
                # A racing unlink leaves the entry size-less: it then
                # reads as untrusted and is recounted from its footer.
                pass
        payload[NUM_SAMPLES_SIZES_KEY] = sizes
    atomic_write(os.path.join(dir_path, NUM_SAMPLES_CACHE_NAME),
                 json.dumps(payload, sort_keys=True))


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
