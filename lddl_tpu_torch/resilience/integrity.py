"""Shard integrity manifests: per-shard byte length + CRC32.

Counterpart of ``build_manifest``, ``read_manifest`` and ``shard_checksum``
of ``lddl_tpu/resilience/integrity.py`` in its default ``full`` mode
(local files, no retries, no fault injection). The preprocess and the
balancer publish a ``.manifest.json`` next to ``.num_samples.json`` in
every shard directory: ``{basename: {"bytes": n, "crc32": c}}`` plus a
reserved ``__meta__`` entry with the shards' schema version and, for a
directory of offline-packed shards of one row shape, that shape.

Construction is SPMD: ranks checksum a strided subset of shards, one
sum-allreduce merges (each entry is computed by exactly one rank, so the
sum IS the value), rank 0 atomically publishes.
"""

import json
import os
import zlib

from ..utils.fs import _is_parquet_path
from ..utils.io import atomic_write

MANIFEST_NAME = ".manifest.json"

_CHUNK = 1 << 20


def shard_checksum(path):
    """(byte_length, crc32) of a file, streamed in 1 MiB chunks."""
    crc = 0
    nbytes = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(_CHUNK)
            if not chunk:
                break
            crc = zlib.crc32(chunk, crc)
            nbytes += len(chunk)
    return nbytes, crc & 0xFFFFFFFF


def read_manifest(dir_path):
    """The manifest of a shard directory as a dict, or None when it is
    absent or unreadable."""
    try:
        with open(os.path.join(dir_path, MANIFEST_NAME), "r") as f:
            manifest = json.load(f)
    except (OSError, ValueError):
        return None
    return manifest if isinstance(manifest, dict) else None


def _shard_schema_info(path):
    """(token-id schema version 1|2, packed row shape or None) off one
    shard's parquet footer, or (None, None) when it is unreadable."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    from ..preprocess.binning import schema_version_of_names
    from ..preprocess.packing import pack_shape_of_schema
    try:
        schema = pq.read_schema(path)
    except (OSError, pa.ArrowInvalid):
        return None, None
    return schema_version_of_names(schema.names), pack_shape_of_schema(schema)


def build_manifest(dir_path, comm=None, log=None):
    """Checksum every parquet shard directly in ``dir_path`` (rank-strided)
    and publish the manifest from rank 0; returns it (None when the
    directory holds no shard)."""
    from ..parallel.distributed import LocalCommunicator
    comm = comm or LocalCommunicator()
    try:
        names = [n for n in sorted(os.listdir(dir_path))
                 if _is_parquet_path(n)]
    except OSError:
        names = []
    if not names:
        return None
    sizes = [0] * len(names)
    crcs = [0] * len(names)
    vflags = [0, 0]  # token-id schema v1 / v2 seen on this rank's stride
    # Packed-shape homogeneity, allreduce-sum friendly: [sum L, sum L^2,
    # sum P, sum P^2, packed shards, unpacked shards]. The shape is
    # recorded iff every readable shard is packed with zero variance.
    pstats = [0, 0, 0, 0, 0, 0]
    for i in range(comm.rank, len(names), comm.world_size):
        path = os.path.join(dir_path, names[i])
        sizes[i], crcs[i] = shard_checksum(path)
        v, pack_shape = _shard_schema_info(path)
        if v is None:
            continue
        vflags[v - 1] = 1
        if pack_shape is None:
            pstats[5] += 1
            continue
        L, P = pack_shape
        pstats[:5] = [pstats[0] + L, pstats[1] + L * L, pstats[2] + P,
                      pstats[3] + P * P, pstats[4] + 1]
    sizes = comm.allreduce_sum(sizes)
    crcs = comm.allreduce_sum(crcs)
    vflags = comm.allreduce_sum(vflags)
    pstats = [int(x) for x in comm.allreduce_sum(pstats)]
    manifest = {n: {"bytes": int(s), "crc32": int(c)}
                for n, s, c in zip(names, sizes, crcs)}
    versions = [v for v, flag in zip((1, 2), vflags) if flag]
    if len(versions) == 1:
        manifest["__meta__"] = {"schema_version": versions[0]}
    elif versions:
        manifest["__meta__"] = {"schema_versions": versions}
    n_packed = pstats[4]
    if n_packed and not pstats[5] \
            and pstats[1] * n_packed == pstats[0] * pstats[0] \
            and pstats[3] * n_packed == pstats[2] * pstats[2]:
        from ..preprocess.packing import pack_meta_of
        manifest.setdefault("__meta__", {})["packed"] = pack_meta_of(
            pstats[0] // n_packed, pstats[2] // n_packed)
    if comm.rank == 0:
        atomic_write(os.path.join(dir_path, MANIFEST_NAME),
                     json.dumps(manifest, sort_keys=True))
    comm.barrier()
    if log is not None:
        log("integrity manifest: {} shard(s) in {}".format(
            len(names), dir_path))
    return manifest
