"""Shard integrity manifests: per-shard byte length + CRC32, written by
the producers and verified by the loader at startup.

Counterpart of ``build_manifest``, ``read_manifest``, ``shard_checksum``,
``verify_shards`` and ``_check_one_shard`` of
``lddl_tpu/resilience/integrity.py``. The preprocess and the balancer
publish a ``.manifest.json`` next to ``.num_samples.json`` in every shard
directory: ``{basename: {"bytes": n, "crc32": c}}`` plus a reserved
``__meta__`` entry with the shards' schema version and, for a directory
of offline-packed shards of one row shape, that shape. The loader
verifies it at startup: a truncated shard is then a named startup
decision, ``on_corrupt="fail"`` or ``"quarantine"``, instead of a parquet
error mid-epoch.

Construction and verification are SPMD: ranks work on a strided subset
of shards and one sum-allreduce merges (each entry is computed by exactly
one rank, so the sum IS the value).

Env knobs, as the reference's:

- ``LDDL_TPU_MANIFEST``: ``full`` (the default; also ``1`` and any
  unknown value) as above; ``size`` stats the sizes and reads nothing,
  so its entries carry no ``crc32`` (and it writes no ``__meta__`` but
  ``extra_meta``): the loader then checks lengths only and misses a
  same-length corruption; ``0`` writes no manifest, and the loader trusts
  every shard;
- ``LDDL_TPU_VERIFY_CRC=1`` makes the startup check re-hash every shard
  whose entry has a ``crc32`` instead of checking byte lengths only.
"""

import json
import os
import zlib

from . import faults
from .io import atomic_write, with_retries
from ..utils.fs import _is_parquet_path

MANIFEST_NAME = ".manifest.json"

_CHUNK = 1 << 20


class ShardIntegrityError(RuntimeError):
    pass


def shard_checksum(path):
    """(byte_length, crc32) of a file, streamed in 1 MiB chunks, with
    transient-error retries (a retry restarts the whole checksum)."""

    def _sum():
        faults.fault_point("open", path)
        crc = 0
        nbytes = 0
        with open(path, "rb") as f:
            while True:
                action = faults.fault_point("read", path)
                chunk = f.read(_CHUNK)
                if action == "truncate":
                    chunk = chunk[:max(0, len(chunk) // 2 - 1)]
                    crc = zlib.crc32(chunk, crc)
                    nbytes += len(chunk)
                    break
                if not chunk:
                    break
                crc = zlib.crc32(chunk, crc)
                nbytes += len(chunk)
        return nbytes, crc & 0xFFFFFFFF

    return with_retries(_sum, desc="checksum {}".format(path))


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


def manifest_mode():
    """``LDDL_TPU_MANIFEST``'s mode: ``"full"``, ``"size"`` or ``"0"``
    (``1`` and any unknown value give ``"full"``)."""
    mode = os.environ.get("LDDL_TPU_MANIFEST", "full")
    return mode if mode in ("size", "0") else "full"


def build_manifest(dir_path, comm=None, log=None, extra_meta=None):
    """Checksum every parquet shard directly in ``dir_path`` (rank-strided)
    and publish the manifest from rank 0; returns it (None when the
    directory holds no shard and no ``extra_meta`` is given, and under
    ``LDDL_TPU_MANIFEST=0``). ``manifest_mode`` says what is written.

    ``extra_meta`` merges keys into the reserved ``__meta__`` entry: the
    ingest publisher records the latest generation and each generation's
    shard list there (the loader's generation-pickup gate). It must be
    deterministic content: manifest bytes are compared on resume."""
    mode = manifest_mode()
    if mode == "0":
        return None
    if comm is None:
        from ..utils.comm import LocalCommunicator
        comm = LocalCommunicator()
    try:
        names = [n for n in sorted(os.listdir(dir_path))
                 if _is_parquet_path(n)]
    except OSError:
        names = []
    if not names and not extra_meta:
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
        if mode == "size":
            # Stat only: no CRC pass and no footer read.
            sizes[i] = with_retries(lambda p=path: os.stat(p).st_size,
                                    desc="stat " + path)
            continue
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
    manifest = {n: ({"bytes": int(s)} if mode == "size"
                    else {"bytes": int(s), "crc32": int(c)})
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
    if extra_meta:
        manifest.setdefault("__meta__", {}).update(extra_meta)
    if comm.rank == 0:
        atomic_write(os.path.join(dir_path, MANIFEST_NAME),
                     json.dumps(manifest, sort_keys=True))
    comm.barrier()
    if log is not None:
        log("integrity manifest: {} shard(s) in {}".format(
            len(names), dir_path))
    return manifest


def _check_one_shard(path, entry, check_crc):
    """None if the shard matches its manifest entry, else the reason.
    Transient storage errors retry (a startup blip is not corruption); a
    shard that stays unreadable is flagged, with the error as reason."""

    def _stat():
        faults.fault_point("open", path)
        return os.stat(path).st_size

    try:
        actual_bytes = with_retries(_stat, desc="stat {}".format(path))
    except OSError as e:
        return "unreadable: {}".format(e)
    if actual_bytes != entry.get("bytes"):
        return "size mismatch: manifest says {} bytes, found {}".format(
            entry.get("bytes"), actual_bytes)
    if check_crc and entry.get("crc32") is not None:
        _, crc = shard_checksum(path)
        if crc != entry.get("crc32"):
            return ("crc32 mismatch: manifest says {:#010x}, "
                    "found {:#010x}".format(entry.get("crc32"), crc))
    return None


def verify_shards(file_paths, on_corrupt="fail", check_crc=None, log=None,
                  comm=None):
    """Verify shards against their directories' manifests; returns
    ``(good_paths, excluded)`` with ``excluded`` a list of
    ``(path, reason)``. Shards without a manifest entry (or in a
    directory without a manifest) are trusted as they are. Byte lengths
    are always checked; CRC re-hashing with ``check_crc=True`` or
    ``LDDL_TPU_VERIFY_CRC=1``.

    With a communicator of several ranks the checks stripe across ranks
    and the verdicts are allreduced, so every rank excludes the same
    shards. ``on_corrupt="fail"`` raises ShardIntegrityError naming every
    corrupt shard; ``"quarantine"`` excludes them, logs and warns."""
    if on_corrupt not in ("fail", "quarantine"):
        raise ValueError(
            "on_corrupt must be 'fail' or 'quarantine', got {!r}".format(
                on_corrupt))
    if check_crc is None:
        check_crc = os.environ.get("LDDL_TPU_VERIFY_CRC", "0") == "1"
    from ..observability import event, inc, span
    rank, world = (0, 1) if comm is None else (comm.rank, comm.world_size)
    with span("resilience.verify_shards", shards=len(file_paths),
              check_crc=check_crc):
        manifests = {d: read_manifest(d)
                     for d in {os.path.dirname(p) for p in file_paths}}
        flags = [0] * len(file_paths)
        reasons = {}
        for i in range(rank, len(file_paths), world):
            path = file_paths[i]
            manifest = manifests[os.path.dirname(path)]
            entry = manifest.get(os.path.basename(path)) if manifest else None
            if not entry:
                continue
            reason = _check_one_shard(path, entry, check_crc)
            if reason is not None:
                flags[i] = 1
                reasons[i] = reason
        if world > 1:
            flags = [int(f) for f in comm.allreduce_sum(flags)]

    good, excluded = [], []
    for i, path in enumerate(file_paths):
        if flags[i]:
            excluded.append((path, reasons.get(
                i, "flagged corrupt by another rank's strided check")))
        else:
            good.append(path)
    if excluded:
        inc("resilience_corrupt_shards_total", len(excluded))
        for p, r in excluded:
            event("resilience.corrupt_shard", path=p, reason=r[:200],
                  policy=on_corrupt)
        lines = ["  {} -- {}".format(p, r) for p, r in excluded]
        if on_corrupt == "fail":
            raise ShardIntegrityError(
                "{} corrupt shard(s) detected (on_corrupt=fail):\n{}\n"
                "Re-run the producing stage, or start with "
                "on_corrupt='quarantine' to exclude them.".format(
                    len(excluded), "\n".join(lines)))
        inc("resilience_quarantined_shards_total", len(excluded))
        msg = ("QUARANTINED {} corrupt shard(s); continuing on {} "
               "surviving shard(s):\n{}".format(
                   len(excluded), len(good), "\n".join(lines)))
        if log is not None:
            log(msg)
        import warnings
        warnings.warn(msg, stacklevel=2)
    return good, excluded
