"""Atomic publish and shard reads, re-exported from their one home,
``resilience/io.py`` (retries, fault injection and the storage backend
live there)."""

from ..resilience.io import (atomic_publish, atomic_write, read_table,
                             write_table_atomic)

__all__ = ["atomic_publish", "atomic_write", "read_table",
           "write_table_atomic"]
