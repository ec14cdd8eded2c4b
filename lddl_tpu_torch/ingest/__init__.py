"""Streaming ingestion: incremental preprocess + delta balance as a
long-lived service over a growing corpus (counterpart of
``lddl_tpu/ingest``; see journal.py and incremental.py)."""

from .incremental import ingest_once, join_pending_generation, watch
from .journal import Journal, diff_landing, doc_content_hash

__all__ = ["Journal", "diff_landing", "doc_content_hash", "ingest_once",
           "join_pending_generation", "watch"]
