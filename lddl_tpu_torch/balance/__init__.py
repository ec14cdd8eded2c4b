"""Shard balancing: ``balance_shards`` and ``generate_num_samples_cache``
(counterpart of ``lddl_tpu/balance``), and the ingest service's delta
balancer (``balance.delta``)."""

from .balancer import balance_shards, generate_num_samples_cache

__all__ = ["balance_shards", "generate_num_samples_cache"]
