"""Shard balancing: ``balance_shards`` and ``generate_num_samples_cache``
(counterpart of ``lddl_tpu/balance``; the delta balancer is not ported
yet)."""

from .balancer import balance_shards, generate_num_samples_cache

__all__ = ["balance_shards", "generate_num_samples_cache"]
