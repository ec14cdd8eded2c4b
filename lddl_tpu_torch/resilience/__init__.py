"""Shard integrity manifests (``integrity``)."""
