"""Attention kernels of the port (see flash_attention)."""
