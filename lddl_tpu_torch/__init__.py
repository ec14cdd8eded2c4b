"""PyTorch/CUDA port of lddl_tpu for NVIDIA Hopper (H100).

This first slice carries the BERT NSP+MLM pretraining main path:
balanced, length-binned schema-v2 shards -> ``loader`` -> host-to-device
prefetch -> ``models.BertForPreTraining`` with the hand-written
single-block attention kernels (``ops.flash_attention``) -> ``models.train``
(pretrain loss, clipped AdamW).

Module and function names follow ``lddl_tpu`` so each piece can be read
beside its counterpart there. Nothing here imports JAX or ``lddl_tpu``:
the package keeps its own copy of everything it needs.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(see ``device.resolve_device``).
"""

from .device import resolve_device

__all__ = ["resolve_device"]
