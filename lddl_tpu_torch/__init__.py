"""PyTorch/CUDA port of lddl_tpu for NVIDIA Hopper (H100).

The offline BERT data path makes the shards: a text corpus ->
``preprocess.run_bert_preprocess`` (the native C++ engine, static
masking with numpy or the torch maskers of ``ops.masking``) ->
``balance.balance_shards``; ``cli`` runs both as commands.

It carries two pretraining paths: BERT NSP+MLM (balanced, length-binned
schema-v2 shards -> ``loader`` -> host-to-device prefetch ->
``models.BertForPreTraining`` -> ``models.train``: pretrain loss, clipped
AdamW) and BART denoising (schema-v2 BART shards -> ``loader.bart`` ->
prefetch -> ``models.BartForPreTraining`` -> the same step with
``bart_batch_loss``). Attention runs on hand-written Hopper kernels
(``ops.flash_attention``): single-block ones for short sequences,
online-softmax ones from L_pad 1024.

On several GPUs (``parallel``: ``init_distributed``, ``make_mesh``) the
same steps run sharded over a dp/fsdp/tp/sp ``DeviceMesh``
(``models.create_train_state``, ``models.make_sharded_train_step``;
``loader.process_dp_info`` and ``loader.to_device_batch`` feed them).

Module and function names follow ``lddl_tpu`` so each piece can be read
beside its counterpart there. Nothing here imports JAX or ``lddl_tpu``:
the package keeps its own copy of everything it needs.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(see ``device.resolve_device``).
"""

from .device import resolve_device

__all__ = ["resolve_device"]
