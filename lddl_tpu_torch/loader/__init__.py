"""The port's loaders. Importing this package imports no torch: spawned
process-mode workers import it to unpickle their dataset and collate.
``sharding``'s names (mesh placement, which needs torch) load on first
use."""

from .datasets import ParquetDataset, ShuffleBuffer
from .dataloader import Binned, DataLoader, prefetch_to_device
from .bart import BartCollate, get_bart_pretrain_data_loader
from .bert import (BertCollate, BertPackedCollate, BertPrepackedCollate,
                   BertPretrainBinned, GenerationFollower,
                   GenerationSnapshot, PackedBertLoader, PackedRow,
                   generation_gate_filter, get_bert_pretrain_data_loader,
                   packed_shape_of_dir)
from .vocab import Vocab

_SHARDING = ("dp_info_of_process", "process_dp_info", "to_device_batch",
             "to_device_step_batches")


def __getattr__(name):
    if name in _SHARDING:
        from . import sharding
        return getattr(sharding, name)
    raise AttributeError("module {!r} has no attribute {!r}".format(
        __name__, name))


__all__ = [
    "BartCollate",
    "BertCollate",
    "BertPackedCollate",
    "BertPrepackedCollate",
    "BertPretrainBinned",
    "Binned",
    "DataLoader",
    "GenerationFollower",
    "GenerationSnapshot",
    "PackedBertLoader",
    "PackedRow",
    "ParquetDataset",
    "ShuffleBuffer",
    "Vocab",
    "generation_gate_filter",
    "get_bart_pretrain_data_loader",
    "get_bert_pretrain_data_loader",
    "packed_shape_of_dir",
    "prefetch_to_device",
] + list(_SHARDING)
