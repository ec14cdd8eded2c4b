from .datasets import ParquetDataset, ShuffleBuffer
from .dataloader import Binned, DataLoader, prefetch_to_device
from .bart import BartCollate, get_bart_pretrain_data_loader
from .bert import (BertCollate, BertPackedCollate, BertPrepackedCollate,
                   BertPretrainBinned, PackedBertLoader, PackedRow,
                   get_bert_pretrain_data_loader, packed_shape_of_dir)
from .sharding import (dp_info_of_process, process_dp_info, to_device_batch,
                       to_device_step_batches)
from .vocab import Vocab

__all__ = [
    "BartCollate",
    "BertCollate",
    "BertPackedCollate",
    "BertPrepackedCollate",
    "BertPretrainBinned",
    "Binned",
    "DataLoader",
    "PackedBertLoader",
    "PackedRow",
    "ParquetDataset",
    "ShuffleBuffer",
    "Vocab",
    "get_bart_pretrain_data_loader",
    "get_bert_pretrain_data_loader",
    "dp_info_of_process",
    "packed_shape_of_dir",
    "prefetch_to_device",
    "process_dp_info",
    "to_device_batch",
    "to_device_step_batches",
]
