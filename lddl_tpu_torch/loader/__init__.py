from .datasets import ParquetDataset, ShuffleBuffer
from .dataloader import Binned, DataLoader, prefetch_to_device
from .bert import (BertCollate, BertPretrainBinned,
                   get_bert_pretrain_data_loader)
from .vocab import Vocab

__all__ = [
    "BertCollate",
    "BertPretrainBinned",
    "Binned",
    "DataLoader",
    "ParquetDataset",
    "ShuffleBuffer",
    "Vocab",
    "get_bert_pretrain_data_loader",
    "prefetch_to_device",
]
