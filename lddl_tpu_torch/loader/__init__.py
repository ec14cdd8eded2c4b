from .datasets import ParquetDataset, ShuffleBuffer
from .dataloader import Binned, DataLoader, prefetch_to_device
from .bart import BartCollate, get_bart_pretrain_data_loader
from .bert import (BertCollate, BertPretrainBinned,
                   get_bert_pretrain_data_loader)
from .vocab import Vocab

__all__ = [
    "BartCollate",
    "BertCollate",
    "BertPretrainBinned",
    "Binned",
    "DataLoader",
    "ParquetDataset",
    "ShuffleBuffer",
    "Vocab",
    "get_bart_pretrain_data_loader",
    "get_bert_pretrain_data_loader",
    "prefetch_to_device",
]
