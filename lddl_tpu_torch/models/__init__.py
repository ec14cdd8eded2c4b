from .bert import BertConfig, BertForPreTraining
from .train import (make_optimizer, make_train_step, mlm_gather_cap,
                    pretrain_loss)

__all__ = [
    "BertConfig",
    "BertForPreTraining",
    "make_optimizer",
    "make_train_step",
    "mlm_gather_cap",
    "pretrain_loss",
]
