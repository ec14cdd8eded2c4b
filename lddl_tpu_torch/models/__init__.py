from .bart import BartConfig, BartForPreTraining, bart_batch_loss
from .bert import BertConfig, BertForPreTraining
from .train import (make_optimizer, make_train_step, mlm_gather_cap,
                    pretrain_loss)

__all__ = [
    "BartConfig",
    "BartForPreTraining",
    "BertConfig",
    "BertForPreTraining",
    "bart_batch_loss",
    "make_optimizer",
    "make_train_step",
    "mlm_gather_cap",
    "pretrain_loss",
]
