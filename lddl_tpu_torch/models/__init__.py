from .bart import BartConfig, BartForPreTraining, bart_batch_loss
from .bert import BertConfig, BertForPreTraining, BertForPreTrainingPacked
from .checkpoint import latest_step, restore_train_state, save_train_state
from .sharding import shard_model
from .train import (create_train_state, make_eval_step, make_multi_step,
                    make_optimizer, make_sharded_multi_step,
                    make_sharded_train_step, make_train_step, mlm_gather_cap,
                    pretrain_loss)

__all__ = [
    "BartConfig",
    "BartForPreTraining",
    "BertConfig",
    "BertForPreTraining",
    "BertForPreTrainingPacked",
    "bart_batch_loss",
    "create_train_state",
    "latest_step",
    "make_eval_step",
    "make_multi_step",
    "make_optimizer",
    "make_sharded_multi_step",
    "make_sharded_train_step",
    "make_train_step",
    "mlm_gather_cap",
    "pretrain_loss",
    "restore_train_state",
    "save_train_state",
    "shard_model",
]
