"""The offline preprocess stage: text corpus -> BERT pretraining shards.

Counterpart of ``lddl_tpu/preprocess`` for BERT (the BART preprocess is
not ported yet): block planning and reading (``readers``), sentence
splitting (``sentences``), the vocab table (``tokenizer``), pair creation
and static masking (``bert``, the native engine and ``ops.masking``),
binned, packed and text sinks (``binning``, ``packing``, ``sink``) and
the SPMD runner with its global shuffle (``runner``).
"""

from .readers import Block, plan_blocks, read_documents, split_id_text
from .sentences import (SplitterParams, split_sentences,
                        split_sentences_learned, train_splitter_params)
from .tokenizer import build_wordpiece_vocab, get_tokenizer
from .bert import BertPretrainConfig, create_pairs_from_document
from .binning import bin_id_of_num_tokens, num_bins
from .runner import run_bert_preprocess, run_sharded_pipeline

__all__ = [
    "Block",
    "BertPretrainConfig",
    "SplitterParams",
    "bin_id_of_num_tokens",
    "build_wordpiece_vocab",
    "create_pairs_from_document",
    "get_tokenizer",
    "num_bins",
    "plan_blocks",
    "read_documents",
    "run_bert_preprocess",
    "run_sharded_pipeline",
    "split_id_text",
    "split_sentences",
    "split_sentences_learned",
    "train_splitter_params",
]
