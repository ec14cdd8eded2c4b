"""Tiny cells of both families for the CPU tests: the cell files' keys at
sizes a CPU run holds in seconds."""

import copy
import functools
import json
import os

from portbench import lengths
from portbench.harness import ROOT, Cell

TINY_CONFIG = {
    "bert_large": dict(vocab_size=512, hidden_size=64, num_hidden_layers=2,
                       num_attention_heads=4, intermediate_size=128,
                       max_position_embeddings=128),
    "bart_base": dict(vocab_size=512, d_model=64, encoder_layers=2,
                      decoder_layers=2, encoder_attention_heads=4,
                      decoder_attention_heads=4, encoder_ffn_dim=128,
                      decoder_ffn_dim=128, max_position_embeddings=128),
}
# The tiny BERT mix's loader seed: the first from 12345 whose first four
# batches are of four bins, as the cell's own.
TINY_TRAFFIC = {
    "p2_binned": dict(bin_size=32, target_seq_length=128, samples=2048,
                      shards_per_bin=4, batch_size=8, num_workers=2,
                      shuffle_buffer_size=256, trace_steps=2,
                      loader_seed=12435),
    "L1024_denoise": dict(max_seq_length=128, min_chunk_tokens=140,
                          sentence_tokens=[4, 20], chunks=512, shards=4,
                          batch_size=4, num_workers=2,
                          shuffle_buffer_size=64, trace_steps=2),
}
CELLS = {"bert_large.p2_binned": ("bert_large", "p2_binned"),
         "bart_base.L1024": ("bart_base", "L1024_denoise")}
# Limits of the tiny cells on the CPU, set from their readings there: the
# bf16 program against the fp32 reference reads loss_gap <= 4.2e-5,
# grad_gap <= 0.0081 and update_gap <= 0.017 over six seeds (1, 3, 77,
# 2**31 + 99, 2**32 + 1, 2**33 + 5); the fp8 control reads >= 7.9e-5,
# 0.094 and 0.030 on seeds 3 and 2**32 + 1.
TINY_LIMITS = {"data_mismatches": 0, "loss_gap": 1e-3, "grad_gap": 0.03,
               "update_gap": 0.04}


@functools.lru_cache(maxsize=None)
def _shares(rule):
    return lengths.derive(json.loads(rule))


def _load(kind, name):
    with open(os.path.join(ROOT, kind, name + ".json")) as f:
        return json.load(f)


def tiny_cell(workload, limits=None):
    config, traffic = CELLS[workload]
    cfg = _load("configs", config)
    cfg.update(TINY_CONFIG[config])
    tr = _load("traffic", traffic)
    tr.update(TINY_TRAFFIC[traffic])
    if "lengths" in tr:
        tr["lengths"].update(max_seq_length=tr["target_seq_length"],
                             document_sentences=200)
        tr["length_shares"] = _shares(json.dumps(tr["lengths"],
                                                 sort_keys=True))
    return Cell(workload, cfg, tr, copy.deepcopy(limits or TINY_LIMITS),
                [], [])
