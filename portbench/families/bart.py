"""BART denoising cells: chunked shards -> the port's BART loader (text
infilling and sentence permutation in the collate) ->
``BartForPreTraining`` under ``make_train_step`` with
``bart_batch_loss``."""

import collections

import numpy as np

from .. import data, flops
from ..reference import bart as reference

REFERENCE = reference
# Reference rows a block on the card (fp32 scores of 18 attentions at
# L=1024 in a few GB).
REFERENCE_BLOCK = 4
# Longest replacement span counted in the infilling check: a Poisson(3)
# draw reaches it with probability below 1e-17.
MAX_SPAN = 30


def make_data(root, cfg, traffic, seed):
    return data.bart_chunks(root, traffic, cfg["vocab_size"], seed)


def make_loader(shards, vocab, traffic, seed):
    from lddl_tpu_torch.loader import get_bart_pretrain_data_loader
    return get_bart_pretrain_data_loader(
        shards, vocab_file=vocab, batch_size=traffic["batch_size"],
        num_workers=traffic["num_workers"],
        shuffle_buffer_size=traffic["shuffle_buffer_size"],
        shuffle_buffer_warmup_factor=traffic["shuffle_buffer_warmup_factor"],
        max_seq_length=traffic["max_seq_length"],
        mask_ratio=traffic["mask_ratio"],
        poisson_lambda=traffic["poisson_lambda"],
        permute_sentences=traffic["permute_sentences"],
        sequence_length_alignment=traffic["sequence_length_alignment"],
        base_seed=seed)


def make_model(cfg, device):
    """(model on ``device`` with uninitialised weights, batch loss)."""
    import torch
    from lddl_tpu_torch.models import (BartConfig, BartForPreTraining,
                                       bart_batch_loss)
    port = BartConfig(
        vocab_size=cfg["vocab_size"], hidden_size=cfg["d_model"],
        num_encoder_layers=cfg["encoder_layers"],
        num_decoder_layers=cfg["decoder_layers"],
        num_heads=cfg["encoder_attention_heads"],
        intermediate_size=cfg["encoder_ffn_dim"],
        max_position_embeddings=cfg["max_position_embeddings"],
        hidden_dropout=cfg["dropout"],
        attention_dropout=cfg["attention_dropout"],
        initializer_range=cfg["init_std"],
        dtype=getattr(torch, cfg["activation_dtype"]),
        attention_impl=cfg["attention_impl"])
    with torch.device("meta"):
        model = BartForPreTraining(port)
    return model.to_empty(device=device), bart_batch_loss


def check_shapes(traffic):
    """Every batch pads to ``max_seq_length``: no shape for the output
    check's steps to cover beyond the first."""
    return set()


def shape_of(traffic, batch):
    return None


def warmup_batches(cfg, traffic, device, seed):
    """None: every batch has the one shape [batch, max_seq_length], which
    the check steps have run."""
    return []


def batch_stats(cfg, batch):
    b, le = batch["input_ids"].shape
    ld = batch["decoder_input_ids"].shape[1]
    return {"tokens": int((batch["labels"] != -1).sum()),
            "flops": flops.bart_step_flops(cfg, b, le, ld),
            "lens": batch["attention_mask"].sum(axis=1),
            "heads": cfg["encoder_attention_heads"],
            "head_dim": cfg["d_model"] // cfg["encoder_attention_heads"]}


def check_batches(index, traffic, batches):
    """The loader's batches against the chunks written: every row's labels
    and decoder inputs are the chunk's first ``max_seq_length - 2`` ids
    between [CLS] and [SEP], shifted right behind [CLS] for the decoder;
    the encoder input is [CLS] noised [SEP] with its padding mask, its
    tokens other than [MASK] are drawn from the clean ones (as a multiset),
    and the tokens the infilling removed plus its [MASK]s cover at least
    ``mask_ratio`` of the clean tokens, overshooting by less than one
    span. Sentence order after permutation is not checked. Returns
    (mismatches, rows checked, first faults)."""
    limit = traffic["max_seq_length"] - 2
    faults, rows, count = [], 0, 0
    for n, bt in enumerate(batches):
        for i in range(bt["input_ids"].shape[0]):
            rows += 1
            msg = _check_row(index, bt, i, limit, traffic["mask_ratio"])
            if msg:
                count += 1
                if len(faults) < 5:
                    faults.append("batch {} row {}: {}".format(n, i, msg))
    return count, rows, faults


def _check_row(index, bt, i, limit, ratio):
    labels, dec = bt["labels"][i], bt["decoder_input_ids"][i]
    enc, am = bt["input_ids"][i], bt["attention_mask"][i]
    chunk = index.get(labels[1:17].astype(np.int32).tobytes())
    if chunk is None:
        return "labels name no chunk written"
    clean = chunk[:limit]
    n = len(clean)
    want = np.concatenate([[data.CLS], clean, [data.SEP]])
    l = len(labels)
    if not (np.array_equal(labels[:n + 2], want)
            and np.all(labels[n + 2:] == -1)):
        return "labels differ from the chunk"
    if not (dec[0] == data.CLS and np.array_equal(dec[1:n + 2], want[:-1])
            and np.all(dec[n + 2:] == data.PAD)):
        return "decoder inputs differ from the shifted chunk"
    e = int(am.sum())
    if not (np.all(am[:e] == 1) and enc[0] == data.CLS
            and enc[e - 1] == data.SEP and np.all(enc[e:] == data.PAD)
            and e <= l):
        return "encoder input not [CLS] noised [SEP] and padding"
    noised = enc[1:e - 1]
    kept = noised[noised != data.MASK]
    masks = len(noised) - len(kept)
    if collections.Counter(kept.tolist()) - collections.Counter(
            clean.tolist()):
        return "encoder holds tokens the chunk lacks"
    budget = int(round(n * ratio))
    removed = n - len(kept)
    if masks == 0 or removed + masks < budget or removed >= budget + MAX_SPAN:
        return "infilling removed {} tokens with {} masks for a budget of {}"\
            .format(removed, masks, budget)
    return None
