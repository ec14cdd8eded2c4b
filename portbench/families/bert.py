"""BERT pretraining cells: binned, statically masked shards -> the port's
BERT loader -> ``BertForPreTraining`` under ``make_train_step`` (the
default loss: MLM over the gathered masked positions + NSP)."""

import numpy as np

from .. import data, flops
from ..reference import bert as reference

REFERENCE = reference
# Reference rows a block on the card (fits the fp32 activations of 24
# layers at L=512 in a few GB).
REFERENCE_BLOCK = 8


def make_data(root, cfg, traffic, seed):
    return data.bert_binned(root, traffic, cfg["vocab_size"], seed)


def make_loader(shards, vocab, traffic, seed):
    """The port's BERT loader over the cell's shards. Its base seed is the
    traffic's, not the run's: it draws the order of the bins, so every
    seed's window takes the same sequence of batch shapes (and the same
    work), while the samples in them are the seed's."""
    from lddl_tpu_torch.loader import get_bert_pretrain_data_loader
    return get_bert_pretrain_data_loader(
        shards, vocab_file=vocab, batch_size=traffic["batch_size"],
        num_workers=traffic["num_workers"],
        shuffle_buffer_size=traffic["shuffle_buffer_size"],
        shuffle_buffer_warmup_factor=traffic["shuffle_buffer_warmup_factor"],
        sequence_length_alignment=traffic["sequence_length_alignment"],
        base_seed=traffic["loader_seed"])


def make_model(cfg, device):
    """(model on ``device`` with uninitialised weights, batch loss): the
    port's model at the configuration's sizes and precisions."""
    import torch
    from lddl_tpu_torch.models import BertConfig, BertForPreTraining
    port = BertConfig(
        vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"],
        num_layers=cfg["num_hidden_layers"],
        num_heads=cfg["num_attention_heads"],
        intermediate_size=cfg["intermediate_size"],
        max_position_embeddings=cfg["max_position_embeddings"],
        type_vocab_size=cfg["type_vocab_size"],
        hidden_dropout=cfg["hidden_dropout_prob"],
        attention_dropout=cfg["attention_probs_dropout_prob"],
        layer_norm_eps=cfg["layer_norm_eps"],
        initializer_range=cfg["initializer_range"],
        dtype=getattr(torch, cfg["activation_dtype"]),
        attention_impl=cfg["attention_impl"], mlm_gather=cfg["mlm_gather"])
    with torch.device("meta"):
        model = BertForPreTraining(port)
    return model.to_empty(device=device), None


def check_shapes(traffic):
    """The bins the output check's steps must cover: every bin that holds
    samples (each pads to its own lengths and, by its length, may take
    another attention path)."""
    return {k for k, lens in enumerate(data.bert_lengths(traffic))
            if len(lens)}


def shape_of(traffic, batch):
    """The bin of a host batch: that of its longest row."""
    longest = int(batch["attention_mask"].sum(axis=1).max())
    return (longest - 1) // traffic["bin_size"]


def warmup_batches(cfg, traffic, device, seed):
    """One batch at the top length of each bin, in the loader's layout: the
    shapes the window's steps take (every other length of a bin runs the
    same kernels and paths)."""
    import torch
    g = torch.Generator(device=device)
    g.manual_seed(seed % 2**63)
    b = traffic["batch_size"]
    out = []
    for k in sorted(check_shapes(traffic)):
        l = (k + 1) * traffic["bin_size"]
        ids = torch.randint(data.FIRST_ID, cfg["vocab_size"], (b, l),
                            generator=g, device=device, dtype=torch.int32)
        chosen = torch.rand((b, l), generator=g, device=device) < 0.15
        chosen[:, 0] = False
        out.append({
            "input_ids": ids,
            "token_type_ids": (torch.arange(l, device=device) >= l // 2)
            .to(torch.int32).expand(b, l).contiguous(),
            "attention_mask": torch.ones((b, l), dtype=torch.int32,
                                         device=device),
            "next_sentence_labels": torch.randint(
                0, 2, (b,), generator=g, device=device, dtype=torch.int32),
            "labels": torch.where(chosen, ids, -1).to(torch.int32)})
    return out


def batch_stats(cfg, batch):
    """Counts of one host batch: non-pad tokens, model FLOPs of its step,
    and the rows' valid lengths (the attention kernels' work)."""
    b, l = batch["input_ids"].shape
    lens = batch["attention_mask"].sum(axis=1)
    masked = int((batch["labels"] != -1).sum())
    return {"tokens": int(lens.sum()),
            "flops": flops.bert_step_flops(cfg, b, l, masked),
            "lens": lens, "heads": cfg["num_attention_heads"],
            "head_dim": cfg["hidden_size"] // cfg["num_attention_heads"]}


def check_batches(index, traffic, batches):
    """The loader's batches against the samples written: each row found
    again and equal in ids, segments, padding and labels (static masks),
    NSP label; one bin a batch; padded to the longest row rounded up to the
    alignment; no sample served twice. Returns (mismatches, rows checked,
    first faults)."""
    align = traffic["sequence_length_alignment"]
    seen, faults = set(), []
    rows, count = 0, [0]

    def fault(msg):
        count[0] += 1
        if len(faults) < 5:
            faults.append(msg)

    for n, bt in enumerate(batches):
        ids, tt = bt["input_ids"], bt["token_type_ids"]
        am, labels = bt["attention_mask"], bt["labels"]
        nsp = bt["next_sentence_labels"]
        b, l = ids.shape
        bins, longest = set(), 0
        for i in range(b):
            rows += 1
            row = ids[i]
            seps = np.flatnonzero(row == data.SEP)
            if len(seps) < 2 or row[0] != data.CLS:
                fault("batch {} row {}: no [CLS] A [SEP] B [SEP]".format(n, i))
                continue
            e = seps[1] + 1
            a, bb = row[1:seps[0]], row[seps[0] + 1:seps[1]]
            key = a.tobytes() + b"|" + bb.tobytes()
            hit = index.get(key)
            if hit is None or key in seen:
                fault("batch {} row {}: {}".format(
                    n, i, "sample not written" if hit is None
                    else "sample served twice"))
                continue
            seen.add(key)
            bin_id, _, _, is_next, pos, lab = hit
            bins.add(bin_id)
            longest = max(longest, e)
            want_tt = np.zeros(l, np.int32)
            want_tt[seps[0] + 1:e] = 1
            want_lab = np.full(l, -1, np.int32)
            want_lab[pos] = lab
            if not (np.all(row[e:] == data.PAD) and np.all(am[i, :e] == 1)
                    and np.all(am[i, e:] == 0) and np.array_equal(tt[i],
                                                                  want_tt)
                    and np.array_equal(labels[i], want_lab)
                    and int(nsp[i]) == int(is_next)):
                fault("batch {} row {}: segments, padding, labels or NSP "
                      "differ".format(n, i))
        if len(bins) > 1:
            fault("batch {}: rows of bins {}".format(n, sorted(bins)))
        if longest and l != -(-longest // align) * align:
            fault("batch {}: length {} for a longest row of {}".format(
                n, l, longest))
    return count[0], rows, faults
