"""Plain BERT pretraining (masked LM + next-sentence prediction) in
float32, after Devlin et al. 2018 and google-research/bert: post-LN
encoder layers, learned positions and token types, LayerNorm eps from the
configuration, tanh-approximate GELU (as that code computes it), the MLM
transform, LayerNorm and decoder at the masked positions, and the pooler
and NSP classifier on the [CLS] row. Departures, as in the program: the
MLM decoder has weights of its own (not tied to the word embeddings) and
attention-probability dropout is off.

Configurations use the published key names (``hidden_size``,
``num_hidden_layers``, ...). Parameters are named as in the program's
state dict.
"""

import torch
import torch.nn.functional as F

from .common import (attention, dense_specs, drop, gelu, layer_norm, linear,
                     norm_specs)


def param_specs(cfg):
    h, i = cfg["hidden_size"], cfg["intermediate_size"]
    specs = [("embeddings.word_embeddings.weight", (cfg["vocab_size"], h),
              "normal"),
             ("embeddings.position_embeddings.weight",
              (cfg["max_position_embeddings"], h), "normal"),
             ("embeddings.token_type_embeddings.weight",
              (cfg["type_vocab_size"], h), "normal")]
    specs += norm_specs("embeddings.layer_norm", h)
    for n in range(cfg["num_hidden_layers"]):
        p = "layer_{}.".format(n)
        for name in ("query", "key", "value", "output"):
            specs += dense_specs(p + "attention." + name, h, h)
        specs += norm_specs(p + "attention_norm", h)
        specs += dense_specs(p + "ffn.intermediate", h, i)
        specs += dense_specs(p + "ffn.output", i, h)
        specs += norm_specs(p + "ffn_norm", h)
    specs += dense_specs("mlm_transform", h, h)
    specs += norm_specs("mlm_norm", h)
    specs += dense_specs("mlm_decoder", h, cfg["vocab_size"])
    specs += dense_specs("pooler", h, h)
    specs += dense_specs("nsp_classifier", h, 2)
    return specs


def hidden_dropout(cfg):
    return cfg["hidden_dropout_prob"]


def dropout_shapes(cfg, batch):
    """Shapes of the hidden-dropout sites of one step, in forward order."""
    b, l = batch["input_ids"].shape
    return [(b, l, cfg["hidden_size"])] * (1 + 2 * cfg["num_hidden_layers"])


def _forward_sums(cfg, W, t, keep, p, prec):
    """(sum of MLM cross entropies, sum of NSP cross entropies) of the rows
    in ``t``."""
    eps = cfg["layer_norm_eps"]
    heads = cfg["num_attention_heads"]
    r = prec.round
    ids, amask = t["input_ids"].long(), t["attention_mask"]
    l = ids.shape[1]
    e = "embeddings."
    x = r(r(r(W[e + "word_embeddings.weight"][ids])
            + r(W[e + "position_embeddings.weight"][:l])[None])
          + r(W[e + "token_type_embeddings.weight"][t["token_type_ids"]
                                                    .long()]))
    x = drop(layer_norm(x, W[e + "layer_norm.weight"],
                        W[e + "layer_norm.bias"], eps, prec), keep[0], p, prec)
    for n in range(cfg["num_hidden_layers"]):
        pre = "layer_{}.".format(n)
        a = attention(x, x, W, pre + "attention.", heads, prec,
                      key_mask=amask)
        x = layer_norm(r(x + drop(a, keep[1 + 2 * n], p, prec)),
                       W[pre + "attention_norm.weight"],
                       W[pre + "attention_norm.bias"], eps, prec)
        h = linear(gelu(linear(x, W[pre + "ffn.intermediate.weight"],
                               W[pre + "ffn.intermediate.bias"], prec), prec),
                   W[pre + "ffn.output.weight"], W[pre + "ffn.output.bias"],
                   prec)
        x = layer_norm(r(x + drop(h, keep[2 + 2 * n], p, prec)),
                       W[pre + "ffn_norm.weight"], W[pre + "ffn_norm.bias"],
                       eps, prec)
    labels = t["labels"].long()
    rows, cols = torch.nonzero(labels != -1, as_tuple=True)
    h = gelu(linear(x[rows, cols], W["mlm_transform.weight"],
                    W["mlm_transform.bias"], prec), prec)
    h = layer_norm(h, W["mlm_norm.weight"], W["mlm_norm.bias"], eps, prec)
    logits = F.linear(h, W["mlm_decoder.weight"], W["mlm_decoder.bias"])
    mlm = F.cross_entropy(logits, labels[rows, cols], reduction="sum")
    pooled = r(torch.tanh(linear(x[:, 0], W["pooler.weight"],
                                 W["pooler.bias"], prec)))
    nsp_logits = F.linear(pooled, W["nsp_classifier.weight"],
                          W["nsp_classifier.bias"])
    nsp = F.cross_entropy(nsp_logits, t["next_sentence_labels"].long(),
                          reduction="sum")
    return mlm, nsp


def loss_and_grads(cfg, W, batch, keep, p, prec, block):
    """The step's loss (masked-LM mean over the masked positions + NSP mean
    over the rows) and its gradients, accumulated into ``W``'s leaves over
    blocks of ``block`` rows. ``batch``: tensors on the weights' device."""
    labels = batch["labels"]
    n_mlm = (labels != -1).sum().clamp_min(1)
    n_nsp = (batch["next_sentence_labels"] != -1).sum().clamp_min(1)
    rows = labels.shape[0]
    total = 0.0
    for s in range(0, rows, block):
        sl = slice(s, s + block)
        t = {k: v[sl] for k, v in batch.items()}
        mlm, nsp = _forward_sums(cfg, W, t, [m[sl] for m in keep], p, prec)
        loss = mlm / n_mlm + nsp / n_nsp
        loss.backward()
        total += float(loss.detach())
    return total
