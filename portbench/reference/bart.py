"""Plain BART denoising pretraining in float32, after Lewis et al. 2019
and facebook/bart-base: post-LN encoder and decoder layers, one token
table shared by the encoder and decoder inputs, learned positions,
LayerNorm after the embeddings (eps 1e-5), a causal decoder with
cross-attention over the encoder states, and an LM head over every
decoder position, the loss the mean cross entropy over the labelled
positions. Departures, as in the program: positions start at 0 (no
offset of 2), tanh-approximate GELU, no activation or attention
dropout, and an LM head with weights and bias of its own (not tied).

Configurations use facebook/bart-base's key names (``d_model``,
``encoder_layers``, ...). Parameters are named as in the program's state
dict.
"""

import torch.nn.functional as F

from .common import (attention, dense_specs, drop, gelu, layer_norm, linear,
                     norm_specs)

LN_EPS = 1e-5


def _layer_specs(prefix, h, i, cross):
    specs = []
    for part in ("self_attention",) + (("cross_attention",) if cross else ()):
        for name in ("query", "key", "value", "output"):
            specs += dense_specs(prefix + part + "." + name, h, h)
        specs += norm_specs(prefix + part.replace("_attention", "_norm"), h)
    specs += dense_specs(prefix + "ffn.intermediate", h, i)
    specs += dense_specs(prefix + "ffn.output", i, h)
    specs += norm_specs(prefix + "ffn_norm", h)
    return specs


def param_specs(cfg):
    h, v = cfg["d_model"], cfg["vocab_size"]
    pos = cfg["max_position_embeddings"]
    specs = [("shared_embeddings.weight", (v, h), "normal"),
             ("encoder_embed.positions.weight", (pos, h), "normal")]
    specs += norm_specs("encoder_embed.layer_norm", h)
    for n in range(cfg["encoder_layers"]):
        specs += _layer_specs("encoder_{}.".format(n), h,
                              cfg["encoder_ffn_dim"], False)
    specs += [("decoder_embed.positions.weight", (pos, h), "normal")]
    specs += norm_specs("decoder_embed.layer_norm", h)
    for n in range(cfg["decoder_layers"]):
        specs += _layer_specs("decoder_{}.".format(n), h,
                              cfg["decoder_ffn_dim"], True)
    specs += dense_specs("lm_head", h, v)
    return specs


def hidden_dropout(cfg):
    return cfg["dropout"]


def dropout_shapes(cfg, batch):
    """Shapes of the hidden-dropout sites of one step, in forward order."""
    b, le = batch["input_ids"].shape
    ld = batch["decoder_input_ids"].shape[1]
    h = cfg["d_model"]
    return ([(b, le, h)] * (1 + 2 * cfg["encoder_layers"])
            + [(b, ld, h)] * (1 + 3 * cfg["decoder_layers"]))


def _embed(W, prefix, ids, prec):
    r = prec.round
    x = r(r(W["shared_embeddings.weight"][ids])
          + r(W[prefix + "positions.weight"][:ids.shape[1]])[None])
    return layer_norm(x, W[prefix + "layer_norm.weight"],
                      W[prefix + "layer_norm.bias"], LN_EPS, prec)


def _ffn(x, W, pre, prec):
    return linear(gelu(linear(x, W[pre + "ffn.intermediate.weight"],
                              W[pre + "ffn.intermediate.bias"], prec), prec),
                  W[pre + "ffn.output.weight"], W[pre + "ffn.output.bias"],
                  prec)


def _norm(x, W, name, prec):
    return layer_norm(x, W[name + ".weight"], W[name + ".bias"], LN_EPS, prec)


def _forward_sum(cfg, W, t, keep, p, prec):
    """Sum of the cross entropies over the labelled positions of ``t``."""
    r = prec.round
    heads = cfg["encoder_attention_heads"]
    amask = t["attention_mask"]
    k = iter(keep)
    x = drop(_embed(W, "encoder_embed.", t["input_ids"].long(), prec),
             next(k), p, prec)
    for n in range(cfg["encoder_layers"]):
        pre = "encoder_{}.".format(n)
        a = attention(x, x, W, pre + "self_attention.", heads, prec,
                      key_mask=amask)
        x = _norm(r(x + drop(a, next(k), p, prec)), W, pre + "self_norm",
                  prec)
        x = _norm(r(x + drop(_ffn(x, W, pre, prec), next(k), p, prec)), W,
                  pre + "ffn_norm", prec)
    y = drop(_embed(W, "decoder_embed.", t["decoder_input_ids"].long(),
                    prec), next(k), p, prec)
    for n in range(cfg["decoder_layers"]):
        pre = "decoder_{}.".format(n)
        a = attention(y, y, W, pre + "self_attention.",
                      cfg["decoder_attention_heads"], prec, causal=True)
        y = _norm(r(y + drop(a, next(k), p, prec)), W, pre + "self_norm",
                  prec)
        c = attention(y, x, W, pre + "cross_attention.",
                      cfg["decoder_attention_heads"], prec, key_mask=amask)
        y = _norm(r(y + drop(c, next(k), p, prec)), W, pre + "cross_norm",
                  prec)
        y = _norm(r(y + drop(_ffn(y, W, pre, prec), next(k), p, prec)), W,
                  pre + "ffn_norm", prec)
    labels = t["labels"].long()
    sel = labels != -1
    logits = F.linear(y[sel], W["lm_head.weight"], W["lm_head.bias"])
    return F.cross_entropy(logits, labels[sel], reduction="sum")


def loss_and_grads(cfg, W, batch, keep, p, prec, block):
    """The step's loss (mean cross entropy over the labelled positions) and
    its gradients, accumulated into ``W``'s leaves over blocks of ``block``
    rows. ``batch``: tensors on the weights' device."""
    n = (batch["labels"] != -1).sum().clamp_min(1)
    rows = batch["labels"].shape[0]
    total = 0.0
    for s in range(0, rows, block):
        sl = slice(s, s + block)
        t = {key: v[sl] for key, v in batch.items()}
        loss = _forward_sum(cfg, W, t, [m[sl] for m in keep], p, prec) / n
        loss.backward()
        total += float(loss.detach())
    return total
