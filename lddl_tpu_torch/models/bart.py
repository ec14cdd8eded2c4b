"""BART-style encoder-decoder for denoising pretraining in PyTorch.

Counterpart of ``lddl_tpu/models/bart.py`` (``BartConfig`` with the
``bart_base``/``tiny`` presets, ``Embeddings``, ``causal_bias``,
``EncoderLayer``, ``DecoderLayer``, ``BartForPreTraining``,
``bart_batch_loss``): post-LN layers, LayerNorm eps 1e-5, learned
positions, one token table shared by the encoder and decoder inputs, bf16
activations over fp32 params and an fp32 ``lm_head``. The encoder's
bidirectional self-attention reaches the attention kernels through
``attention_impl``; the decoder's causal self-attention and the
cross-attention stay dense, as in the reference. Submodules carry the
reference's param-tree names, so ``models.convert`` maps one tree onto
the other name for name. Under the sharding plan (``models.sharding``)
BART takes BERT's: every projection is tensor-parallel as in BERT, the
decoder's causal self-attention and the cross-attention stay dense, and
under sp both stacks run sequence-sharded, gathered before the LM head.
"""

import dataclasses

import torch
from torch import nn

from ..ops.flash_attention import NEG_BIG
from ..parallel.mesh import get_abstract_mesh
from .attention import (Dense, FeedForward, MultiHeadAttention, gather_seq,
                        seq_chunk)
from .bert import Embed, LayerNorm, run_layer
from .sharding import data_sum, token_cross_entropy


@dataclasses.dataclass(frozen=True)
class BartConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_encoder_layers: int = 6
    num_decoder_layers: int = 6
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 1024
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    layer_norm_eps: float = 1e-5
    initializer_range: float = 0.02
    dtype: torch.dtype = torch.bfloat16  # activations; params stay fp32
    # "auto"/"flash" engage the kernels for the ENCODER's self-attention
    # only; see models.attention.resolve_auto_impl for the auto rule.
    # "ring" puts it on the sp ring under a mesh with sp > 1.
    attention_impl: str = "auto"
    # Recompute each encoder and decoder layer in the backward
    # (torch.utils.checkpoint; dropout draws the same masks).
    remat: bool = False

    def __post_init__(self):
        if self.attention_impl not in ("auto", "dense", "flash", "ring"):
            raise ValueError("attention_impl must be auto|dense|flash|ring")

    @staticmethod
    def bart_base(**kw):
        return BartConfig(**kw)

    @staticmethod
    def tiny(**kw):
        """For tests."""
        kw.setdefault("vocab_size", 512)
        kw.setdefault("hidden_size", 64)
        kw.setdefault("num_encoder_layers", 2)
        kw.setdefault("num_decoder_layers", 2)
        kw.setdefault("num_heads", 4)
        kw.setdefault("intermediate_size", 128)
        kw.setdefault("max_position_embeddings", 128)
        return BartConfig(**kw)


def _attention(cfg):
    return MultiHeadAttention(
        cfg.hidden_size, cfg.num_heads, dtype=cfg.dtype,
        dropout=cfg.attention_dropout,
        initializer_range=cfg.initializer_range,
        attention_impl=cfg.attention_impl)


def _feed_forward(cfg):
    return FeedForward(cfg.hidden_size, cfg.intermediate_size,
                       dtype=cfg.dtype,
                       initializer_range=cfg.initializer_range)


def _norm(cfg):
    return LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, cfg.dtype)


class Embeddings(nn.Module):
    """Token embedding (the shared table, passed in so that it is
    registered once, on the top module) + learned positions, LayerNorm,
    dropout."""

    def __init__(self, cfg):
        super().__init__()
        self.positions = Embed(cfg.max_position_embeddings, cfg.hidden_size,
                               cfg.dtype, cfg.initializer_range)
        self.layer_norm = _norm(cfg)
        self.dropout = nn.Dropout(cfg.hidden_dropout)

    def forward(self, token_embed, input_ids, positions):
        x = token_embed(input_ids) + self.positions(positions)
        return self.dropout(self.layer_norm(x))


def causal_bias(length, device=None):
    """[1, 1, L, L] additive causal mask (finite -1e9, fp32)."""
    tri = torch.ones((length, length), dtype=torch.bool,
                     device=device).tril()
    return torch.where(tri, 0.0, NEG_BIG)[None, None]


class EncoderLayer(nn.Module):

    def __init__(self, cfg):
        super().__init__()
        self.self_attention = _attention(cfg)
        self.self_norm = _norm(cfg)
        self.ffn = _feed_forward(cfg)
        self.ffn_norm = _norm(cfg)
        self.dropout = nn.Dropout(cfg.hidden_dropout)

    def forward(self, x, padding_mask):
        a = self.dropout(self.self_attention(x, x, padding_mask))
        x = self.self_norm(x + a)
        h = self.dropout(self.ffn(x))
        return self.ffn_norm(x + h)


class DecoderLayer(nn.Module):

    def __init__(self, cfg):
        super().__init__()
        self.self_attention = _attention(cfg)
        self.self_norm = _norm(cfg)
        self.cross_attention = _attention(cfg)
        self.cross_norm = _norm(cfg)
        self.ffn = _feed_forward(cfg)
        self.ffn_norm = _norm(cfg)
        self.dropout = nn.Dropout(cfg.hidden_dropout)

    def forward(self, x, enc, self_bias, enc_padding_mask):
        # The extra bias keeps the causal self-attention on the dense path.
        a = self.dropout(self.self_attention(x, x, None,
                                             extra_bias=self_bias))
        x = self.self_norm(x + a)
        c = self.dropout(self.cross_attention(x, enc, enc_padding_mask))
        x = self.cross_norm(x + c)
        h = self.dropout(self.ffn(x))
        return self.ffn_norm(x + h)


class BartForPreTraining(nn.Module):
    """Encoder-decoder + LM head over the decoder states.

    Consumes the BART loader's batch positionally (see ``BATCH_INPUTS``);
    returns fp32 logits [B, L_dec, vocab]. Dropout follows
    ``train()``/``eval()``."""

    BATCH_INPUTS = ("input_ids", "attention_mask", "decoder_input_ids")
    # Logical axes (in, out) of the head's kernel (see MultiHeadAttention).
    LOGICAL_AXES = {"lm_head": ("embed", "vocab")}

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        self.shared_embeddings = Embed(cfg.vocab_size, cfg.hidden_size,
                                       cfg.dtype, cfg.initializer_range)
        self.encoder_embed = Embeddings(cfg)
        for i in range(cfg.num_encoder_layers):
            setattr(self, "encoder_{}".format(i), EncoderLayer(cfg))
        self.decoder_embed = Embeddings(cfg)
        for i in range(cfg.num_decoder_layers):
            setattr(self, "decoder_{}".format(i), DecoderLayer(cfg))
        self.lm_head = Dense(cfg.hidden_size, cfg.vocab_size, torch.float32,
                             cfg.initializer_range)

    def forward(self, input_ids, attention_mask, decoder_input_ids):
        mesh = get_abstract_mesh()

        def embed(module, ids):
            positions = torch.arange(ids.shape[1], device=ids.device)[None]
            return module(self.shared_embeddings, seq_chunk(ids, mesh),
                          seq_chunk(positions, mesh))

        x = embed(self.encoder_embed, input_ids)
        for i in range(self.cfg.num_encoder_layers):
            x = run_layer(getattr(self, "encoder_{}".format(i)),
                          self.cfg.remat, x, attention_mask)
        self_bias = causal_bias(decoder_input_ids.shape[1],
                                decoder_input_ids.device)
        y = embed(self.decoder_embed, decoder_input_ids)
        for i in range(self.cfg.num_decoder_layers):
            y = run_layer(getattr(self, "decoder_{}".format(i)),
                          self.cfg.remat, y, x, self_bias, attention_mask)
        return self.lm_head(gather_seq(y, mesh))


def bart_batch_loss(logits, batch, ignore_index=-1):
    """Denoising cross entropy over the clean labels (``ignore_index`` on
    padding) -> (loss, metrics). The batch-loss adapter for
    ``models.train.make_train_step``. Under a mesh the denominator is the
    global batch's, the loss this rank's share and the metrics global
    (as ``train.pretrain_loss``)."""
    labels = batch["labels"]
    mask = labels != ignore_index
    safe = torch.where(mask, labels, 0).long()
    ll, pred = token_cross_entropy(logits, safe)
    denom, = (c.clamp_min(1) for c in data_sum(mask.sum()))
    loss = torch.where(mask, ll, 0.0).sum() / denom
    total, = data_sum(loss)
    correct, = data_sum((mask & (pred == safe)).sum())
    return loss, {"loss": total, "accuracy": correct / denom}
