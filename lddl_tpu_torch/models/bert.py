"""BERT for pretraining (MLM + NSP) in PyTorch.

Counterpart of ``lddl_tpu/models/bert.py`` (``BertConfig`` with the
``bert_base``/``bert_large``/``tiny`` presets, ``Embeddings``,
``EncoderLayer``, ``BertForPreTraining``): post-LN encoder layers,
LayerNorm eps 1e-12, tanh-approximate GELU, bf16 activations over fp32
params, and the MLM head optionally run only at ``masked_positions`` (the
train step's gathered head: loss and gradients equal the full head's).
Packed rows (several samples per row) pass ``segments``, ``position_ids``
and ``cls_positions``; ``BertForPreTrainingPacked`` names them in its
``BATCH_INPUTS``. ``remat`` recomputes each encoder layer in the backward
(``torch.utils.checkpoint``). Submodules carry the reference's param-tree names (``embeddings``,
``layer_<i>``, ``attention``, ``ffn``, ``mlm_transform``, ...), so
``models.convert`` maps one tree onto the other name for name.

Under an ambient mesh with sp > 1 (the sharded steps), the embeddings and
the encoder layers run on this rank's chunk of the sequence (Megatron-SP,
``models.attention``), and the hidden states are gathered over sp before
the heads, whose MLM gather and [CLS] states index the full sequence.
"""

import contextlib
import dataclasses

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from ..parallel.mesh import get_abstract_mesh, set_mesh
from .attention import (Dense, FeedForward, MultiHeadAttention, gather_seq,
                        seq_chunk)


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    layer_norm_eps: float = 1e-12
    initializer_range: float = 0.02
    dtype: torch.dtype = torch.bfloat16  # activations; params stay fp32
    # "auto": dense at the shortest bins, the single-block kernels from
    # L_pad 256 when attention_dropout is 0 (see resolve_auto_impl).
    # "dense" or "flash" force one path. "ring": K/V rotate over the sp
    # ring under a mesh with sp > 1 (dense otherwise).
    attention_impl: str = "auto"
    # Recompute each encoder layer in the backward instead of keeping its
    # activations (torch.utils.checkpoint; dropout draws the same masks).
    remat: bool = False
    # Run the MLM head only at the masked positions in the train and eval
    # steps (a static cap P per row, see train.mlm_gather_cap); labels past
    # the cap are dropped and counted. False gives the full head.
    mlm_gather: bool = True

    def __post_init__(self):
        if self.attention_impl not in ("auto", "dense", "flash", "ring"):
            raise ValueError("attention_impl must be auto|dense|flash|ring")

    @staticmethod
    def bert_base(**kw):
        return BertConfig(**kw)

    @staticmethod
    def bert_large(**kw):
        kw.setdefault("hidden_size", 1024)
        kw.setdefault("num_layers", 24)
        kw.setdefault("num_heads", 16)
        kw.setdefault("intermediate_size", 4096)
        return BertConfig(**kw)

    @staticmethod
    def tiny(**kw):
        """For tests."""
        kw.setdefault("vocab_size", 512)
        kw.setdefault("hidden_size", 64)
        kw.setdefault("num_layers", 2)
        kw.setdefault("num_heads", 4)
        kw.setdefault("intermediate_size", 128)
        kw.setdefault("max_position_embeddings", 128)
        return BertConfig(**kw)


# Tables of at most this many rows (the token types) look up by a one-hot
# product: the CUDA gather's backward sums each row's thousands of
# repeats in a varying order, so two identical steps differed in the last
# bits; the product's backward is a matmul, deterministic, and its
# forward returns the rows exactly.
ONE_HOT_ROWS = 16


class Embed(nn.Embedding):
    """Lookup table (fp32) whose rows are returned in ``dtype``."""

    def __init__(self, num, features, dtype, initializer_range):
        super().__init__(num, features)
        self.dtype = dtype
        nn.init.normal_(self.weight, std=initializer_range)

    def forward(self, ids):
        if self.num_embeddings <= ONE_HOT_ROWS:
            one_hot = F.one_hot(ids.long(), self.num_embeddings)
            return (one_hot.to(self.weight.dtype) @ self.weight).to(
                self.dtype)
        return F.embedding(ids, self.weight).to(self.dtype)


class LayerNorm(nn.LayerNorm):
    """LayerNorm computed in fp32 and returned in ``dtype``."""

    def __init__(self, features, eps, dtype):
        super().__init__(features, eps=eps)
        self.dtype = dtype

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(self.dtype)


class Embeddings(nn.Module):

    def __init__(self, cfg):
        super().__init__()
        init = cfg.initializer_range
        self.word_embeddings = Embed(cfg.vocab_size, cfg.hidden_size,
                                     cfg.dtype, init)
        self.position_embeddings = Embed(cfg.max_position_embeddings,
                                         cfg.hidden_size, cfg.dtype, init)
        self.token_type_embeddings = Embed(cfg.type_vocab_size,
                                           cfg.hidden_size, cfg.dtype, init)
        self.layer_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps,
                                    cfg.dtype)
        self.dropout = nn.Dropout(cfg.hidden_dropout)

    def forward(self, input_ids, token_type_ids, position_ids=None):
        if position_ids is None:
            position_ids = torch.arange(input_ids.shape[1],
                                        device=input_ids.device)[None, :]
        x = (self.word_embeddings(input_ids)
             + self.position_embeddings(position_ids)
             + self.token_type_embeddings(token_type_ids))
        return self.dropout(self.layer_norm(x))


class EncoderLayer(nn.Module):

    def __init__(self, cfg):
        super().__init__()
        self.attention = MultiHeadAttention(
            cfg.hidden_size, cfg.num_heads, dtype=cfg.dtype,
            dropout=cfg.attention_dropout,
            initializer_range=cfg.initializer_range,
            attention_impl=cfg.attention_impl)
        self.attention_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps,
                                        cfg.dtype)
        self.ffn = FeedForward(cfg.hidden_size, cfg.intermediate_size,
                               dtype=cfg.dtype,
                               initializer_range=cfg.initializer_range)
        self.ffn_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps,
                                  cfg.dtype)
        self.dropout = nn.Dropout(cfg.hidden_dropout)

    def forward(self, x, attention_mask, segments=None):
        attn = self.dropout(self.attention(x, x, attention_mask,
                                           segments=segments))
        x = self.attention_norm(x + attn)
        h = self.dropout(self.ffn(x))
        return self.ffn_norm(x + h)


def run_layer(layer, remat, *args):
    """``layer(*args)``, recomputed in the backward when ``remat`` and
    autograd is recording (``use_reentrant=False`` stashes and restores
    the RNG state, so dropout draws the same masks again; the ambient
    mesh is entered again for the recomputation, which may run on the
    autograd engine's own thread)."""
    if remat and torch.is_grad_enabled():
        mesh = get_abstract_mesh()
        return torch.utils.checkpoint.checkpoint(
            layer, *args, use_reentrant=False,
            context_fn=lambda: (contextlib.nullcontext(), set_mesh(mesh)))
    return layer(*args)


class BertForPreTraining(nn.Module):
    """Encoder + MLM head + NSP head.

    Returns (mlm_logits [B, L, vocab], nsp_logits [B, 2]) in fp32; with
    ``masked_positions`` [B, P] the MLM head runs only at those columns
    (mlm_logits [B, P, vocab]). Dropout follows ``train()``/``eval()``.

    Packed rows: ``segments`` [B, L] (per-token pack slot, 0 = pad; the
    attention becomes block-diagonal), ``position_ids`` [B, L] (restarting
    at each sample) and ``cls_positions`` [B, P] (each sample's [CLS]
    column); nsp_logits is then [B, P, 2]. The params are the same either
    way."""

    BATCH_INPUTS = ("input_ids", "token_type_ids", "attention_mask")
    # Logical axes (in, out) of the heads' kernels (see MultiHeadAttention).
    LOGICAL_AXES = {"mlm_transform": ("embed", "embed_out"),
                    "mlm_decoder": ("embed", "vocab"),
                    "pooler": ("embed", "embed_out"),
                    "nsp_classifier": ("embed", None)}

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        init = cfg.initializer_range
        self.embeddings = Embeddings(cfg)
        for i in range(cfg.num_layers):
            setattr(self, "layer_{}".format(i), EncoderLayer(cfg))
        self.mlm_transform = Dense(cfg.hidden_size, cfg.hidden_size,
                                   cfg.dtype, init)
        self.mlm_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps,
                                  cfg.dtype)
        self.mlm_decoder = Dense(cfg.hidden_size, cfg.vocab_size,
                                 torch.float32, init)
        self.pooler = Dense(cfg.hidden_size, cfg.hidden_size, cfg.dtype,
                            init)
        self.nsp_classifier = Dense(cfg.hidden_size, 2, torch.float32, init)

    def forward(self, input_ids, token_type_ids, attention_mask,
                segments=None, position_ids=None, cls_positions=None,
                masked_positions=None):
        mesh = get_abstract_mesh()
        if position_ids is None:
            position_ids = torch.arange(input_ids.shape[1],
                                        device=input_ids.device)[None, :]
        x = self.embeddings(seq_chunk(input_ids, mesh),
                            seq_chunk(token_type_ids, mesh),
                            seq_chunk(position_ids, mesh))
        for i in range(self.cfg.num_layers):
            x = run_layer(getattr(self, "layer_{}".format(i)),
                          self.cfg.remat, x, attention_mask, segments)
        x = gather_seq(x, mesh)
        xm = x
        if masked_positions is not None:
            idx = masked_positions.long()[:, :, None].expand(
                -1, -1, x.shape[-1])
            xm = torch.gather(x, 1, idx)
        h = F.gelu(self.mlm_transform(xm), approximate="tanh")
        mlm_logits = self.mlm_decoder(self.mlm_norm(h))
        if cls_positions is None:
            cls_states = x[:, 0]                                # [B, H]
        else:
            idx = cls_positions.long()[:, :, None].expand(
                -1, -1, x.shape[-1])
            cls_states = torch.gather(x, 1, idx)                # [B, P, H]
        pooled = torch.tanh(self.pooler(cls_states))
        nsp_logits = self.nsp_classifier(pooled)
        return mlm_logits, nsp_logits


class BertForPreTrainingPacked(BertForPreTraining):
    """BertForPreTraining bound to the packed batch's keys (the same
    params; see the base class)."""

    BATCH_INPUTS = ("input_ids", "token_type_ids", "attention_mask",
                    "segments", "position_ids", "cls_positions")
