"""Multi-head self-attention and the transformer MLP of the model stack.

Counterpart of ``lddl_tpu/models/attention.py`` (``resolve_auto_impl``,
``MultiHeadAttention``, ``FeedForward``) with PyTorch modules. Parameters
are fp32 and activations run in ``dtype`` (bf16 in training), as flax's
``nn.Dense(dtype=...)`` does: inputs and weights are cast to ``dtype``
before each product.

The dense path keeps the finite -1e9 bias (a dtype-min bias overflows to
-inf in bf16 and turns an all-masked row into NaN). The flash path calls
the port's single-block kernels (``ops.flash_attention``).
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.flash_attention import flash_attention, single_block_serves


def resolve_auto_impl(seq_len, blockwise_ok, attention_dropout,
                      deterministic=False, *, head_dim):
    """attention_impl="auto" -> "flash" | "dense". Flash only where it
    computes the same math as dense (attention-prob dropout is skipped by
    the kernels, so an effective dropout > 0 pins dense) and where the
    single-block kernels serve the shape (L_pad 256 up to their bound;
    dense keeps L_pad 128). Those L boundaries were measured on a TPU; the
    port keeps them until H100 measurements set its own."""
    effective_dropout = 0.0 if deterministic else attention_dropout
    return ("flash" if blockwise_ok and effective_dropout == 0.0
            and single_block_serves(seq_len, head_dim) else "dense")


class Dense(nn.Linear):
    """``nn.Linear`` whose product runs in ``dtype`` over fp32 params,
    weights initialized N(0, initializer_range) and biases 0."""

    def __init__(self, in_features, out_features, dtype=torch.bfloat16,
                 initializer_range=0.02):
        super().__init__(in_features, out_features)
        self.dtype = dtype
        nn.init.normal_(self.weight, std=initializer_range)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                        self.bias.to(self.dtype))


class MultiHeadAttention(nn.Module):
    """softmax(Q K^T / sqrt(d) + bias) V over a [B, L, hidden] input.

    ``padding_mask``: [B, L] key validity (1 = attend). Children are named
    query/key/value/output, as in the reference's param tree."""

    def __init__(self, hidden_size, num_heads, dtype=torch.bfloat16,
                 dropout=0.0, initializer_range=0.02, attention_impl="dense"):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_heads = num_heads
        self.head_dim = hidden_size // num_heads
        self.dtype = dtype
        self.dropout = dropout
        self.attention_impl = attention_impl
        for name in ("query", "key", "value", "output"):
            setattr(self, name, Dense(hidden_size, hidden_size, dtype,
                                      initializer_range))
        self.probs_dropout = nn.Dropout(dropout)

    def forward(self, x, padding_mask):
        b, l, _ = x.shape
        impl = self.attention_impl
        if impl == "auto":
            impl = resolve_auto_impl(l, padding_mask is not None,
                                     self.dropout, not self.training,
                                     head_dim=self.head_dim)

        def split_heads(t):
            return t.reshape(b, l, self.num_heads, self.head_dim)

        q = split_heads(self.query(x))
        k = split_heads(self.key(x))
        v = split_heads(self.value(x))
        if impl == "flash" and padding_mask is not None:
            # Attention-prob dropout is skipped, as in the reference.
            ctx = flash_attention(q, k, v, padding_mask)
        else:
            scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(
                self.head_dim)
            if padding_mask is not None:
                bias = torch.where(padding_mask[:, None, None, :] > 0, 0.0,
                                   -1e9).to(self.dtype)
                scores = scores + bias
            probs = torch.softmax(scores.float(), dim=-1).to(self.dtype)
            probs = self.probs_dropout(probs)
            ctx = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        return self.output(ctx.reshape(b, l, self.hidden_size))


class FeedForward(nn.Module):
    """Expand (tanh-approximate GELU) + contract; children
    intermediate/output."""

    def __init__(self, hidden_size, intermediate_size, dtype=torch.bfloat16,
                 initializer_range=0.02):
        super().__init__()
        self.intermediate = Dense(hidden_size, intermediate_size, dtype,
                                  initializer_range)
        self.output = Dense(intermediate_size, hidden_size, dtype,
                            initializer_range)

    def forward(self, x):
        return self.output(F.gelu(self.intermediate(x), approximate="tanh"))
