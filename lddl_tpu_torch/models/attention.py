"""Multi-head attention and the transformer MLP of the model stack.

Counterpart of ``lddl_tpu/models/attention.py`` (``resolve_auto_impl``,
``MultiHeadAttention``, ``FeedForward``) with PyTorch modules: one
attention serves BERT's self-attention and BART's encoder and decoder
self-attention and cross-attention. Parameters are fp32 and activations
run in ``dtype`` (bf16 in training), as flax's ``nn.Dense(dtype=...)``
does: inputs and weights are cast to ``dtype`` before each product.

The dense path keeps the finite -1e9 bias (a dtype-min bias overflows to
-inf in bf16 and turns an all-masked row into NaN) and rounds its softmax
where the reference's does (``softmax``). The flash path calls the port's
attention kernels (``ops.flash_attention``), built for bf16 and fp32
activations: the single-block ones up to their bound, the online-softmax
ones from L_pad 1024.

Under the sharding plan (``models.sharding``) the ambient mesh
(``parallel.mesh.set_mesh``) decides the sharded paths:

- tp: Q/K/V and the MLP's expansion are column-parallel, the output
  projections row-parallel, so each rank holds ``H/tp`` local heads;
  attention-probability dropout draws the mask of all H heads and keeps
  the rank's own, so tp ranks never share a mask pattern.
- sp (Megatron-SP): activations between the attention cores are
  sequence-sharded; Q/K/V are gathered over sp into full-sequence
  attention and the context is scattered back to the rank's chunk
  (``gather_seq``, whose backward sums the chunks' partial gradients).
- ``attention_impl == "ring"`` with sp > 1: Q stays sharded and K/V
  rotate over the sp ring (``ops.ring_attention``); packed ``segments``
  raise there.

The kernels only ever see plain local tensors, never a ``DTensor``.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor

from ..ops.flash_attention import (NEG_BIG, flash_attention, pad_seq_len,
                                   single_block_serves)
from ..parallel.mesh import (AXIS_SP, AXIS_TP, axis_rank, axis_size,
                             get_abstract_mesh)


class _GatherSeq(torch.autograd.Function):
    """All-gather along ``dim`` over a process group; the backward
    reduce-scatters (sums) the gradient back to the local chunk."""

    @staticmethod
    def forward(ctx, x, group, dim):
        import torch.distributed as dist
        ctx.group, ctx.dim = group, dim
        n = dist.get_world_size(group)
        xs = x.movedim(dim, 0).contiguous()
        out = xs.new_empty((n * xs.shape[0],) + xs.shape[1:])
        dist.all_gather_into_tensor(out, xs, group=group)
        return out.movedim(0, dim)

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist
        n = dist.get_world_size(ctx.group)
        gs = grad.movedim(ctx.dim, 0).contiguous()
        out = gs.new_empty((gs.shape[0] // n,) + gs.shape[1:])
        dist.reduce_scatter_tensor(out, gs, group=ctx.group)
        return out.movedim(0, ctx.dim), None, None


def seq_chunk(x, mesh, dim=1):
    """This rank's chunk of ``x`` along the sequence ``dim`` under the
    mesh's sp axis (``x`` itself without one)."""
    sp = axis_size(mesh, AXIS_SP)
    if sp == 1:
        return x
    if x.shape[dim] % sp:
        raise ValueError("sequence length {} is not a multiple of sp={}"
                         .format(x.shape[dim], sp))
    return x.chunk(sp, dim)[axis_rank(mesh, AXIS_SP)]


def gather_seq(x, mesh, dim=1):
    """The full sequence from every sp rank's chunk of ``x`` (``x``
    itself without an sp axis). Differentiable: the backward sums each
    rank's partial gradient and keeps the rank's own chunk."""
    if axis_size(mesh, AXIS_SP) == 1:
        return x
    return _GatherSeq.apply(x, mesh[AXIS_SP].get_group(), dim)


def resolve_auto_impl(seq_len, blockwise_ok, attention_dropout,
                      deterministic=False, *, head_dim):
    """attention_impl="auto" -> "flash" | "dense". Flash only where it
    computes the same math as dense (attention-prob dropout is skipped by
    the kernels, so an effective dropout > 0 pins dense) and where the
    kernels serve the shape: the single-block ones from L_pad 256 up to
    their bound, the online ones from L_pad 1024 (dense keeps L_pad 128,
    and 640-896 at head_dim 128). Those L boundaries were measured on a
    TPU; the port keeps them until H100 measurements set its own."""
    effective_dropout = 0.0 if deterministic else attention_dropout
    return ("flash" if blockwise_ok and effective_dropout == 0.0
            and (single_block_serves(seq_len, head_dim)
                 or pad_seq_len(seq_len) >= 1024) else "dense")


class _Softmax(torch.autograd.Function):
    """Softmax over the last dim, rounded where the reference's
    ``nn.softmax`` (``jax.nn.softmax``) rounds: x - max, its exp, their
    sum and the quotient each round to the input dtype (the sum
    accumulates in fp32 on both sides). The backward is torch.softmax's
    fused one, y (g - sum(g y)) from the saved output alone (one pass, so
    no copy of the probabilities in another dtype is kept); like the
    port's before, it is not bit-equal to flax's."""

    @staticmethod
    def forward(ctx, x):
        e = torch.exp(x - x.amax(dim=-1, keepdim=True))
        y = e / e.sum(dim=-1, keepdim=True)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        y, = ctx.saved_tensors
        return torch.ops.aten._softmax_backward_data(g, y, -1, y.dtype)


def softmax(x):
    """The dense path's softmax over the last dim of ``x``, in x's dtype,
    bit-identical to flax's ``nn.softmax`` at bf16 on the CPU."""
    return _Softmax.apply(x)


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
    """softmax(Q K^T / sqrt(d) + bias) V: queries from ``q_input`` [B, Lq,
    hidden], keys and values from ``kv_input`` [B, Lk, hidden] (the same
    tensor for self-attention).

    ``padding_mask``: [B, Lk] key validity (1 = attend), or None.
    ``extra_bias``: an optional additive [*, Lq, Lk] term (e.g. causal).
    ``segments``: [B, L] per-token segment ids of packed rows (0 = pad),
    or None: a query then attends only keys of its own segment
    (block-diagonal), which subsumes the padding mask.
    Only bidirectional self-attention with a padding mask and no extra
    bias may take the kernels; causal and cross calls stay dense. Children
    are named query/key/value/output, as in the reference's param tree."""

    # Logical axes (in, out) of each child's kernel, as the reference
    # annotates them; models.sharding maps them onto the mesh.
    LOGICAL_AXES = {"query": ("embed", "heads"), "key": ("embed", "heads"),
                    "value": ("embed", "heads"), "output": ("heads", "embed")}

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

    def forward(self, q_input, kv_input, padding_mask, extra_bias=None,
                segments=None):
        mesh = get_abstract_mesh()
        sp = axis_size(mesh, AXIS_SP)
        b, l_local, _ = q_input.shape
        blockwise_ok = (q_input is kv_input and extra_bias is None
                        and padding_mask is not None)
        impl = self.attention_impl
        use_ring = impl == "ring" and blockwise_ok and sp > 1
        if segments is not None and use_ring:
            # Packing serves short samples, ring long sequences: fail
            # rather than attend across packed samples.
            raise NotImplementedError(
                "packed sequences (segments) are not supported with ring "
                "attention; use attention_impl='flash' or 'dense'")
        if impl == "auto":
            impl = resolve_auto_impl(l_local * sp, blockwise_ok,
                                     self.dropout, not self.training,
                                     head_dim=self.head_dim)

        def split_heads(t):
            # Local heads: H/tp under a column-parallel projection.
            return t.reshape(t.shape[0], t.shape[1], -1, self.head_dim)

        q = split_heads(self.query(q_input))
        k = split_heads(self.key(kv_input))
        v = split_heads(self.value(kv_input))
        if use_ring:
            from ..ops.ring_attention import ring_attention
            ctx = ring_attention(q, k, v, seq_chunk(padding_mask, mesh),
                                 mesh[AXIS_SP].get_group())
        else:
            q, k, v = (gather_seq(t, mesh) for t in (q, k, v))
            if impl == "flash" and blockwise_ok:
                if any(isinstance(t, DTensor) for t in (q, k, v)):
                    raise TypeError("a DTensor reached the attention "
                                    "kernels; they take local tensors")
                # Attention-prob dropout is skipped, as in the reference.
                # Packed rows hand the kernels their segment ids as both
                # masks.
                if segments is not None:
                    ctx = flash_attention(q, k, v, segments=segments)
                else:
                    ctx = flash_attention(q, k, v, padding_mask)
            else:
                ctx = self._dense(q, k, v, padding_mask, extra_bias,
                                  segments, mesh)
            ctx = seq_chunk(ctx, mesh)
        return self.output(ctx.reshape(b, l_local, -1))

    def _dense(self, q, k, v, padding_mask, extra_bias, segments, mesh):
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(
            self.head_dim)
        bias = None
        if segments is not None:
            # Block-diagonal: same-segment keys that are not padding.
            allowed = ((segments[:, None, :, None]
                        == segments[:, None, None, :])
                       & (segments[:, None, None, :] > 0))
            bias = torch.where(allowed, 0.0, NEG_BIG)
        elif padding_mask is not None:
            bias = torch.where(padding_mask[:, None, None, :] > 0, 0.0,
                               NEG_BIG)
        if extra_bias is not None:
            bias = extra_bias if bias is None else bias + extra_bias
        if bias is not None:
            scores = scores + bias.to(self.dtype)
        # In self.dtype, rounded as the reference's nn.softmax rounds.
        probs = softmax(scores)
        tp = axis_size(mesh, AXIS_TP)
        if self.training and self.dropout > 0 and tp > 1:
            # Draw all H heads' mask and keep this rank's heads: tp ranks
            # share a dropout seed, and their heads must not share masks.
            h = probs.shape[1]
            keep = torch.rand(probs.shape[:1] + (h * tp,) + probs.shape[2:],
                              device=probs.device) >= self.dropout
            keep = keep[:, axis_rank(mesh, AXIS_TP) * h:][:, :h]
            probs = probs * keep / (1.0 - self.dropout)
        else:
            probs = self.probs_dropout(probs)
        return torch.einsum("bhqk,bkhd->bqhd", probs, v)


class FeedForward(nn.Module):
    """Expand (tanh-approximate GELU) + contract; children
    intermediate/output."""

    LOGICAL_AXES = {"intermediate": ("embed", "mlp"),
                    "output": ("mlp", "embed")}

    def __init__(self, hidden_size, intermediate_size, dtype=torch.bfloat16,
                 initializer_range=0.02):
        super().__init__()
        self.intermediate = Dense(hidden_size, intermediate_size, dtype,
                                  initializer_range)
        self.output = Dense(intermediate_size, hidden_size, dtype,
                            initializer_range)

    def forward(self, x):
        return self.output(F.gelu(self.intermediate(x), approximate="tanh"))
