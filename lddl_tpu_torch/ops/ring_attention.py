"""Ring attention: exact sequence-parallel attention over the sp group.

Counterpart of ``lddl_tpu/ops/ring_attention.py`` (``ring_attention``,
``dense_attention_reference``). Q stays sequence-sharded and the K/V
blocks and their key mask rotate around the sp ring while an online
softmax accumulates the exact result block by block, so no rank holds
the full sequence: O(L/sp) activations and O(L^2/sp) score work per rank.

The reference differentiates its ``ppermute`` ring for free; torch's
point-to-point ops have no autograd, so the ring is a
``torch.autograd.Function``: the forward saves O and the log-sum-exp, and
the backward runs the ring again, recomputing each block's probabilities
from them, with the dK/dV accumulators travelling with their K/V blocks
(one more hop brings each home).

Semantics match the dense path of ``models.attention``: softmax(Q K^T /
sqrt(D) + bias), bias 0 for valid keys and the finite -1e9 for padding
(an all-padded block must not turn the running max into NaN). Operands
stay in their stored dtype (bf16 in training) and every product
accumulates in fp32, as the reference's ``preferred_element_type``; the
running max and denominator are fp32. Attention-probability dropout is
not applied. The per-block compute is plain torch, as the reference's is
jnp: there is no Pallas kernel here.
"""

import torch

from ..parallel.distributed import rotate
from .flash_attention import NEG_BIG


def _scores(q, k, mask, scale):
    """fp32 scores [B, H, Lq, Lk] of stored-dtype operands with the key
    mask's bias."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    return s + torch.where(mask[:, None, None, :] > 0, 0.0, NEG_BIG)


class _RingAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, group):
        import torch.distributed as dist
        n = dist.get_world_size(group)
        scale = q.shape[-1] ** -0.5
        b, lq, h, d = q.shape
        m = torch.full((b, h, lq), float("-inf"), device=q.device)
        l = torch.zeros((b, h, lq), device=q.device)
        acc = torch.zeros((b, h, lq, d), device=q.device)
        k_blk, v_blk, mask_blk = k, v, kv_mask
        for step in range(n):
            s = _scores(q, k_blk, mask_blk, scale)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p.to(v.dtype).float(), v_blk.float())
            m = m_new
            # The last block's rotation would only be discarded.
            if step < n - 1:
                k_blk, v_blk, mask_blk = rotate([k_blk, v_blk, mask_blk],
                                                 group)
        l = l.clamp_min(1e-30)
        out = (acc / l[..., None]).transpose(1, 2).to(q.dtype)
        ctx.save_for_backward(q, k, v, kv_mask, out, m + l.log())
        ctx.group = group
        return out

    @staticmethod
    def backward(ctx, dout):
        import torch.distributed as dist
        q, k, v, kv_mask, out, lse = ctx.saved_tensors
        group = ctx.group
        n = dist.get_world_size(group)
        scale = q.shape[-1] ** -0.5
        do = dout.float()
        delta = (do * out.float()).sum(dim=-1).transpose(1, 2)  # [B, H, Lq]
        dq = torch.zeros(q.shape, device=q.device)
        k_blk, v_blk, mask_blk = k, v, kv_mask
        dk_blk = torch.zeros(k.shape, device=k.device)
        dv_blk = torch.zeros(v.shape, device=v.device)
        for step in range(n):
            p = torch.exp(_scores(q, k_blk, mask_blk, scale)
                          - lse[..., None])
            dv_blk = dv_blk + torch.einsum("bhqk,bqhd->bkhd", p, do)
            dp = torch.einsum("bqhd,bkhd->bhqk", do, v_blk.float())
            ds = p * (dp - delta[..., None]) * scale
            dq = dq + torch.einsum("bhqk,bkhd->bqhd", ds, k_blk.float())
            dk_blk = dk_blk + torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
            # Each block's gradients travel with it; after the last block
            # one more hop brings them to the block's own rank.
            if step < n - 1:
                k_blk, v_blk, mask_blk, dk_blk, dv_blk = rotate(
                    [k_blk, v_blk, mask_blk, dk_blk, dv_blk], group)
            else:
                dk_blk, dv_blk = rotate([dk_blk, dv_blk], group)
        return (dq.to(q.dtype), dk_blk.to(k.dtype), dv_blk.to(v.dtype),
                None, None)


def ring_attention(q, k, v, kv_mask, group):
    """Exact attention of this rank's query block against the whole
    sequence, held in blocks around the sp ring ``group`` (rank i holds
    block i). q/k/v: [B, L/sp, H, D] local blocks; kv_mask: [B, L/sp]
    (1 = attend). Returns [B, L/sp, H, D] in q's dtype."""
    return _RingAttention.apply(q, k, v, kv_mask, group)


def dense_attention_reference(q, k, v, kv_mask):
    """The unsharded computation ring_attention must reproduce (the bias
    semantics of models.attention), in fp32."""
    scale = q.shape[-1] ** -0.5
    probs = torch.softmax(_scores(q, k, kv_mask, scale), dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype)
