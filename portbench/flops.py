"""The yardstick's arithmetic: the card's peaks, the least time a piece of
work needs on it, the model FLOPs of a train step and the work of each
attention kernel launch.

Peaks and ``bound`` are frozen copies of ``chip_smoke.py``'s; the kernel
formulas follow its single-block and online rows, counted at the work the
inputs need (valid query rows against valid keys, each valid input byte
read once and each output byte written once), so that no share of a
roofline can pass 100% by counting padding the kernel may skip.
"""

import math

# NVIDIA H100 SXM data sheet, dense, at its 700 W limit.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12


def bound_s(nbytes, flops, peak=PEAK_BF16_FLOPS):
    """The least time (s) the card needs for the work, and what sets it."""
    tb = nbytes / PEAK_BYTES_PER_S
    tf = flops / peak
    return max(tb, tf), ("bytes" if tb >= tf else "operations")


def _dense(tokens, n_in, n_out):
    return 2.0 * tokens * n_in * n_out


def bert_step_flops(cfg, batch, seq_len, masked):
    """Model FLOPs of one BERT pretraining step (forward and backward, 3x
    the forward; nothing recomputed) at the padded shape [batch, seq_len]
    the step ran: each encoder layer's four projections and MLP, attention's
    two products at the padded length, the MLM head at the ``masked``
    positions (the labels) and the pooler and NSP head at the [CLS] rows.
    Embedding lookups are not products and are not counted."""
    h, i = cfg["hidden_size"], cfg["intermediate_size"]
    t = batch * seq_len
    layer = (4 * _dense(t, h, h) + 2 * _dense(t, h, i)
             + 2 * 2.0 * batch * seq_len * seq_len * h)
    heads = (_dense(masked, h, h) + _dense(masked, h, cfg["vocab_size"])
             + _dense(batch, h, h) + _dense(batch, h, 2))
    return 3.0 * (cfg["num_hidden_layers"] * layer + heads)


def bart_step_flops(cfg, batch, enc_len, dec_len):
    """Model FLOPs of one BART denoising step (3x the forward) at the padded
    shapes: the encoder layers (projections, MLP, bidirectional attention),
    the decoder layers (causal self-attention counted over the full square,
    as the model computes it, cross-attention over the encoder length, MLP)
    and the LM head at every decoder position."""
    h, i, v = cfg["d_model"], cfg["encoder_ffn_dim"], cfg["vocab_size"]
    te, td = batch * enc_len, batch * dec_len
    enc = (4 * _dense(te, h, h) + 2 * _dense(te, h, i)
           + 2 * 2.0 * batch * enc_len * enc_len * h)
    dec = (4 * _dense(td, h, h) + 2 * _dense(td, h, h) + 2 * _dense(te, h, h)
           + 2 * _dense(td, h, cfg["decoder_ffn_dim"])
           + 2 * 2.0 * batch * dec_len * dec_len * h
           + 2 * 2.0 * batch * dec_len * enc_len * h)
    return 3.0 * (cfg["encoder_layers"] * enc + cfg["decoder_layers"] * dec
                  + _dense(td, h, v))


# Tensors of [valid tokens x heads x head_dim] in bf16 each kernel reads
# and writes, and fp32 rows (LSE, delta) of [valid tokens x heads]; matrix
# products of [valid x valid x head_dim] (forward 2: S and P V; dQ 3: S, dP,
# dS K; dK/dV 4: S, dP, dS^T Q, P^T dO; the single-block backward is dK/dV
# then dQ over the same operands, 5 products).
KERNEL_WORK = {
    "onekv_fwd": (4, 1, 2),
    "onekv_bwd": (7, 2, 5),
    "online_fwd": (4, 1, 2),
    "online_bwd_dq": (5, 2, 3),
    "online_bwd_dkv": (6, 2, 4),
}


def kernel_work(kernel, lens, heads, head_dim):
    """(bytes, FLOP) one launch of ``kernel`` needs for rows of valid
    lengths ``lens`` (the key-padding mask's sums): every valid query
    against every valid key of its row, the two int32 masks read once."""
    n_tensors, n_rows, n_products = KERNEL_WORK[kernel]
    tokens = float(sum(lens))
    pairs = float(sum(int(x) * int(x) for x in lens))
    nbytes = (n_tensors * tokens * heads * head_dim * 2
              + n_rows * tokens * heads * 4 + 2 * tokens * 4)
    flops = n_products * 2.0 * pairs * heads * head_dim
    return nbytes, flops


def p95(values):
    """The 95th percentile (linear between order statistics)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = 0.95 * (len(xs) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)
