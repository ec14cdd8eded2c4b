"""Pieces the plain references share: weights from a seed, the dropout
masks a step draws, rounding for the lower-precision control, the
layers, and clipped AdamW under the warmup-cosine schedule.

Plain PyTorch in float32 (TF32 off on the card); nothing of the program
is imported. The references follow the program's conventions where the
published models leave a choice: the parameter names and layout of its
state dict, a finite -1e9 attention bias, tanh-approximate GELU, and
dropout masks drawn by ``torch.nn.functional.dropout`` on bf16 tensors
under ``torch.manual_seed(dropout_seed(seed, update))``, site by site in
the order of the forward pass.
"""

import hashlib
import math
import struct

import torch
import torch.nn.functional as F

NEG_BIG = -1e9
INIT_STD = 0.02
_DROPOUT_TAG = 0x1DD1_0D70


def exact_matmuls():
    """float32 products in float32: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def dropout_seed(seed, step):
    """The torch seed of one train step's dropout: the first 8 bytes of the
    blake2b digest of (tag, seed, step), as little-endian uint64s, shifted
    to 63 bits."""
    scope = (_DROPOUT_TAG, seed, step)
    digest = hashlib.blake2b(
        struct.pack("<{}Q".format(len(scope)),
                    *(int(s) % 2**64 for s in scope)),
        digest_size=16).digest()[:8]
    return int.from_bytes(digest, "little") >> 1


def dropout_masks(seed, step, shapes, p, device):
    """Keep-masks (bool) of the dropout sites of one step, drawn as the
    program draws them: bf16 dropout of each site's shape, in order, after
    ``torch.manual_seed(dropout_seed(seed, step))``. The global generators
    are left as they were."""
    devices = [device] if device.type == "cuda" else []
    with torch.random.fork_rng(devices=devices, device_type=device.type):
        torch.manual_seed(dropout_seed(seed, step))
        return [F.dropout(torch.ones(s, dtype=torch.bfloat16, device=device),
                          p, True) != 0 for s in shapes]


def make_weights(specs, seed, device):
    """{name: fp32 tensor} for ``specs`` [(name, shape, init)]: every
    "normal" leaf N(0, 0.02) from one draw of a generator seeded with
    ``seed`` on ``device``, "ones" and "zeros" constant."""
    normal = [(n, s) for n, s, init in specs if init == "normal"]
    total = sum(math.prod(s) for _, s in normal)
    g = torch.Generator(device=device)
    g.manual_seed(seed % 2**63)
    flat = torch.randn(total, generator=g, device=device) * INIT_STD
    out, at = {}, 0
    for name, shape in normal:
        size = math.prod(shape)
        out[name] = flat[at:at + size].view(shape)
        at += size
    for name, shape, init in specs:
        if init == "ones":
            out[name] = torch.ones(shape, device=device)
        elif init == "zeros":
            out[name] = torch.zeros(shape, device=device)
    return {name: out[name] for name, _, _ in specs}


def dense_specs(prefix, n_in, n_out):
    return [(prefix + ".weight", (n_out, n_in), "normal"),
            (prefix + ".bias", (n_out,), "zeros")]


def norm_specs(prefix, n):
    return [(prefix + ".weight", (n,), "ones"), (prefix + ".bias", (n,),
                                                  "zeros")]


class _Round(torch.autograd.Function):
    """A tensor rounded to ``fmt`` (forward) and its gradient rounded to
    ``grad_fmt`` (backward), each scaled per tensor by its largest
    magnitude so that it spans the format, as fp8 training recipes do."""

    @staticmethod
    def forward(ctx, x, fmt, grad_fmt):
        ctx.grad_fmt = grad_fmt
        return _scaled_cast(x, fmt)

    @staticmethod
    def backward(ctx, g):
        return _scaled_cast(g, ctx.grad_fmt), None, None


def _scaled_cast(x, fmt):
    top = torch.finfo(fmt).max
    scale = x.detach().abs().amax().clamp_min(1e-30) / top
    return ((x / scale).clamp(-top, top).to(fmt).to(x.dtype)) * scale


class Precision:
    """Where the program rounds activations and the operands of its
    products to its activation dtype, the reference calls ``round``:
    the identity in float32 (the reference), a scaled cast through
    fp8 e4m3 with e5m2 gradients for the control."""

    def __init__(self, name):
        if name not in ("fp32", "fp8"):
            raise ValueError("precision fp32|fp8, got {}".format(name))
        self.name = name

    def round(self, x):
        if self.name == "fp32":
            return x
        return _Round.apply(x, torch.float8_e4m3fn, torch.float8_e5m2)


def linear(x, w, b, prec):
    """A product in the activation dtype: operands and result rounded."""
    r = prec.round
    return r(F.linear(r(x), r(w), r(b)))


def layer_norm(x, w, b, eps, prec):
    return prec.round(F.layer_norm(x, (x.shape[-1],), w, b, eps))


def gelu(x, prec):
    return prec.round(F.gelu(x, approximate="tanh"))


def drop(x, keep, p, prec):
    return prec.round(x * keep / (1.0 - p))


def attention(q_in, kv_in, W, prefix, heads, prec, key_mask=None,
              causal=False):
    """softmax(Q K^T / sqrt(d) + bias) V with the output projection; bias
    -1e9 on keys whose ``key_mask`` is 0 and, when ``causal``, above the
    diagonal."""
    r = prec.round
    b, lq, hidden = q_in.shape
    lk = kv_in.shape[1]
    d = hidden // heads

    def proj(name, x, n):
        return linear(x, W[prefix + name + ".weight"],
                      W[prefix + name + ".bias"], prec).view(b, n, heads, d)

    q, k, v = proj("query", q_in, lq), proj("key", kv_in, lk), proj(
        "value", kv_in, lk)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(d)
    if key_mask is not None:
        scores = scores + torch.where(key_mask[:, None, None, :] > 0, 0.0,
                                      NEG_BIG)
    if causal:
        tri = torch.ones((lq, lk), dtype=torch.bool,
                         device=q.device).tril()
        scores = scores + torch.where(tri, 0.0, NEG_BIG)
    probs = r(torch.softmax(scores, dim=-1))
    ctx = r(torch.einsum("bhqk,bkhd->bqhd", probs, v)).reshape(b, lq, hidden)
    return linear(ctx, W[prefix + "output.weight"], W[prefix + "output.bias"],
                  prec)


def warmup_cosine(count, peak, warmup, total, end=0.0):
    """The learning rate of update ``count`` (0 for the first)."""
    if warmup > 0 and count < warmup:
        return peak * count / warmup
    decay = max(total, warmup + 1)
    span = decay - warmup
    t = min(count - warmup, span)
    alpha = end / peak if peak else 0.0
    return peak * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * t / span))
                   + alpha)


class ClippedAdamW:
    """Global-norm clipping, then AdamW (decoupled weight decay on every
    leaf, eps outside the square root, bias-corrected moments) at the
    warmup-cosine rate of the update's count."""

    def __init__(self, opt):
        self.opt = opt
        self.count = 0
        self.m, self.v = {}, {}

    def clip(self, grads):
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g) for g in grads.values()]))
        clip = self.opt["clip_norm"]
        if float(norm) >= clip:
            grads = {k: g / norm * clip for k, g in grads.items()}
        return grads

    @torch.no_grad()
    def update(self, W, grads):
        o = self.opt
        b1, b2 = o["b1"], o["b2"]
        lr = warmup_cosine(self.count, o["learning_rate"], o["warmup_steps"],
                           o["total_steps"])
        n = self.count + 1
        bc1, bc2 = 1 - b1 ** n, 1 - b2 ** n
        for k, g in grads.items():
            m = self.m.get(k, torch.zeros_like(g)) * b1 + (1 - b1) * g
            v = self.v.get(k, torch.zeros_like(g)) * b2 + (1 - b2) * g * g
            self.m[k], self.v[k] = m, v
            p = W[k]
            p -= lr * o["weight_decay"] * p
            p -= lr * (m / bc1) / ((v / bc2).sqrt() + o["eps"])
        self.count += 1
