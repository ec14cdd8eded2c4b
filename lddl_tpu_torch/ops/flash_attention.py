"""Fused attention on hand-written Hopper kernels, in the reference's two
regimes.

Counterpart of ``lddl_tpu/ops/flash_attention.py`` (``_prep``,
``flash_attention_fwd``, ``_use_onekv``, ``single_block_serves``, the
``custom_vjp`` of ``_build_vjp`` as a ``torch.autograd.Function``,
``flash_attention``). ``_use_onekv(l_pad, d)`` picks the regime, as in
the reference:

- single-block (L_pad <= 896 at D=64, <= 512 at D=128):
  ``csrc/attention_fwd.cu`` replaces ``_onekv_fwd_kernel`` (``onekv_fwd``)
  and ``csrc/online_attention_bwd.cu`` replaces ``_onekv_bwd_kernel``
  (``onekv_bwd``: a dK/dV kernel, then a dQ kernel);
- online softmax (every longer L_pad): ``csrc/attention_fwd.cu`` replaces
  ``_fwd_kernel`` (``online_fwd``) and ``csrc/online_attention_bwd.cu``
  replaces ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel`` (``online_bwd_dq``,
  ``online_bwd_dkv``), three kernels launched on their own.

In bf16 the two forwards are one warp-specialised kernel body (wgmma
with the scores in registers, K/V fed by a TMA ring) instantiated as two
kernels, one per regime; the backward is built the same way, a dQ body
and a dK/dV body instantiated once per regime, each kernel on a
persistent grid of at most one block per SM. Given LSE and delta the
single-block backward computes the online pair's function, so both
regimes share the bodies; the kernels keep separate names, so that the
profiler tells the regimes apart. Each kernel has a plain PyTorch version
beside it, computing the same function the same way (products of
stored-dtype operands accumulated in fp32, the fp32 -1e9 bias, P cast to
V's dtype before P V, dS cast to the input dtype; the online forward
walks the same 64-wide K/V tiles with a running max). A wrapper takes the
plain version only for tensors on the CPU; on a CUDA tensor it launches
its kernel or raises. Each wrapper counts its bf16 kernel launches in
``<wrapper>.launches``.

Conventions shared with the reference: layout ``[B*H, L_pad, D]`` with L
padded to a multiple of 128; int32 masks ``[B, L_pad]``; a query attends
a key iff ``kmask > 0 and kmask == qmask``; scale 1/sqrt(D); padded query
rows are computed and dropped.

Head dims: the reference's kernels take any D. The port's are built at
D=64 and 128 (all five) and at D=256 (the three online kernels; the
reference's single-block regime never takes D > 128). ``_prep`` zero-pads
any other D up to the next built width (``kernel_head_dim``) on every
device, and the outputs are sliced back. Padding is exact: zero columns
of Q and K leave Q K^T as it is, zero columns of V and dO give zero
columns of O, dQ, dK and dV and leave dP and delta as they are. The scale
stays 1/sqrt(D) of the true D, and ``_use_onekv`` decides on the true D,
as the reference does. A head dim above 256 raises (wgmma's N, the width
of the P V product, is at most 256).

Dtypes: the reference's kernels take any float dtype, with fp32
accumulation and fp32 softmax statistics. The port's kernels are built
for bf16 (the files above) and fp32, the fp32 builds under the same
regime names with an ``_f32`` suffix (``onekv_fwd_f32_kernel``, ...) in
two sources (``f32_source`` picks one by entry point, and raises at a
head dim it is not built for). The fp32 kernels run on the tensor cores,
every product 3xTF32 (each operand split into two tf32 halves, three
wgmma a product, fp32 accuracy), on the shared ``csrc/tf32x3_tiles.cuh``:
``csrc/attention_f32_fwd.cu`` holds both forwards at D=64 and 128 and
the online forward at D=256, ``csrc/attention_f32_bwd.cu`` the backward
of both regimes at D=64 and 128 and the online pair at D=256. The
wrapper picks the build by the operands' dtype, never casts fp32 down to
bf16 and never routes it elsewhere; any other dtype raises on a CUDA
tensor. Launches of the fp32 builds count in ``<wrapper>.launches_f32``.
"""

import ctypes

import torch

# The single-block bound of the reference (its VMEM budget on a TPU); on
# Hopper the tiled kernels have no such limit, and the bound is kept until
# H100 measurements set the port's own.
ONEKV_MAX_L_PAD = 896
NEG_BIG = -1e9
# Width of the K/V (fwd, dq) or Q (dkv) tiles the online kernels walk
# (STEP in csrc/attention_fwd.cu and csrc/online_attention_bwd.cu); the
# plain forward walks the same tiles, so its bf16 rounding of P matches
# the kernel's.
ONLINE_STEP = 64
# Head dims the kernels are built for, narrowest first.
KERNEL_HEAD_DIMS = (64, 128, 256)
# Operand dtypes the kernels are built for; each fp32 entry point is named
# as its bf16 one with an _f32 suffix, in F32_FWD_SOURCE (the forwards) or
# F32_BWD_SOURCE (the backward), built at its head dims in
# F32_TF32_HEAD_DIMS (3xTF32 wgmma).
KERNEL_DTYPES = (torch.bfloat16, torch.float32)
F32_FWD_SOURCE = "attention_f32_fwd"
F32_BWD_SOURCE = "attention_f32_bwd"
F32_TF32_HEAD_DIMS = {
    "lddl_onekv_fwd_f32": (64, 128),
    "lddl_online_fwd_f32": (64, 128, 256),
    "lddl_onekv_bwd_f32": (64, 128),
    "lddl_online_bwd_dq_f32": (64, 128, 256),
    "lddl_online_bwd_dkv_f32": (64, 128, 256),
}


def pad_seq_len(l):
    """L pads to the next multiple of 128."""
    return -(-l // 128) * 128


def _use_onekv(l_pad, d):
    """Single-block dispatch: L_pad <= 896 at D <= 64, <= 512 up to 128."""
    max_l = ONEKV_MAX_L_PAD if d <= 64 else 512
    return l_pad <= max_l and d <= 128


def single_block_serves(seq_len, head_dim):
    """True when flash_attention dispatches the single-block kernels for
    this shape and L_pad >= 256 (dense keeps the shortest bins).
    models.attention.resolve_auto_impl consults it, and picks the online
    kernels from L_pad 1024, as the reference does."""
    l_pad = pad_seq_len(seq_len)
    return l_pad >= 256 and _use_onekv(l_pad, head_dim)


def kernel_head_dim(d):
    """The built width that serves head dim ``d``: the narrowest of
    KERNEL_HEAD_DIMS that holds it. Raises above 256."""
    for width in KERNEL_HEAD_DIMS:
        if d <= width:
            return width
    raise ValueError("head_dim {} is above 256, the widest the attention "
                     "kernels take (wgmma's N is at most 256)".format(d))


def _prep_one(t, l_pad):
    """[B, L, H, D] -> [B*H, L_pad, D_k], contiguous: L zero-padded to
    ``l_pad`` and D to D_k = kernel_head_dim(D)."""
    b, l, h, d = t.shape
    dk = kernel_head_dim(d)
    if l_pad != l or dk != d:
        t = torch.nn.functional.pad(t, (0, dk - d, 0, 0, 0, l_pad - l))
    return t.permute(0, 2, 1, 3).reshape(b * h, l_pad, dk).contiguous()


def _prep_mask(m, l_pad):
    l = m.shape[1]
    m = m.to(torch.int32)
    if l_pad != l:
        m = torch.nn.functional.pad(m, (0, l_pad - l))
    return m.contiguous()


def _prep(q, k, v, kv_mask, q_mask):
    """Pad L to a multiple of 128 and D to a built width, and move to the
    kernel layout; the shape returned holds the true D. Masks are binary
    validity or per-token segment ids; q_mask defaults to all ones, and
    then a non-binary kv_mask normalizes to 0/1."""
    b, l, h, d = q.shape
    l_pad = pad_seq_len(l)
    if q_mask is None:
        kv_mask = (kv_mask != 0).to(torch.int32)
        q_mask = torch.ones((b, l), dtype=torch.int32, device=q.device)
    return (_prep_one(q, l_pad), _prep_one(k, l_pad), _prep_one(v, l_pad),
            _prep_mask(kv_mask, l_pad), _prep_mask(q_mask, l_pad),
            (b, l, h, d, l_pad))


def _from_bh(t, b, l, h, d):
    """[B*H, L_pad, D_k] -> [B, L, H, D]: the inverse of _prep_one."""
    return t.reshape(b, h, -1, t.shape[-1])[..., :d].permute(0, 2, 1, 3)[:, :l]


def _scores(qb, kb, maskb, qmaskb, scale):
    """fp32 S = Q K^T * scale + bias, [B*H, Lq, Lk] (qb [B*H, Lq, D] with
    qmaskb [B, Lq]; kb [B*H, Lk, D] with maskb [B, Lk])."""
    b = maskb.shape[0]
    bh, lq, _ = qb.shape
    lk = kb.shape[1]
    allowed = ((maskb[:, None, :] > 0)
               & (maskb[:, None, :] == qmaskb[:, :, None]))
    bias = torch.where(allowed, 0.0, NEG_BIG).to(torch.float32)
    s = torch.matmul(qb.float(), kb.float().transpose(1, 2)) * scale
    return (s.view(b, bh // b, lq, lk) + bias[:, None]).view(bh, lq, lk)


def onekv_fwd_plain(qb, kb, vb, maskb, qmaskb, scale):
    """Plain PyTorch version of the forward kernel: (O, LSE [B*H, L_pad])."""
    s = _scores(qb, kb, maskb, qmaskb, scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.matmul(p.to(vb.dtype).float(), vb.float())
    return (o * (1.0 / l)).to(qb.dtype), (m + torch.log(l)).squeeze(-1)


def onekv_bwd_plain(qb, kb, vb, maskb, qmaskb, dob, lse, delta, scale):
    """Plain PyTorch version of the backward kernels: (dQ, dK, dV)."""
    s = _scores(qb, kb, maskb, qmaskb, scale)
    p = torch.exp(s - lse[..., None])
    dp = torch.matmul(dob.float(), vb.float().transpose(1, 2))
    dv = torch.matmul(p.to(dob.dtype).float().transpose(1, 2), dob.float())
    ds = (p * (dp - delta[..., None]) * scale).to(kb.dtype).float()
    dq = torch.matmul(ds, kb.float())
    dk = torch.matmul(ds.transpose(1, 2), qb.float())
    return dq.to(qb.dtype), dk.to(kb.dtype), dv.to(vb.dtype)


def online_fwd_plain(qb, kb, vb, maskb, qmaskb, scale):
    """Plain PyTorch version of the online forward kernel: walks the K/V
    tiles with a running max m, denominator l and fp32 accumulator, each
    rescaled by exp(m - m_new); returns (O, LSE [B*H, L_pad])."""
    bh, l_pad, d = qb.shape
    m = torch.full((bh, l_pad, 1), -float("inf"), device=qb.device)
    l = torch.zeros((bh, l_pad, 1), device=qb.device)
    acc = torch.zeros((bh, l_pad, d), device=qb.device)
    for j in range(0, l_pad, ONLINE_STEP):
        t = slice(j, j + ONLINE_STEP)
        s = _scores(qb, kb[:, t], maskb[:, t], qmaskb, scale)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.matmul(p.to(vb.dtype).float(),
                                        vb[:, t].float())
        m = m_new
    l = l.clamp_min(1e-30)
    return (acc / l).to(qb.dtype), (m + torch.log(l)).squeeze(-1)


def online_bwd_dq_plain(qb, kb, vb, maskb, qmaskb, dob, lse, delta, scale):
    """Plain PyTorch version of the online dQ kernel: walks the K/V tiles,
    P = exp(S - LSE), dS = P (dP - delta) scale in the input dtype,
    dQ += dS K."""
    dq = torch.zeros(qb.shape, device=qb.device)
    for j in range(0, qb.shape[1], ONLINE_STEP):
        t = slice(j, j + ONLINE_STEP)
        p = torch.exp(_scores(qb, kb[:, t], maskb[:, t], qmaskb, scale)
                      - lse[..., None])
        dp = torch.matmul(dob.float(), vb[:, t].float().transpose(1, 2))
        ds = (p * (dp - delta[..., None]) * scale).to(kb.dtype).float()
        dq += torch.matmul(ds, kb[:, t].float())
    return dq.to(qb.dtype)


def online_bwd_dkv_plain(qb, kb, vb, maskb, qmaskb, dob, lse, delta,
                         scale):
    """Plain PyTorch version of the online dK/dV kernel: walks the Q
    tiles, dV += P^T dO, dK += dS^T Q; returns (dK, dV)."""
    dk = torch.zeros(kb.shape, device=kb.device)
    dv = torch.zeros(vb.shape, device=vb.device)
    for i in range(0, qb.shape[1], ONLINE_STEP):
        t = slice(i, i + ONLINE_STEP)
        p = torch.exp(_scores(qb[:, t], kb, maskb, qmaskb[:, t], scale)
                      - lse[:, t, None])
        do_t = dob[:, t]
        dv += torch.matmul(p.to(do_t.dtype).float().transpose(1, 2),
                           do_t.float())
        dp = torch.matmul(do_t.float(), vb.float().transpose(1, 2))
        ds = (p * (dp - delta[:, t, None]) * scale).to(qb.dtype).float()
        dk += torch.matmul(ds.transpose(1, 2), qb[:, t].float())
    return dk.to(kb.dtype), dv.to(vb.dtype)

def _check_cuda(tensors, masks, rows, online=False):
    """Raise unless the operands are CUDA tensors the kernels take;
    returns the number of heads."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise TypeError("the attention kernels run on CUDA tensors (the "
                        "plain versions on CPU ones); got {}".format(dev))
    return _check_operands(tensors, masks, rows, online)


def _check_operands(tensors, masks, rows, online=False):
    """Raise on what the kernels do not take: dtypes, devices, shapes,
    layout, head dims and lengths. ``tensors`` are [B*H, L_pad, D], all
    bf16 or all fp32, ``masks`` [B, L_pad] int32, ``rows`` (LSE, delta)
    [B*H, L_pad] fp32.
    The single-block kernels take L_pad inside ``_use_onekv``'s bound, the
    online kernels (``online=True``) any multiple of 128. Returns H."""
    dev, operand = tensors[0].device, tensors[0].dtype
    bh, l_pad, d = tensors[0].shape
    b = masks[0].shape[0]
    if operand not in KERNEL_DTYPES:
        raise TypeError("the attention kernels are built for bf16 and fp32 "
                        "operands; got {}".format(operand))
    for group, dtype, shape in ((tensors, operand, (bh, l_pad, d)),
                                (masks, torch.int32, (b, l_pad)),
                                (rows, torch.float32, (bh, l_pad))):
        for t in group:
            if t.device != dev or t.dtype != dtype:
                raise TypeError("the attention kernels take {} operands "
                                "on {}; got {} on {}".format(
                                    dtype, dev, t.dtype, t.device))
            if tuple(t.shape) != shape:
                raise ValueError("operand of shape {}, expected {}".format(
                    tuple(t.shape), shape))
            if not t.is_contiguous() or t.data_ptr() % 16:
                raise ValueError("kernel operands must be contiguous and "
                                 "16-byte aligned")
    if d not in KERNEL_HEAD_DIMS:
        kernel_head_dim(d)      # names the limit above 256
        raise ValueError("the CUDA attention kernels take head_dim 64, 128 "
                         "or 256 (flash_attention zero-pads the others up "
                         "to one of them), got {}".format(d))
    if l_pad % 128:
        raise ValueError("L_pad {} is not a multiple of 128".format(l_pad))
    if not online and not _use_onekv(l_pad, d):
        raise ValueError("L_pad {} at head_dim {} is outside the "
                         "single-block regime".format(l_pad, d))
    if bh % b or bh > 65535:
        raise ValueError("batch*heads ({}) must be a multiple of the mask "
                         "batch ({}) and at most 65535".format(bh, b))
    return bh // b


# Pointer arguments of each C entry point, by source; every entry point
# then takes (BH, L_pad, H, D, scale, stream) and returns a cudaError_t.
_ENTRY_POINTS = {
    "attention_fwd": {"lddl_onekv_fwd": 7, "lddl_online_fwd": 7},
    "online_attention_bwd": {"lddl_online_bwd_dq": 9,
                             "lddl_online_bwd_dkv": 10,
                             "lddl_onekv_bwd": 11},
}
_ENTRY_POINTS.update({
    f32: {entry + "_f32": n_ptr
          for entry, n_ptr in _ENTRY_POINTS[bf16].items()}
    for f32, bf16 in ((F32_FWD_SOURCE, "attention_fwd"),
                      (F32_BWD_SOURCE, "online_attention_bwd"))})


def f32_source(entry, d):
    """The source of the fp32 entry point ``entry`` at head dim ``d``;
    raises at a head dim ``entry`` is not built for."""
    if d not in F32_TF32_HEAD_DIMS[entry]:
        raise ValueError("{} is built at head_dim {}, not {}".format(
            entry, ", ".join(map(str, F32_TF32_HEAD_DIMS[entry])), d))
    return (F32_FWD_SOURCE if entry in _ENTRY_POINTS[F32_FWD_SOURCE]
            else F32_BWD_SOURCE)


def _lib(source):
    from . import _build
    lib = _build.load(source)
    if not getattr(lib, "_lddl_typed", False):
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        for entry, n_ptr in _ENTRY_POINTS[source].items():
            fn = getattr(lib, entry)
            fn.argtypes = [vp] * n_ptr + [i, i, i, i, f, vp]
            fn.restype = i
        lib.lddl_cuda_error_string.argtypes = [i]
        lib.lddl_cuda_error_string.restype = ctypes.c_char_p
        lib._lddl_typed = True
    return lib


def _launch(wrapper, source, entry, tensors, h, scale):
    """Call one C entry point of ``source`` on the operands' device and
    current stream, or its fp32 build for fp32 operands; ``tensors`` are
    its pointer arguments, q first. Raises on a CUDA error from the
    launch; else counts it in ``wrapper.launches`` (bf16) or
    ``wrapper.launches_f32``."""
    qb = tensors[0]
    bh, l_pad, d = qb.shape
    f32 = qb.dtype == torch.float32
    if f32:
        entry += "_f32"
        source = f32_source(entry, d)
    lib = _lib(source)
    with torch.cuda.device(qb.device):
        stream = torch.cuda.current_stream(qb.device).cuda_stream
        rc = getattr(lib, entry)(*(t.data_ptr() for t in tensors), bh,
                                 l_pad, h, d, scale, stream)
    if rc != 0:
        raise RuntimeError("{} launch failed: CUDA error {} ({})".format(
            entry, rc, lib.lddl_cuda_error_string(rc).decode()))
    if f32:
        wrapper.launches_f32 += 1
    else:
        wrapper.launches += 1


def onekv_fwd(qb, kb, vb, maskb, qmaskb, scale):
    """Single-block forward in the kernel layout: (O, LSE). Launches the
    CUDA kernel on CUDA tensors; the plain version on CPU tensors."""
    if qb.device.type == "cpu":
        return onekv_fwd_plain(qb, kb, vb, maskb, qmaskb, scale)
    bh, l_pad, _ = qb.shape
    h = _check_cuda([qb, kb, vb], [maskb, qmaskb], [])
    o = torch.empty_like(qb)
    lse = torch.empty((bh, l_pad), dtype=torch.float32, device=qb.device)
    _launch(onekv_fwd, "attention_fwd", "lddl_onekv_fwd",
            [qb, kb, vb, maskb, qmaskb, o, lse], h, scale)
    return o, lse


onekv_fwd.launches = 0
onekv_fwd.launches_f32 = 0


def onekv_bwd(qb, kb, vb, maskb, qmaskb, dob, lse, delta, scale):
    """Single-block backward in the kernel layout: (dQ, dK, dV). On CUDA
    tensors one call launches the dK/dV kernel and the dQ kernel, the
    online pair's bodies under the single-block regime's names."""
    if qb.device.type == "cpu":
        return onekv_bwd_plain(qb, kb, vb, maskb, qmaskb, dob, lse, delta,
                               scale)
    h = _check_cuda([qb, kb, vb, dob], [maskb, qmaskb], [lse, delta])
    dq, dk, dv = (torch.empty_like(t) for t in (qb, kb, vb))
    _launch(onekv_bwd, "online_attention_bwd", "lddl_onekv_bwd",
            [qb, kb, vb, maskb, qmaskb, dob, lse, delta, dq, dk, dv], h,
            scale)
    return dq, dk, dv


onekv_bwd.launches = 0
onekv_bwd.launches_f32 = 0


def online_fwd(qb, kb, vb, maskb, qmaskb, scale):
    """Online-softmax forward in the kernel layout: (O, LSE). Launches the
    CUDA kernel on CUDA tensors; the plain version on CPU tensors."""
    if qb.device.type == "cpu":
        return online_fwd_plain(qb, kb, vb, maskb, qmaskb, scale)
    bh, l_pad, _ = qb.shape
    h = _check_cuda([qb, kb, vb], [maskb, qmaskb], [], online=True)
    o = torch.empty_like(qb)
    lse = torch.empty((bh, l_pad), dtype=torch.float32, device=qb.device)
    _launch(online_fwd, "attention_fwd", "lddl_online_fwd",
            [qb, kb, vb, maskb, qmaskb, o, lse], h, scale)
    return o, lse


online_fwd.launches = 0
online_fwd.launches_f32 = 0


def online_bwd_dq(qb, kb, vb, maskb, qmaskb, dob, lse, delta, scale):
    """Online-softmax dQ in the kernel layout (one kernel launch on CUDA
    tensors; the plain version on CPU tensors)."""
    if qb.device.type == "cpu":
        return online_bwd_dq_plain(qb, kb, vb, maskb, qmaskb, dob, lse,
                                   delta, scale)
    h = _check_cuda([qb, kb, vb, dob], [maskb, qmaskb], [lse, delta],
                    online=True)
    dq = torch.empty_like(qb)
    _launch(online_bwd_dq, "online_attention_bwd", "lddl_online_bwd_dq",
            [qb, kb, vb, maskb, qmaskb, dob, lse, delta, dq], h, scale)
    return dq


online_bwd_dq.launches = 0
online_bwd_dq.launches_f32 = 0


def online_bwd_dkv(qb, kb, vb, maskb, qmaskb, dob, lse, delta, scale):
    """Online-softmax (dK, dV) in the kernel layout (one kernel launch on
    CUDA tensors; the plain version on CPU tensors)."""
    if qb.device.type == "cpu":
        return online_bwd_dkv_plain(qb, kb, vb, maskb, qmaskb, dob, lse,
                                    delta, scale)
    h = _check_cuda([qb, kb, vb, dob], [maskb, qmaskb], [lse, delta],
                    online=True)
    dk, dv = torch.empty_like(kb), torch.empty_like(vb)
    _launch(online_bwd_dkv, "online_attention_bwd", "lddl_online_bwd_dkv",
            [qb, kb, vb, maskb, qmaskb, dob, lse, delta, dk, dv], h, scale)
    return dk, dv


online_bwd_dkv.launches = 0
online_bwd_dkv.launches_f32 = 0


def _fwd(qb, kb, vb, maskb, qmaskb, l_pad, d):
    """The forward of the regime ``_use_onekv`` picks for the true head
    dim ``d`` (the operands may be zero-padded wider): (O, LSE)."""
    fwd = onekv_fwd if _use_onekv(l_pad, d) else online_fwd
    return fwd(qb, kb, vb, maskb, qmaskb, 1.0 / d ** 0.5)


def flash_attention_fwd(q, k, v, kv_mask, q_mask=None):
    """q/k/v [B, L, H, D], kv_mask [B, L] -> (out [B, L, H, D] in q.dtype,
    lse [B*H, L_pad] fp32)."""
    qb, kb, vb, maskb, qmaskb, (b, l, h, d, l_pad) = _prep(
        q, k, v, kv_mask, q_mask)
    out, lse = _fwd(qb, kb, vb, maskb, qmaskb, l_pad, d)
    return _from_bh(out, b, l, h, d), lse


class _FlashAttention(torch.autograd.Function):
    """The reference's custom_vjp: the forward saves the kernel-layout
    operands, the output and the LSE; the backward runs the backward
    kernels of the same regime on them."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, q_mask):
        qb, kb, vb, maskb, qmaskb, shape = _prep(q, k, v, kv_mask, q_mask)
        b, l, h, d, l_pad = shape
        out, lse = _fwd(qb, kb, vb, maskb, qmaskb, l_pad, d)
        ctx.save_for_backward(qb, kb, vb, maskb, qmaskb, out, lse)
        ctx.shape = shape
        return _from_bh(out, b, l, h, d)

    @staticmethod
    def backward(ctx, ct):
        qb, kb, vb, maskb, qmaskb, out, lse = ctx.saved_tensors
        b, l, h, d, l_pad = ctx.shape
        dob = _prep_one(ct, l_pad)
        delta = (dob.float() * out.float()).sum(dim=-1)
        args = (qb, kb, vb, maskb, qmaskb, dob, lse, delta, 1.0 / d ** 0.5)
        if _use_onekv(l_pad, d):
            dq, dk, dv = onekv_bwd(*args)
        else:
            dq = online_bwd_dq(*args)
            dk, dv = online_bwd_dkv(*args)
        return (_from_bh(dq, b, l, h, d), _from_bh(dk, b, l, h, d),
                _from_bh(dv, b, l, h, d), None, None)


def flash_attention(q, k, v, kv_mask=None, q_mask=None, segments=None):
    """Differentiable fused attention over q/k/v [B, L, H, D].

    ``kv_mask`` [B, L] is a binary key-padding mask (any nonzero value
    normalizes to 1). For packed rows pass per-token segment ids as
    ``segments=``: it sets both sides, and attention becomes
    block-diagonal per segment (0 = padding)."""
    if segments is not None:
        if kv_mask is not None or q_mask is not None:
            raise ValueError(
                "segments= is exclusive with kv_mask/q_mask: it defines "
                "both sides of the block-diagonal mask")
        kv_mask, q_mask = segments, segments
    elif kv_mask is None:
        raise ValueError("flash_attention needs kv_mask or segments")
    return _FlashAttention.apply(q, k, v, kv_mask, q_mask)
