"""The 3xTF32 arithmetic of the fp32 kernels at D=64 and 128, and of the
online trio at D=256 (``lddl_tpu_torch/ops/csrc/attention_f32_fwd.cu``
and ``attention_f32_bwd.cu``), emulated on the CPU.

The kernels split every fp32 operand x into hi = tf32(x) and lo =
tf32(x - hi), both rounded as ``cvt.rna.tf32.f32`` rounds (to nearest,
ties away from zero, a 10-bit mantissa), and take each product a b as
lo_a hi_b + hi_a lo_b + hi_a hi_b in fp32, dropping lo_a lo_b. Here the
same split is taken through an int32 view of the fp32 values, and the
products are taken that way on the CPU: the forward's two (S, and P V
tile by tile of the kernel's walk, each tile's product from zero and
added to the rescaled O in fp32) and the backward's five (S, dP, dQ, dK,
dV); at D=256 also in the wide bodies' order of work (their tiles, the
score products' four accumulators, each tile's product from zero; the
forward's two warpgroups' halves of S, two accumulators each).
O and the LSE are held against the reference's fp32 forward
(``lddl_tpu.ops.flash_attention.flash_attention_fwd``), the gradients
against its fp32 backward (``flash_attention_bwd``) on its own forward,
its Pallas kernels in interpret mode, as its own tests run them: within
1e-5 of max |ref| (1e-5 absolute for the LSE), the bar the kernels are
held to against their plain versions on the card
(``chip_smoke.F32_BAR``, ``CUDA_BARS["f32"]``), with a margin of 4. The
tensor core's own fp32 sums (which truncate) are the kernels' other
source of error, and only the card shows them.
"""

import importlib

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from lddl_tpu_torch.ops import flash_attention as tfa

# lddl_tpu.ops re-exports the function under the module's name.
jfa = importlib.import_module("lddl_tpu.ops.flash_attention")

F32_BAR = 1e-5
MARGIN = 4


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def tf32_rna(x):
    """fp32 ``x`` rounded to tf32 as cvt.rna.tf32.f32 rounds it: half an
    ulp of the 10-bit mantissa (bit 12) added to the magnitude, which
    carries into the exponent where it must, and the low 13 bits
    cleared (finite values)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def mm3(a, b):
    """a @ b in 3xTF32, the two small products summed first."""
    (ah, al), (bh, bl) = split(a), split(b)
    return (torch.matmul(al, bh) + torch.matmul(ah, bl)) + torch.matmul(ah, bh)


# Keys of a K/V tile of the forward's walk, by head dim (the TR of
# FwdPlan in attention_f32_fwd.cu).
FWD_TILE = {64: 64, 128: 32}


def _bias(maskb, qmaskb, bh):
    """The fp32 -1e9 bias, [B*H, Lq, Lk]."""
    b = maskb.shape[0]
    allowed = ((maskb[:, None, :] > 0)
               & (maskb[:, None, :] == qmaskb[:, :, None]))
    bias = torch.where(allowed, 0.0, tfa.NEG_BIG).to(torch.float32)
    return bias.repeat_interleave(bh // b, dim=0)


def _biased_scores(qb, kb, maskb, qmaskb, scale):
    """S = Q K^T * scale + bias with Q K^T in 3xTF32, [B*H, L_pad, L_pad]."""
    return (mm3(qb, kb.transpose(1, 2)) * scale
            + _bias(maskb, qmaskb, qb.shape[0]))


def emulated_fwd(qb, kb, vb, maskb, qmaskb, scale):
    """The kernels' forward in the kernel layout with every product in
    3xTF32: S whole, then the walk over the kernel's K/V tiles with the
    running max m and denominator l; each tile's P V starts from zero and
    is added to O rescaled by exp(m - m_new). Returns (O, LSE)."""
    bh, l_pad, d = qb.shape
    tr = FWD_TILE[d]
    s = _biased_scores(qb, kb, maskb, qmaskb, scale)
    m = torch.full((bh, l_pad, 1), -float("inf"))
    l = torch.zeros((bh, l_pad, 1))
    o = torch.zeros((bh, l_pad, d))
    for j in range(0, l_pad, tr):
        st = s[:, :, j:j + tr]
        m_new = torch.maximum(m, st.amax(dim=-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(st - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        o = o * corr + mm3(p, vb[:, j:j + tr])
        m = m_new
    l = l.clamp_min(1e-30)
    return o / l, (m + torch.log(l)).squeeze(-1)


def emulated_bwd(qb, kb, vb, maskb, qmaskb, dob, lse, delta, scale):
    """The kernels' backward in the kernel layout with every product in
    3xTF32: (dQ, dK, dV). At D=256, where the kernels are the wide bodies
    (the online pair alone), in their order of work (emulated_wide_bwd)."""
    if qb.shape[-1] == 256:
        return emulated_wide_bwd(qb, kb, vb, maskb, qmaskb, dob, lse, delta,
                                 scale)
    s = _biased_scores(qb, kb, maskb, qmaskb, scale)
    p = torch.exp(s - lse[..., None])
    dp = mm3(dob, vb.transpose(1, 2))
    ds = p * (dp - delta[..., None]) * scale
    return (mm3(ds, kb), mm3(ds.transpose(1, 2), qb),
            mm3(p.transpose(1, 2), dob))


def test_split_is_within_2_to_the_minus_21():
    """On normal floats across the exponent range: hi and lo are tf32
    (the low 13 bits 0), |x - (hi + lo)| <= 2^-21 |x|, and hi is x
    rounded to nearest (|x - hi| <= 2^-11 |x|)."""
    g = np.random.default_rng(19)
    mant = g.uniform(1.0, 2.0, 200_000)
    x = (np.sign(g.standard_normal(mant.size)) * mant
         * np.exp2(g.integers(-100, 100, mant.size))).astype(np.float32)
    # Ties and values next to a carry into the exponent.
    x[:4] = np.array([1 + 2.0 ** -11, 1 + 3 * 2.0 ** -11, 2 - 2.0 ** -23,
                      -(1 + 2.0 ** -11)], np.float32)
    hi, lo = split(torch.from_numpy(x))
    for t in (hi, lo):
        assert not (t.view(torch.int32) & 0x1FFF).any()
    x64 = x.astype(np.float64)
    hi64, lo64 = hi.numpy().astype(np.float64), lo.numpy().astype(np.float64)
    assert np.all(np.abs(x64 - (hi64 + lo64)) <= 2.0 ** -21 * np.abs(x64))
    assert np.all(np.abs(x64 - hi64) <= 2.0 ** -11 * np.abs(x64))
    # Ties round away from zero, as cvt.rna does.
    assert hi[0] == np.float32(1 + 2.0 ** -10)
    assert hi[1] == np.float32(1 + 2 * 2.0 ** -10)
    assert hi[2] == np.float32(2.0)
    assert hi[3] == np.float32(-(1 + 2.0 ** -10))


def _backward_case(d, l, mask_kind, seed):
    """Inputs from ``seed`` at B=2, H=2 (padding masks, or segment ids 1-3
    on both sides with one batch row masked entirely), the reference's
    fp32 backward on its own forward, and the kernel-layout operands with
    dO, the LSE and delta: (refs, args, (b, l, h, d))."""
    b, h = 2, 2
    g = np.random.default_rng(seed)
    q, k, v, ct = (g.standard_normal((b, l, h, d)).astype(np.float32)
                   for _ in range(4))
    mask = np.ones((b, l), np.int32)
    mask[1, l - l // 3:] = 0
    qmask = None
    if mask_kind == "segments":
        mask = mask * g.integers(1, 4, (b, l)).astype(np.int32)
        mask[-1] = 0
        qmask = mask
    kw = {} if qmask is None else {"q_mask": jnp.asarray(qmask)}
    jq, jk, jv, jct, jmask = (jnp.asarray(x) for x in (q, k, v, ct, mask))
    j_out, j_lse = jfa.flash_attention_fwd(jq, jk, jv, jmask, **kw)
    refs = jfa.flash_attention_bwd(jq, jk, jv, jmask, j_out, j_lse, jct,
                                   **kw)

    qb, kb, vb, maskb, qmaskb, (_, _, _, _, l_pad) = tfa._prep(
        *(torch.from_numpy(x) for x in (q, k, v, mask)),
        None if qmask is None else torch.from_numpy(qmask))
    dob = tfa._prep_one(torch.from_numpy(ct), l_pad)
    ob = tfa._prep_one(torch.from_numpy(np.array(j_out)), l_pad)
    lse = torch.from_numpy(np.array(j_lse)).reshape(b * h, l_pad)
    delta = (dob * ob).sum(-1)
    return refs, (qb, kb, vb, maskb, qmaskb, dob, lse, delta,
                  1.0 / d ** 0.5), (b, l, h, d)


def _check_grads(got, refs, shape):
    b, l, h, d = shape
    for name, x, ref in zip(("dQ", "dK", "dV"), got, refs):
        x = tfa._from_bh(x, b, l, h, d).numpy()
        ref = np.asarray(ref)
        err = np.abs(x - ref).max() / np.abs(ref).max()
        assert err <= F32_BAR / MARGIN, (name, err)


@pytest.mark.parametrize("mask_kind", ["padding", "segments"])
@pytest.mark.parametrize("l", [200, 512])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_emulated_split_matches_reference_backward(d, l, mask_kind):
    """dQ, dK and dV with every product in 3xTF32 against the reference's
    fp32 backward at D=64, 128 and 256 (there in the wide bodies' order,
    as the online pair computes it), L_pad 256 and 512, padding masks or
    segment ids 1-3 (both masks, one batch row masked entirely): within
    F32_BAR / MARGIN of max |ref|."""
    refs, args, shape = _backward_case(
        d, l, mask_kind, 100 * d + l + (mask_kind == "segments"))
    _check_grads(emulated_bwd(*args), refs, shape)


# The wide bodies at D=256 (WidePlan in attention_f32_bwd.cu, FwdWidePlan
# in attention_f32_fwd.cu): rows of a streamed tile (dQ and the forward:
# K/V tiles; dK/dV: Q/dO tiles) and the score products' four accumulators.
WIDE_DQ_TILE, WIDE_DKV_TILE, WIDE_FWD_TILE, WIDE_NACC = 16, 8, 32, 4


def _bwd_acc(k):
    """The backward's accumulator of k8 step k: k % 4 (one warpgroup
    takes all 32 steps of a score tile)."""
    return k % WIDE_NACC


def _fwd_acc(k):
    """The forward's: warpgroup k // 16 takes steps [16 wg, 16 wg + 16)
    into its two accumulators, k % 2; half 0 is accumulators 0 and 1."""
    return 2 * (k // 16) + k % 2


def _wide_scores(a, b, acc_of=_bwd_acc):
    """a @ b^T over D as the wide bodies take it: in 3xTF32, k8 step k
    (columns 8k..8k+7) into accumulator acc_of(k), each from zero, the
    accumulators added as (0 + 1) + (2 + 3). The kernels split each k8
    slice of the item's operand as they use it; the split is elementwise,
    so splitting it whole is the same."""
    d = a.shape[-1]
    acc_col = torch.tensor([acc_of(c // 8) for c in range(d)])
    acc = [mm3(a[..., acc_col == i], b[..., acc_col == i].transpose(1, 2))
           for i in range(WIDE_NACC)]
    return (acc[0] + acc[1]) + (acc[2] + acc[3])


def emulated_wide_bwd(qb, kb, vb, maskb, qmaskb, dob, lse, delta, scale):
    """The D=256 online pair in the wide bodies' order of work, every
    product in 3xTF32: dQ walks the K/V tiles of WIDE_DQ_TILE keys, dK/dV
    the Q/dO tiles of WIDE_DKV_TILE queries; the two score tiles (S and
    dP, or S^T and dP^T) as _wide_scores takes them; each tile's
    contracting products from zero, added to the running sums in fp32.
    (The warpgroups' halves of D split the outputs by columns, which the
    emulation need not repeat.) Returns (dQ, dK, dV)."""
    bh, l_pad, _ = qb.shape
    bias = _bias(maskb, qmaskb, bh)
    dq = torch.zeros(qb.shape)
    for j in range(0, l_pad, WIDE_DQ_TILE):
        t = slice(j, j + WIDE_DQ_TILE)
        p = torch.exp(_wide_scores(qb, kb[:, t]) * scale + bias[:, :, t]
                      - lse[..., None])
        dp = _wide_scores(dob, vb[:, t])
        ds = p * (dp - delta[..., None]) * scale
        dq = dq + mm3(ds, kb[:, t])
    dk, dv = torch.zeros(kb.shape), torch.zeros(vb.shape)
    for i in range(0, l_pad, WIDE_DKV_TILE):
        t = slice(i, i + WIDE_DKV_TILE)
        pt = torch.exp(_wide_scores(kb, qb[:, t]) * scale
                       + bias[:, t].transpose(1, 2) - lse[:, None, t])
        dpt = _wide_scores(vb, dob[:, t])
        dst = pt * (dpt - delta[:, None, t]) * scale
        dv = dv + mm3(pt, dob[:, t])
        dk = dk + mm3(dst, qb[:, t])
    return dq, dk, dv


@pytest.mark.parametrize("mask_kind", ["padding", "segments"])
@pytest.mark.parametrize("l", [200, 1024])
def test_emulated_d256_backward_walk_matches_reference(l, mask_kind):
    """The D=256 online pair in the wide bodies' order of work (their
    streamed tiles, the per-k8 split of the item's A fragments, the four
    score accumulators, each tile's partial product from zero) against
    the reference's fp32 backward at L_pad 256 and 1024, padding masks or
    segment ids 1-3: within F32_BAR / MARGIN of max |ref|."""
    refs, args, shape = _backward_case(
        256, l, mask_kind, 300 + l + (mask_kind == "segments"))
    _check_grads(emulated_wide_bwd(*args), refs, shape)


def _forward_case(d, l, mask_kind, seed):
    """Inputs from ``seed`` at B=2, H=2 (padding masks, or segment ids 1-3
    on both sides with one batch row masked entirely), the reference's
    fp32 forward, and the kernel-layout operands: ((O, LSE) of the
    reference, args, (b, l, h, d))."""
    b, h = 2, 2
    g = np.random.default_rng(seed)
    q, k, v = (g.standard_normal((b, l, h, d)).astype(np.float32)
               for _ in range(3))
    mask = np.ones((b, l), np.int32)
    mask[1, l - l // 3:] = 0
    qmask = None
    if mask_kind == "segments":
        mask = mask * g.integers(1, 4, (b, l)).astype(np.int32)
        mask[-1] = 0
        qmask = mask
    kw = {} if qmask is None else {"q_mask": jnp.asarray(qmask)}
    refs = jfa.flash_attention_fwd(
        *(jnp.asarray(x) for x in (q, k, v, mask)), **kw)
    qb, kb, vb, maskb, qmaskb, _ = tfa._prep(
        *(torch.from_numpy(x) for x in (q, k, v, mask)),
        None if qmask is None else torch.from_numpy(qmask))
    return refs, (qb, kb, vb, maskb, qmaskb, 1.0 / d ** 0.5), (b, l, h, d)


def _check_fwd(got, refs, shape):
    """O within F32_BAR / MARGIN of max |ref|, the LSE within F32_BAR /
    MARGIN absolute."""
    b, l, h, d = shape
    (o, lse), (j_out, j_lse) = got, refs
    o = tfa._from_bh(o, b, l, h, d).numpy()
    ref = np.asarray(j_out)
    err = np.abs(o - ref).max() / np.abs(ref).max()
    assert err <= F32_BAR / MARGIN, ("O", err)
    lse_ref = np.asarray(j_lse).reshape(lse.shape)
    err = np.abs(lse.numpy() - lse_ref).max()
    assert err <= F32_BAR / MARGIN, ("LSE", err)


@pytest.mark.parametrize("mask_kind", ["padding", "segments"])
@pytest.mark.parametrize("d, l", [(64, 200), (64, 512), (128, 200),
                                  (128, 512), (64, 1024)])
def test_emulated_split_matches_reference_forward(d, l, mask_kind):
    """O and the LSE of the forward with every product in 3xTF32, walked
    over the kernel's tiles, against the reference's fp32 forward at D=64
    and 128: L_pad 256 and 512 (the single-block regime) and 1024 at D=64
    (the online one), padding masks or segment ids 1-3 (both masks, one
    batch row masked entirely). O within F32_BAR / MARGIN of max |ref|,
    the LSE within F32_BAR / MARGIN absolute."""
    refs, args, shape = _forward_case(
        d, l, mask_kind, 200 * d + l + (mask_kind == "segments"))
    l_pad = args[0].shape[1]
    assert tfa._use_onekv(l_pad, d) == (l_pad <= 512)
    _check_fwd(emulated_fwd(*args), refs, shape)


def emulated_wide_fwd(qb, kb, vb, maskb, qmaskb, scale):
    """The D=256 online forward in the wide body's order of work, every
    product in 3xTF32: the K/V tiles of WIDE_FWD_TILE keys; each tile's S
    as the two warpgroups take it (each half of D's k8 steps in its two
    accumulators from zero, S = half 0 + half 1: _wide_scores with
    _fwd_acc), scale and bias, the running max m and denominator l; each
    tile's P V from zero, added to O rescaled by exp(m - m_new). (The
    warpgroups' halves of D split O by columns, which the emulation need
    not repeat.) Returns (O, LSE)."""
    bh, l_pad, d = qb.shape
    bias = _bias(maskb, qmaskb, bh)
    m = torch.full((bh, l_pad, 1), -float("inf"))
    l = torch.zeros((bh, l_pad, 1))
    o = torch.zeros((bh, l_pad, d))
    for j in range(0, l_pad, WIDE_FWD_TILE):
        t = slice(j, j + WIDE_FWD_TILE)
        s = _wide_scores(qb, kb[:, t], _fwd_acc) * scale + bias[:, :, t]
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        o = o * corr + mm3(p, vb[:, t])
        m = m_new
    l = l.clamp_min(1e-30)
    return o / l, (m + torch.log(l)).squeeze(-1)


@pytest.mark.parametrize("mask_kind", ["padding", "segments"])
@pytest.mark.parametrize("l", [200, 1024])
def test_emulated_d256_forward_walk_matches_reference(l, mask_kind):
    """The D=256 online forward in the wide body's order of work (32-key
    tiles, each warpgroup's half of S's k8 steps in two accumulators, S =
    half 0 + half 1, each tile's P V from zero added to the rescaled O)
    against the reference's fp32 forward (its online Pallas kernel in
    interpret mode) at L_pad 256 and 1024, padding masks or segment ids
    1-3 (both masks, one batch row masked entirely): O within F32_BAR /
    MARGIN of max |ref|, the LSE within F32_BAR / MARGIN absolute."""
    refs, args, shape = _forward_case(
        256, l, mask_kind, 500 + l + (mask_kind == "segments"))
    assert not tfa._use_onekv(args[0].shape[1], 256)
    _check_fwd(emulated_wide_fwd(*args), refs, shape)
