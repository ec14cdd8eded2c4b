"""The port's attention (lddl_tpu_torch.ops.flash_attention), in the
single-block and the online-softmax regimes, against the reference's
Pallas kernels in interpret mode and against the dense reference, forward
and gradients.

Head dims: 64, 128 and 256 run as they are; 8, 32, 96 and 160 are
zero-padded by the port to the next built width (64, 128 or 256) and
held against the reference at their true D.

On the CPU the port's wrappers run the kernels' plain PyTorch versions;
the CUDA kernels themselves, bf16 and fp32 builds, are held against
those plain versions on the card (the CUDA-gated tests below, and
chip_smoke.py). The operand checks, the ctypes table and the fp32
sources' instruction sets are checked here without nvcc.

Tolerances (fp32 everywhere): 1e-5 for the forward and 1e-4 for the
gradients, absolute and relative. Both sides compute the same products
in fp32; they differ only in summation order (a few ulp, ~1e-6 on O(1)
values), and the gradients chain three products.
"""

import importlib
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from lddl_tpu.ops.ring_attention import dense_attention_reference
from lddl_tpu_torch.ops import flash_attention as tfa

# lddl_tpu.ops re-exports the function under the module's name.
jfa = importlib.import_module("lddl_tpu.ops.flash_attention")

FWD_TOL = 1e-5
GRAD_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _inputs(b, l, h, d, seed, mask_kind="padding"):
    g = np.random.default_rng(seed)
    q, k, v, ct = (g.standard_normal((b, l, h, d)).astype(np.float32)
                   for _ in range(4))
    mask = np.ones((b, l), np.int32)
    mask[1, l - l // 3:] = 0                   # a padded row
    if mask_kind == "nonbinary":
        mask = mask * g.integers(1, 4, (b, l)).astype(np.int32)
    elif mask_kind == "all_masked":
        mask[0] = 0                            # every key of row 0 masked
    return q, k, v, ct, mask


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol, err_msg=what)


def _port_out_and_grads(q, k, v, ct, **mask_kw):
    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv,
                              **{n: _t(m) for n, m in mask_kw.items()})
    (out * _t(ct)).sum().backward()
    return (out.detach().numpy(), tq.grad.numpy(), tk.grad.numpy(),
            tv.grad.numpy())


def _jax_out_and_grads(fn, q, k, v, ct):
    def f(q, k, v):
        return (fn(q, k, v) * ct).sum()

    q, k, v = (jnp.asarray(x) for x in (q, k, v))
    out = fn(q, k, v)
    grads = jax.grad(f, argnums=(0, 1, 2))(q, k, v)
    return (np.asarray(out),) + tuple(np.asarray(g) for g in grads)


CASES = ([(l, 64, "padding") for l in (200, 256, 384, 512, 640, 896)]
         + [(l, 128, "padding") for l in (256, 512)]
         + [(384, 64, "nonbinary"), (256, 64, "all_masked")]
         # Head dims zero-padded to a built width (8, 32 -> 64, 96 -> 128).
         + [(512, d, "padding") for d in (8, 32, 96)])
# The online-softmax regime: L_pad 1024 and above at D=64, L_pad 640 at
# D=128 (above the single-block bound of 512 there), and D > 128 at any
# L_pad: D=256 (the reference's own case, L_pad 640, and 1024) and 160,
# zero-padded to 256.
ONLINE_CASES = ([(l, 64, "padding") for l in (1000, 1152, 2048)]
                + [(1024, 64, "nonbinary"), (1024, 64, "all_masked"),
                   (600, 128, "padding"), (600, 256, "padding"),
                   (1024, 256, "padding"), (1024, 160, "padding")])


@pytest.mark.parametrize("l,d,mask_kind", CASES + ONLINE_CASES)
def test_port_matches_pallas_interpret(l, d, mask_kind):
    """Forward O and LSE, and dq/dk/dv, against the reference's Pallas
    kernels of the same regime (interpret mode on the CPU)."""
    assert tfa._use_onekv(tfa.pad_seq_len(l), d) == ((l, d, mask_kind)
                                                     in CASES)
    b, h = 2, 2
    q, k, v, ct, mask = _inputs(b, l, h, d, seed=l + d, mask_kind=mask_kind)
    j_out, j_lse = jfa.flash_attention_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask))
    t_out, t_lse = tfa.flash_attention_fwd(_t(q), _t(k), _t(v), _t(mask))
    _close(t_out, j_out, FWD_TOL, "O")
    _close(t_lse.reshape(b * h, 1, -1), j_lse, FWD_TOL, "LSE")

    want = _jax_out_and_grads(
        lambda q, k, v: jfa.flash_attention(q, k, v, jnp.asarray(mask)),
        q, k, v, ct)
    got = _port_out_and_grads(q, k, v, ct, kv_mask=mask)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        _close(g, w, FWD_TOL if name == "out" else GRAD_TOL, name)


@pytest.mark.parametrize("l,d", [(200, 64), (896, 64), (512, 128)])
def test_port_matches_dense_reference(l, d):
    """Forward and gradients against ring_attention's unsharded dense
    reference (the math both kernel families must reproduce)."""
    q, k, v, ct, mask = _inputs(2, l, 2, d, seed=3 * l + d)
    want = _jax_out_and_grads(
        lambda q, k, v: dense_attention_reference(q, k, v,
                                                  jnp.asarray(mask)),
        q, k, v, ct)
    got = _port_out_and_grads(q, k, v, ct, kv_mask=mask)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        _close(g, w, FWD_TOL if name == "out" else GRAD_TOL, name)


def test_masked_outlier_key_cannot_underflow_live_rows():
    """A disallowed key whose raw score dwarfs every allowed score must not
    drag the row max up: the -1e9 bias keeps the max on the allowed side.
    Also the packed segments path, against the reference kernel; the
    outlier's 100x key makes gradient terms 100x larger, so the gradient
    tolerance is GRAD_TOL relative to max |ref| (fp32 rounding scales with
    the terms summed)."""
    g = np.random.default_rng(11)
    b, l, h, d = 1, 128, 4, 64
    q = g.standard_normal((b, l, h, d)).astype(np.float32)
    k = g.standard_normal((b, l, h, d)).astype(np.float32)
    k[0, 70] = 100.0 * q[0, 0]                  # raw score ~ 800
    v = g.standard_normal((b, l, h, d)).astype(np.float32)
    ct = g.standard_normal((b, l, h, d)).astype(np.float32)
    segs = np.ones((b, l), np.int32)
    segs[0, 70] = 2                              # the outlier is disallowed
    segs[0, 100:] = 0                            # for rows in segment 1

    got = _port_out_and_grads(q, k, v, ct, segments=segs)
    assert np.abs(got[0][0, 0]).max() > 1e-3     # the row did not collapse
    assert np.isfinite(got[1]).all() and np.abs(got[1][0, 0]).max() > 1e-6
    want = _jax_out_and_grads(
        lambda q, k, v: jfa.flash_attention(q, k, v,
                                            segments=jnp.asarray(segs)),
        q, k, v, ct)
    _close(got[0], want[0], FWD_TOL, "out")
    for name, gg, w in zip(("dq", "dk", "dv"), got[1:], want[1:]):
        np.testing.assert_allclose(gg, w, rtol=0,
                                   atol=GRAD_TOL * np.abs(w).max(),
                                   err_msg=name)


@pytest.mark.parametrize("l,d", [(1024, 64), (600, 128)])
def test_online_backward_plain_versions_match_reference_bwd(l, d):
    """The plain dQ and dK/dV versions, each alone, against
    flash_attention_bwd's outputs on the reference's own O and LSE."""
    b, h = 2, 2
    q, k, v, ct, mask = _inputs(b, l, h, d, seed=5 * l + d)
    jq, jk, jv, jct, jmask = (jnp.asarray(x) for x in (q, k, v, ct, mask))
    j_out, j_lse = jfa.flash_attention_fwd(jq, jk, jv, jmask)
    j_dq, j_dk, j_dv = jfa.flash_attention_bwd(jq, jk, jv, jmask, j_out,
                                               j_lse, jct)
    qb, kb, vb, maskb, qmaskb, (_, _, _, _, l_pad) = tfa._prep(
        _t(q), _t(k), _t(v), _t(mask), None)
    dob = tfa._prep_one(_t(ct), l_pad)
    ob = tfa._prep_one(_t(np.array(j_out)), l_pad)
    lse = _t(np.array(j_lse)).reshape(b * h, l_pad)
    delta = (dob * ob).sum(-1)
    args = (qb, kb, vb, maskb, qmaskb, dob, lse, delta, 1.0 / d ** 0.5)
    dq = tfa.online_bwd_dq_plain(*args)
    dk, dv = tfa.online_bwd_dkv_plain(*args)
    for name, got, want in (("dq", dq, j_dq), ("dk", dk, j_dk),
                            ("dv", dv, j_dv)):
        _close(tfa._from_bh(got, b, l, h, d), want, GRAD_TOL, name)


@pytest.mark.parametrize("mask_kind", ["padding", "segments"])
@pytest.mark.parametrize("l,d", [(200, 64), (512, 64), (896, 64),
                                 (512, 128)])
def test_onekv_backward_plain_matches_online_pair(l, d, mask_kind):
    """Given LSE and delta, the single-block backward computes the online
    dQ and dK/dV pair's function, which is why its kernels are the pair's
    bodies: onekv_bwd_plain against online_bwd_{dq,dkv}_plain at
    single-block shapes, with padding masks and with segment ids 1-3 plus
    a batch row masked entirely. fp32 operands, so no bf16 rounding is
    taken and only the fp32 summation order differs (whole rows against
    64-wide tiles): 1e-5 of max |ref|."""
    b, h = 2, 2
    q, k, v, ct, mask = _inputs(b, l, h, d, seed=7 * l + d)
    q_mask = None
    if mask_kind == "segments":
        mask = mask * np.random.default_rng(l).integers(
            1, 4, (b, l)).astype(np.int32)
        mask[-1] = 0
        q_mask = _t(mask)
    qb, kb, vb, maskb, qmaskb, (_, _, _, _, l_pad) = tfa._prep(
        _t(q), _t(k), _t(v), _t(mask), q_mask)
    assert tfa._use_onekv(l_pad, d)
    scale = 1.0 / d ** 0.5
    ob, lse = tfa.onekv_fwd_plain(qb, kb, vb, maskb, qmaskb, scale)
    dob = tfa._prep_one(_t(ct), l_pad)
    delta = (dob * ob).sum(-1)
    args = (qb, kb, vb, maskb, qmaskb, dob, lse, delta, scale)
    want = tfa.onekv_bwd_plain(*args)
    got = (tfa.online_bwd_dq_plain(*args),) + tfa.online_bwd_dkv_plain(*args)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=1e-5 * float(w.abs().max()),
                                   err_msg=name)


def test_dispatch_bounds_match_reference():
    """The regime predicates agree with the reference's, on the true head
    dim. Each head dim up to 256 maps to the narrowest built width that
    holds it; above 256 the port raises, naming the limit."""
    for l in (100, 128, 200, 256, 512, 640, 896, 897, 1024, 1152, 2048):
        for d in (8, 32, 64, 96, 128, 160, 256):
            l_pad = jfa.pad_seq_len(l)
            assert tfa.pad_seq_len(l) == l_pad
            assert tfa._use_onekv(l_pad, d) == jfa._use_onekv(l_pad, d)
            assert (tfa.single_block_serves(l, d)
                    == jfa.single_block_serves(l, d))
            # The padded width keeps the true D's regime.
            assert (tfa._use_onekv(l_pad, tfa.kernel_head_dim(d))
                    == tfa._use_onekv(l_pad, d))
    assert [tfa.kernel_head_dim(d) for d in (1, 8, 64, 65, 96, 128, 129,
                                             160, 256)] == [
        64, 64, 64, 128, 128, 128, 256, 256, 256]
    for d in (257, 512):
        with pytest.raises(ValueError, match="256"):
            tfa.kernel_head_dim(d)
        q = torch.zeros((1, 128, 1, d))
        with pytest.raises(ValueError, match="256"):
            tfa.flash_attention(q, q, q,
                                kv_mask=torch.ones((1, 128), dtype=torch.int32))
    # The kernels' own check takes only the built widths.
    m = torch.ones((1, 128), dtype=torch.int32)
    for d, match in ((96, "64, 128 or 256"), (512, "256")):
        t = torch.zeros((2, 128, d), dtype=torch.bfloat16)
        with pytest.raises(ValueError, match=match):
            tfa._check_operands([t] * 3, [m, m], [], online=True)
    t = torch.zeros((2, 1024, 256), dtype=torch.bfloat16)
    assert tfa._check_operands([t] * 3, [m.repeat(1, 8)] * 2, [],
                               online=True) == 2
    with pytest.raises(ValueError, match="single-block"):
        tfa._check_operands([t[:, :512].contiguous()] * 3,
                            [m.repeat(1, 4)] * 2, [])


@pytest.mark.parametrize("l,d", [(512, 8), (512, 32), (512, 96),
                                 (1024, 160), (600, 200)])
def test_padded_plain_matches_unpadded(l, d):
    """Zero-padding D is exact: the plain versions of the regime the true
    D picks, on the operands _prep pads to the built width and sliced
    back, against the same plain versions on the unpadded operands, with
    the same scale 1/sqrt(D) of the true D; forward O and LSE, and dQ, dK
    and dV given the unpadded LSE and delta. fp32 operands: the products
    gain only exact zero terms, so within 1e-6 of max |ref|."""
    b, h = 2, 2
    q, k, v, ct, mask = _inputs(b, l, h, d, seed=9 * l + d)
    qb, kb, vb, maskb, qmaskb, (_, _, _, _, l_pad) = tfa._prep(
        _t(q), _t(k), _t(v), _t(mask), None)
    dk = tfa.kernel_head_dim(d)
    assert qb.shape == (b * h, l_pad, dk) and dk > d
    assert not qb[..., d:].any()
    dob = tfa._prep_one(_t(ct), l_pad)

    def unpadded(x):
        x = torch.nn.functional.pad(_t(x), (0, 0, 0, 0, 0, l_pad - l))
        return x.permute(0, 2, 1, 3).reshape(b * h, l_pad, d).contiguous()

    uq, uk, uv, udo = (unpadded(x) for x in (q, k, v, ct))
    scale = 1.0 / d ** 0.5
    onekv = tfa._use_onekv(l_pad, d)
    fwd = tfa.onekv_fwd_plain if onekv else tfa.online_fwd_plain
    o_ref, lse_ref = fwd(uq, uk, uv, maskb, qmaskb, scale)
    o, lse = fwd(qb, kb, vb, maskb, qmaskb, scale)
    delta = (udo * o_ref).sum(-1)
    if onekv:
        want = tfa.onekv_bwd_plain(uq, uk, uv, maskb, qmaskb, udo, lse_ref,
                                   delta, scale)
        got = tfa.onekv_bwd_plain(qb, kb, vb, maskb, qmaskb, dob, lse_ref,
                                  delta, scale)
    else:
        args = (maskb, qmaskb)
        want = ((tfa.online_bwd_dq_plain(uq, uk, uv, *args, udo, lse_ref,
                                         delta, scale),)
                + tfa.online_bwd_dkv_plain(uq, uk, uv, *args, udo, lse_ref,
                                           delta, scale))
        got = ((tfa.online_bwd_dq_plain(qb, kb, vb, *args, dob, lse_ref,
                                        delta, scale),)
               + tfa.online_bwd_dkv_plain(qb, kb, vb, *args, dob, lse_ref,
                                          delta, scale))
    for name, g, w in zip(("O", "LSE", "dQ", "dK", "dV"),
                          (o, lse) + tuple(got), (o_ref, lse_ref) + want):
        if g.dim() == 3:
            assert not g[..., d:].any(), name
            g = g[..., :d]
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=1e-6 * float(w.abs().max()),
                                   err_msg=name)


def test_mask_arguments_are_validated():
    q = torch.zeros((1, 128, 2, 64))
    with pytest.raises(ValueError):
        tfa.flash_attention(q, q, q)
    m = torch.ones((1, 128), dtype=torch.int32)
    with pytest.raises(ValueError):
        tfa.flash_attention(q, q, q, kv_mask=m, segments=m)
    # Above the single-block bound the online regime serves the call.
    big = torch.zeros((1, 1024, 2, 64))
    out = tfa.flash_attention(big, big, big,
                              kv_mask=torch.ones((1, 1024), dtype=torch.int32))
    assert out.shape == big.shape


def test_build_target_hashes_shared_headers(tmp_path, monkeypatch):
    """The library's name covers every shared header of csrc/, so an edit
    to one builds a new library instead of loading a stale one (no nvcc
    needed: only the name is computed)."""
    from lddl_tpu_torch.ops import _build
    (tmp_path / "k.cu").write_bytes(b'#include "tiles.cuh"\n')
    header = tmp_path / "tiles.cuh"
    header.write_bytes(b"// v1\n")
    monkeypatch.setattr(_build, "_CSRC", str(tmp_path))
    src, first = _build._target("k")
    assert src == str(tmp_path / "k.cu")
    assert _build._target("k")[1] == first
    header.write_bytes(b"// v2\n")
    second = _build._target("k")[1]
    assert second != first
    (tmp_path / "other.cuh").write_bytes(b"// new header\n")
    assert _build._target("k")[1] not in (first, second)


def test_build_keeps_ptxas_report_of_cached_library(tmp_path, monkeypatch):
    """A second build of an unchanged source runs no compiler and still
    fills ``build_logs`` with the first build's ptxas report, kept beside
    the library; a library whose report is missing is built again. A shell
    script stands in for nvcc and counts its runs."""
    from lddl_tpu_torch.ops import _build
    (tmp_path / "k.cu").write_bytes(b"// kernel\n")
    runs = tmp_path / "runs"
    fake = tmp_path / "nvcc"
    fake.write_text('#!/bin/sh\necho run >> "{}"\n'
                    'while [ "$1" != "-o" ]; do shift; done\n'
                    'touch "$2"\necho "ptxas info: 0 bytes spill stores"\n'
                    .format(runs))
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "_CSRC", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "build_logs", {})
    path = _build.build(["k"])["k"]
    assert os.path.isfile(path)
    assert _build.build_logs == {"k": "ptxas info: 0 bytes spill stores\n"}
    _build.build_logs.clear()
    assert _build.build(["k"])["k"] == path
    assert _build.build_logs == {"k": "ptxas info: 0 bytes spill stores\n"}
    assert runs.read_text().count("run") == 1
    os.remove(path[:-len(".so")] + ".log")
    _build.build(["k"])
    assert runs.read_text().count("run") == 2
    assert _build.build_logs["k"] == "ptxas info: 0 bytes spill stores\n"


@pytest.mark.parametrize("source", sorted(tfa._ENTRY_POINTS))
def test_entry_points_match_c_sources(source):
    """Each C entry point of the ctypes table is defined in its source with
    that many pointer operands, then (BH, L_pad, H, D, scale, stream); the
    two forwards share one source and the online backward pair has its
    own with the single-block backward beside it; the two fp32 sources
    hold all five under the bf16 names with an _f32 suffix, the forwards
    in one 3xTF32 source (D=64, 128, and the online forward at 256), the
    backward in the other (D=64, 128, and the online pair at 256), and
    f32_source routes every fp32 entry point at every built width to one
    of them (no nvcc needed)."""
    import re
    from lddl_tpu_torch.ops import _build
    with open(os.path.join(_build._CSRC, source + ".cu")) as f:
        text = f.read()
    for entry, n_ptr in tfa._ENTRY_POINTS[source].items():
        m = re.search(r"\bint {}\(([^)]*)\)".format(entry), text)
        assert m, entry
        params = [" ".join(x.split()) for x in m.group(1).split(",")]
        assert all("void*" in x for x in params[:n_ptr]), params
        assert params[n_ptr:] == ["int BH", "int L", "int H", "int D",
                                  "float scale", "void* stream"], params
    f32_sources = (tfa.F32_FWD_SOURCE, tfa.F32_BWD_SOURCE)
    f32 = source in f32_sources
    if f32:
        bf16 = {e + "_f32": n for s in ("attention_fwd", "online_attention_bwd")
                for e, n in tfa._ENTRY_POINTS[s].items()}
        assert {e: n for s in f32_sources
                for e, n in tfa._ENTRY_POINTS[s].items()} == bf16
        assert (source == tfa.F32_BWD_SOURCE) == all(
            "_bwd" in e for e in tfa._ENTRY_POINTS[source])
        assert (source == tfa.F32_FWD_SOURCE) == (
            set(tfa._ENTRY_POINTS[source])
            == {"lddl_onekv_fwd_f32", "lddl_online_fwd_f32"})
        # The routing by width: every fp32 entry point at every width it
        # is built at lands in a 3xTF32 source, the online trio at D=256
        # too.
        for entry in ("lddl_online_bwd_dq_f32", "lddl_online_bwd_dkv_f32"):
            assert tfa.f32_source(entry, 256) == tfa.F32_BWD_SOURCE
        assert tfa.f32_source("lddl_online_fwd_f32", 256) == \
            tfa.F32_FWD_SOURCE
        assert set(tfa.F32_TF32_HEAD_DIMS) == set(bf16)
        for entry, widths in tfa.F32_TF32_HEAD_DIMS.items():
            assert widths == (tfa.KERNEL_HEAD_DIMS if "online" in entry
                              else (64, 128)), entry
            assert {tfa.f32_source(entry, w) for w in widths} <= \
                set(f32_sources), entry
    else:
        assert (source == "online_attention_bwd") == any(
            e.startswith("lddl_online_bwd")
            for e in tfa._ENTRY_POINTS[source])
        assert (source == "attention_fwd") == any(
            e.endswith("_fwd") for e in tfa._ENTRY_POINTS[source])
    # Each entry point dispatches the built widths: every width of
    # KERNEL_HEAD_DIMS for the online kernels, up to 128 for the
    # single-block ones (the reference's single-block regime stops there);
    # an fp32 entry point, those of them that f32_source routes to this
    # source.
    for entry in tfa._ENTRY_POINTS[source]:
        start = text.index("int {}(".format(entry))
        end = text.find("\n}", start)
        widths = tuple(int(w) for w in
                       re.findall(r"if \(D == (\d+)\)", text[start:end]))
        want = (tfa.KERNEL_HEAD_DIMS if "online" in entry
                else tuple(w for w in tfa.KERNEL_HEAD_DIMS if w <= 128))
        if f32:
            want = tuple(w for w in want
                         if tfa.f32_source(entry, w) == source)
        assert widths == want, (entry, widths)
        if entry == "lddl_online_fwd_f32":
            assert widths == (64, 128, 256)
        for w in widths:
            assert "<{}>".format(w) in text[start:end], (entry, w)


@pytest.mark.parametrize("entry, d", [("lddl_onekv_fwd_f32", 256),
                                      ("lddl_online_bwd_dq_f32", 32)])
def test_f32_source_raises_outside_built_widths(entry, d):
    """An fp32 entry point at a head dim it is not built for routes
    nowhere: f32_source raises, naming the built widths, where it once
    fell through to the SIMT source (no nvcc needed)."""
    with pytest.raises(ValueError, match=r"{} is built at head_dim "
                       r"64, 128.*not {}".format(entry, d)):
        tfa.f32_source(entry, d)


def _code(name):
    """The code of ``csrc/<name>``, comments stripped, lower case."""
    import re
    from lddl_tpu_torch.ops import _build
    with open(os.path.join(_build._CSRC, name)) as f:
        text = f.read()
    return re.sub(r"//[^\n]*|/\*.*?\*/", "", text, flags=re.S).lower()


@pytest.mark.parametrize("source, kernels", [
    (tfa.F32_FWD_SOURCE, ("onekv_fwd", "online_fwd")),
    (tfa.F32_BWD_SOURCE, ("onekv_bwd_dq", "onekv_bwd_dkv", "online_bwd_dq",
                          "online_bwd_dkv"))])
def test_f32_bwd_source_is_3xtf32_wgmma_without_atomics(source, kernels):
    """Each 3xTF32 fp32 source, the forwards' and the backward's, with the
    3xTF32 pieces it includes (``tf32x3_tiles.cuh``; comments stripped),
    takes its products on tf32 wgmma (``wgmma_ss_tf32`` and
    ``wgmma_rs_tf32``, whose m64nNk8 .tf32 instructions are in
    hopper_tiles.cuh) of operands split by ``split_tf32`` (cvt.rna:
    tests/test_torch_tf32x3.py emulates that split), uses expf (and the
    forward logf) and no fast-math intrinsic, no atomic operation, and
    instantiates its kernels under their bf16 names + _f32 (no nvcc
    needed). The online kernels of both are built at D=256 too, on the
    wide bodies: the item in fp32, its A fragments split at each product
    (``item_scores``), the tile split in place (``split_tile_inplace``)
    and the two warpgroups' score tiles swapped (``exchange_scores``).
    No fp32 source is FFMA-only: these two are every fp32 source in
    csrc/, and neither takes a product with fmaf."""
    import re
    from lddl_tpu_torch.ops import _build
    assert sorted(f for f in os.listdir(_build._CSRC)
                  if f.startswith("attention_f32") and f.endswith(".cu")) \
        == sorted((tfa.F32_FWD_SOURCE + ".cu", tfa.F32_BWD_SOURCE + ".cu"))
    own = _code(source + ".cu")
    assert '#include "tf32x3_tiles.cuh"' in own
    code = own + _code("tf32x3_tiles.cuh")
    header = _code("hopper_tiles.cuh")
    for word in ("atomic", "__expf", "__logf", "__fdividef",
                 "use_fast_math", "bf16", "mma.sync", "fmaf("):
        assert word not in code, word
    for word in ("wgmma_ss_tf32<", "wgmma_rs_tf32<", "split_tf32(", "expf("):
        assert word in code, word
    assert ("logf(" in own) == (source == tfa.F32_FWD_SOURCE)
    assert re.search(r"wgmma\.mma_async\.sync\.aligned\.m64n\w*k8"
                     r"\.f32\.tf32\.tf32", header)
    assert "cvt.rna.tf32.f32" in header
    for kernel in kernels:
        assert re.search(r"\b{}_f32_kernel\)".format(kernel), own), kernel
    for word in ("item_scores(", "split_tile_inplace(", "exchange_scores(",
                 "contract_wide("):
        assert word in own, word
    for kernel in kernels:
        assert ("{}_f32_kernel<256>".format(kernel) in own) == (
            kernel.startswith("online")), kernel



@pytest.mark.parametrize("d", [64, 128, 256])
def test_check_operands_takes_fp32(d):
    """The kernels' check takes fp32 operands, as bf16, at every built
    width: the single-block pair up to D=128, the online kernels at all."""
    m = torch.ones((2, 512), dtype=torch.int32)
    rows = [torch.zeros((4, 512))] * 2
    for dtype in tfa.KERNEL_DTYPES:
        t = torch.zeros((4, 512, d), dtype=dtype)
        assert tfa._check_operands([t] * 4, [m, m], rows, online=True) == 2
        if d <= 128:
            assert tfa._check_operands([t] * 3, [m, m], []) == 2


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_check_operands_refuses_other_dtypes(dtype):
    """fp16 and fp64 operands raise, naming their dtype and the built
    ones; a bf16/fp32 mix raises, naming both."""
    m = torch.ones((2, 512), dtype=torch.int32)
    t = torch.zeros((4, 512, 64), dtype=dtype)
    with pytest.raises(TypeError, match=r"bf16 and fp32.*{}".format(dtype)):
        tfa._check_operands([t] * 3, [m, m], [])
    bf16 = torch.zeros((4, 512, 64), dtype=torch.bfloat16)
    f32 = torch.zeros((4, 512, 64))
    for first, second in ((bf16, f32), (f32, bf16)):
        with pytest.raises(TypeError, match="{} operands.*got {}".format(
                first.dtype, second.dtype)):
            tfa._check_operands([first, second, first], [m, m], [])


@pytest.mark.parametrize("source", ["attention_fwd", "online_attention_bwd"])
def test_kernel_tile_width_matches_plain_walk(source):
    """The width of the tiles a kernel walks (STEP in its source) is the
    plain online versions' ONLINE_STEP, so their bf16 rounding of P and dS
    stays the kernel's (no nvcc needed)."""
    import re
    from lddl_tpu_torch.ops import _build
    with open(os.path.join(_build._CSRC, source + ".cu")) as f:
        text = f.read()
    widths = re.findall(r"constexpr int STEP = (\d+);", text)
    assert widths == [str(tfa.ONLINE_STEP)]
    # At D=256 the bodies split D between the consumer warpgroups and own
    # STEP rows (a block's queries, or a dK/dV item's keys): still whole
    # STEP-wide tiles, walked in the same order.
    split = re.findall(r"SPLIT \? (\w+) : ROWS;", text)
    assert split == ["STEP"], split
    assert re.search(r"SPLIT = (DKV && )?D == 256;", text)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels build with nvcc and "
                    "run only on the card (chip_smoke.py checks them there)")
    return torch.device("cuda")


CUDA_SHAPES = [(128, 64), (200, 64), (512, 64), (896, 64), (512, 128),
               (1024, 64), (2048, 64), (600, 128), (1024, 256), (600, 256)]
# (l, d, mask_kind, dtype name): the bf16 cases under their ids of old,
# the fp32 ones with an -f32 suffix.
CUDA_CASES = [pytest.param(l, d, kind, dtype, id="{}-{}-{}{}".format(
                  l, d, kind, "-f32" if dtype == "f32" else ""))
              for dtype in ("bf16", "f32") for l, d in CUDA_SHAPES
              for kind in ("padding", "segments")]
# Bars of a kernel against its plain version on the card: bf16 takes
# products in another order and rounds P and dS to bf16 at other places
# (2e-2 of max |ref| for O and the gradients, 1e-3 for the LSE); fp32
# differs in summation order alone (1e-5 of max |ref|, and 1e-5 absolute
# for the LSE).
CUDA_BARS = {"bf16": (2e-2, 1e-3), "f32": (1e-5, 1e-5)}


def _dtype(name):
    return {"bf16": torch.bfloat16, "f32": torch.float32}[name]


@pytest.mark.parametrize("l,d,mask_kind,dtype", CUDA_CASES)
def test_cuda_kernels_match_plain(cuda_device, l, d, mask_kind, dtype):
    """The CUDA kernels of the regime the shape takes against their plain
    versions on the card, in bf16 and in fp32 (CUDA_BARS). Masks:
    padding, or segment ids 1-3 with padding and the last batch row
    masked entirely (both masks). Every kernel gives bit-identical
    results in two launches."""
    g = torch.Generator(device=cuda_device).manual_seed(l + d)
    q, k, v, do = (torch.randn((4, l, 4, d), generator=g, device=cuda_device)
                   .to(_dtype(dtype)) for _ in range(4))
    mask = torch.ones((4, l), dtype=torch.int32, device=cuda_device)
    mask[1, l // 2:] = 0
    if mask_kind == "segments":
        mask *= torch.randint(1, 4, (4, l), generator=g, device=cuda_device,
                              dtype=torch.int32)
        mask[-1] = 0
    _check_cuda_kernels(q, k, v, do, mask, mask_kind == "segments",
                        *CUDA_BARS[dtype])


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_cuda_kernels_match_plain_packed_rows(cuda_device, dtype):
    """Packed rows at L=512, D=64: each row holds up to 8 samples as runs
    of segment ids 1-8 and a padded tail, the ids taken as both masks."""
    b, l, h, d = 4, 512, 4, 64
    g = torch.Generator(device=cuda_device).manual_seed(8)
    q, k, v, do = (torch.randn((b, l, h, d), generator=g, device=cuda_device)
                   .to(_dtype(dtype)) for _ in range(4))
    seg = torch.zeros((b, l), dtype=torch.int32, device=cuda_device)
    for r in range(b):
        cuts = torch.sort(torch.randint(1, l, (8,), generator=g,
                                        device=cuda_device)).values
        cols = torch.arange(l, device=cuda_device)
        seg[r] = 1 + (cols[:, None] >= cuts[None, :7]).sum(-1)
        seg[r, cuts[7]:] = 0
    assert int(seg.max()) == 8
    _check_cuda_kernels(q, k, v, do, seg, True, *CUDA_BARS[dtype])


def _check_cuda_kernels(q, k, v, do, mask, segments, bar, lse_bar):
    d = q.shape[-1]
    qb, kb, vb, maskb, qmaskb, shape = tfa._prep(
        q, k, v, mask, mask if segments else None)
    scale = 1.0 / d ** 0.5
    online = not tfa._use_onekv(shape[-1], d)
    if not online:
        fwd, fwd_plain = tfa.onekv_fwd, tfa.onekv_fwd_plain
        bwd, bwd_plain = tfa.onekv_bwd, tfa.onekv_bwd_plain
    else:
        fwd, fwd_plain = tfa.online_fwd, tfa.online_fwd_plain

        def bwd(*args):
            return (tfa.online_bwd_dq(*args),) + tfa.online_bwd_dkv(*args)

        def bwd_plain(*args):
            return ((tfa.online_bwd_dq_plain(*args),)
                    + tfa.online_bwd_dkv_plain(*args))
    o, lse = fwd(qb, kb, vb, maskb, qmaskb, scale)
    o_ref, lse_ref = fwd_plain(qb, kb, vb, maskb, qmaskb, scale)
    dob = tfa._prep_one(do, shape[-1])
    delta = (dob.float() * o_ref.float()).sum(-1)
    got = bwd(qb, kb, vb, maskb, qmaskb, dob, lse_ref, delta, scale)
    want = bwd_plain(qb, kb, vb, maskb, qmaskb, dob, lse_ref, delta, scale)
    torch.cuda.synchronize()

    def rel(a, r):
        return float((a.float() - r.float()).abs().max() / r.abs().max())

    assert rel(o, o_ref) <= bar
    if q.dtype == torch.float32:
        assert float((lse - lse_ref).abs().max()) <= lse_bar
    else:
        assert rel(lse, lse_ref) <= lse_bar
    o_again, lse_again = fwd(qb, kb, vb, maskb, qmaskb, scale)
    assert torch.equal(o, o_again) and torch.equal(lse, lse_again)
    for a, r in zip(got, want):
        assert rel(a, r) <= bar
    again = bwd(qb, kb, vb, maskb, qmaskb, dob, lse_ref, delta, scale)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("l", [512, 1024])
def test_cuda_f32_flash_launches_f32_kernels(cuda_device, l):
    """fp32 flash_attention on the card, forward and backward, launches
    the fp32 builds of its regime's kernels once each (L=512 the
    single-block pair, L=1024 the online trio) and no bf16 kernel; the
    output and gradients are fp32."""
    g = torch.Generator(device=cuda_device).manual_seed(l)
    q, k, v, do = (torch.randn((2, l, 4, 64), generator=g,
                               device=cuda_device) for _ in range(4))
    mask = torch.ones((2, l), dtype=torch.int32, device=cuda_device)
    mask[1, l // 3:] = 0
    names = ("onekv_fwd", "onekv_bwd", "online_fwd", "online_bwd_dq",
             "online_bwd_dkv")
    before = {n: (getattr(tfa, n).launches, getattr(tfa, n).launches_f32)
              for n in names}
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    out = tfa.flash_attention(qg, kg, vg, kv_mask=mask)
    grads = torch.autograd.grad(out, (qg, kg, vg), do)
    torch.cuda.synchronize()
    moved = {n: (getattr(tfa, n).launches - before[n][0],
                 getattr(tfa, n).launches_f32 - before[n][1])
             for n in names}
    want = names[:2] if l == 512 else names[2:]
    assert moved == {n: (0, int(n in want)) for n in names}
    assert out.dtype == torch.float32
    assert all(t.dtype == torch.float32 for t in grads)
