"""The port's BERT (lddl_tpu_torch.models) against lddl_tpu's flax model
with the same (converted) parameters.

Tolerances: fp32 logits agree to 1e-5 (absolute and relative), at tiny
and at bert_base's widths: both sides run the same fp32 products and
differ only in summation order and in the LayerNorm variance formula.
The bf16 case is held to 5e-2 of max |ref|: both take the dense softmax
in bf16, rounded at the same places (``test_dense_softmax_rounds_like_
flax``), but every layer rounds its activations to bf16 at slightly
different places.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from lddl_tpu.models import BertConfig as JBertConfig
from lddl_tpu.models import BertForPreTraining as JBert
from lddl_tpu_torch.models import BertConfig, BertForPreTraining
from lddl_tpu_torch.models.convert import (flax_to_state_dict,
                                           state_dict_to_flax)
from lddl_tpu_torch.testing import fake_pretrain_batch

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _cfgs(**kw):
    kw.setdefault("max_position_embeddings", 256)
    kw.setdefault("hidden_dropout", 0.0)
    kw.setdefault("attention_dropout", 0.0)
    jdtype = kw.pop("jdtype", jnp.float32)
    tdtype = kw.pop("tdtype", torch.float32)
    return (JBertConfig.tiny(dtype=jdtype, **kw),
            BertConfig.tiny(dtype=tdtype, **kw))


def _batch(vocab, b, l, seed):
    batch = fake_pretrain_batch(vocab, b, l, seed=seed)
    batch["attention_mask"][1, l - l // 3:] = 0     # a padded row
    batch["token_type_ids"][:, l // 2:] = 1
    return batch


def _flax_params(jcfg, batch, seed=0):
    import flax.linen as nn
    variables = JBert(jcfg).init(
        jax.random.PRNGKey(seed), batch["input_ids"],
        batch["token_type_ids"], batch["attention_mask"])
    return jax.device_get(nn.meta.unbox(variables)["params"])


def _port_model(tcfg, params):
    model = BertForPreTraining(tcfg)
    model.load_state_dict(flax_to_state_dict(params), strict=True)
    return model.eval()


def _port_logits(model, batch, **kw):
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        mlm, nsp = model(t["input_ids"], t["token_type_ids"],
                         t["attention_mask"], **kw)
    return mlm.float().numpy(), nsp.float().numpy()


def test_convert_round_trip():
    jcfg, tcfg = _cfgs()
    params = _flax_params(jcfg, _batch(jcfg.vocab_size, 2, 32, 0))
    model = _port_model(tcfg, params)       # strict: every name and shape
    back = state_dict_to_flax(model.state_dict())
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b) == len(model.state_dict())
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(leaf), flat_b[path])
    # Dense kernels transpose, embeddings and LayerNorm scales do not.
    sd = model.state_dict()
    np.testing.assert_array_equal(
        sd["layer_0.attention.query.weight"].numpy(),
        np.asarray(params["layer_0"]["attention"]["query"]["kernel"]).T)
    np.testing.assert_array_equal(
        sd["embeddings.word_embeddings.weight"].numpy(),
        np.asarray(params["embeddings"]["word_embeddings"]["embedding"]))
    np.testing.assert_array_equal(
        sd["mlm_norm.weight"].numpy(), np.asarray(params["mlm_norm"]["scale"]))


@pytest.mark.parametrize("impl,l", [("dense", 96), ("dense", 256),
                                    ("flash", 256), ("flash", 200)])
def test_logits_match_flax(impl, l):
    """fp32 logits at tiny, with padded rows; L_pad 256 is a kernel bin."""
    jcfg, tcfg = _cfgs(attention_impl=impl)
    batch = _batch(jcfg.vocab_size, 3, l, seed=l)
    params = _flax_params(jcfg, batch, seed=1)
    j_mlm, j_nsp = JBert(jcfg).apply(
        {"params": params}, batch["input_ids"], batch["token_type_ids"],
        batch["attention_mask"], deterministic=True)
    t_mlm, t_nsp = _port_logits(_port_model(tcfg, params), batch)
    np.testing.assert_allclose(t_mlm, np.asarray(j_mlm), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(t_nsp, np.asarray(j_nsp), rtol=TOL, atol=TOL)


def test_logits_match_flax_bert_base():
    """fp32 logits at bert_base's widths (vocab 30522, hidden 768, 12
    layers, 12 heads) at B=2, L=128 with a padded row, the flax weights
    through the converter: within the tiny cases' TOL."""
    kw = dict(hidden_dropout=0.0, attention_dropout=0.0)
    jcfg = JBertConfig.bert_base(dtype=jnp.float32, **kw)
    tcfg = BertConfig.bert_base(dtype=torch.float32, **kw)
    batch = _batch(jcfg.vocab_size, 2, 128, seed=11)
    params = _flax_params(jcfg, batch, seed=3)
    j_mlm, j_nsp = JBert(jcfg).apply(
        {"params": params}, batch["input_ids"], batch["token_type_ids"],
        batch["attention_mask"], deterministic=True)
    t_mlm, t_nsp = _port_logits(_port_model(tcfg, params), batch)
    np.testing.assert_allclose(t_mlm, np.asarray(j_mlm), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(t_nsp, np.asarray(j_nsp), rtol=TOL, atol=TOL)


def test_auto_selects_flash_only_where_the_reference_does():
    from lddl_tpu.models.attention import resolve_auto_impl as j_resolve
    from lddl_tpu_torch.models.attention import resolve_auto_impl
    for l in (64, 128, 129, 256, 384, 512, 600, 896, 1000, 1024, 1152,
              2048):
        for d in (64, 128):
            for dropout, det in ((0.0, False), (0.1, False), (0.1, True)):
                for ok in (True, False):
                    assert (resolve_auto_impl(l, ok, dropout, det, head_dim=d)
                            == j_resolve(l, ok, dropout, det, head_dim=d))


def test_bf16_logits_close_to_flax():
    """bf16 activations over fp32 params through the flash path."""
    jcfg, tcfg = _cfgs(attention_impl="auto", jdtype=jnp.bfloat16,
                       tdtype=torch.bfloat16)
    batch = _batch(jcfg.vocab_size, 2, 256, seed=5)
    params = _flax_params(jcfg, batch, seed=2)
    j_mlm, j_nsp = JBert(jcfg).apply(
        {"params": params}, batch["input_ids"], batch["token_type_ids"],
        batch["attention_mask"], deterministic=True)
    t_mlm, t_nsp = _port_logits(_port_model(tcfg, params), batch)
    for got, want in ((t_mlm, j_mlm), (t_nsp, j_nsp)):
        want = np.asarray(want, np.float32)
        assert np.abs(got - want).max() <= 5e-2 * np.abs(want).max()


@pytest.mark.parametrize("b,l,hidden,heads", [(2, 64, 128, 2),
                                              (2, 200, 256, 4)])
def test_dense_attention_bf16_close_to_flax(b, l, hidden, heads):
    """The dense MultiHeadAttention in bf16 against flax's on the same
    inputs, parameters and padding mask: within 2e-2 of max |ref| (bf16
    products and a bf16 softmax on both sides; the products round at
    different places). The
    probabilities the backward keeps are bf16, as flax's: no fp32
    [B, H, L, L] copy is made."""
    import flax.linen as nn
    from lddl_tpu.models.attention import MultiHeadAttention as JAttention
    from lddl_tpu_torch.models.attention import MultiHeadAttention

    g = np.random.default_rng(l)
    x = g.standard_normal((b, l, hidden)).astype(np.float32)
    mask = np.ones((b, l), np.int32)
    mask[1, l - l // 3:] = 0                      # a padded row
    jattn = JAttention(hidden, heads, dtype=jnp.bfloat16)
    params = jax.device_get(nn.meta.unbox(jattn.init(
        jax.random.PRNGKey(l), x, x, mask, True))["params"])
    want = np.asarray(jattn.apply({"params": params}, x, x, mask, True),
                      np.float32)
    attn = MultiHeadAttention(hidden, heads, dtype=torch.bfloat16)
    attn.load_state_dict(flax_to_state_dict(params), strict=True)
    attn.eval()
    xt, mt = torch.from_numpy(x), torch.from_numpy(mask)
    with torch.no_grad():
        got = attn(xt, xt, mt).float().numpy()
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()

    saved = []

    def keep(t):
        saved.append((tuple(t.shape), t.dtype))
        return t

    with torch.autograd.graph.saved_tensors_hooks(keep, lambda t: t):
        attn(xt, xt, mt)
    probs = [dtype for shape, dtype in saved if shape == (b, heads, l, l)]
    assert probs and all(dtype == torch.bfloat16 for dtype in probs), saved


@pytest.mark.parametrize("b,l,hidden,heads", [(2, 64, 128, 2),
                                              (2, 200, 256, 4)])
def test_dense_softmax_rounds_like_flax(b, l, hidden, heads):
    """The dense path's softmax against flax's ``nn.softmax`` on the same
    bf16 scores plus the -1e9 bias of a padded row, at the shapes of
    test_dense_attention_bf16_close_to_flax: the largest difference in
    bf16 ulps is printed and held to 1. Flax rounds x - max, its exp, the
    sum (accumulated in fp32) and the quotient to bf16; the port's
    ``softmax`` rounds at the same four places (0 ulps measured here),
    where ``torch.softmax``, which rounds once, was 14 and 17 ulps off."""
    import flax.linen as nn
    from lddl_tpu_torch.models.attention import softmax

    g = np.random.default_rng(l)
    scores = 3 * g.standard_normal((b, heads, l, l)).astype(np.float32)
    mask = np.ones((b, l), np.int32)
    mask[1, l - l // 3:] = 0
    bias = np.where(mask[:, None, None, :] > 0, 0.0, -1e9).astype(np.float32)
    want = np.asarray(nn.softmax(jnp.asarray(scores, jnp.bfloat16)
                                 + jnp.asarray(bias, jnp.bfloat16), axis=-1))
    x = (torch.from_numpy(scores).to(torch.bfloat16)
         + torch.from_numpy(bias).to(torch.bfloat16))
    got = softmax(x)
    assert got.dtype == torch.bfloat16

    def bits(a):        # the probabilities are >= 0: bits order as values
        return torch.as_tensor(np.asarray(a, np.float32)).to(
            torch.bfloat16).view(torch.int16).numpy().astype(np.int32)

    ulps = int(np.abs(bits(got.float().numpy()) - bits(want)).max())
    print("dense softmax vs flax: max {} bf16 ulps".format(ulps))
    assert ulps <= 1


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_attention_mask_blocks_padding(impl):
    """Padding positions must not influence unpadded outputs."""
    _, tcfg = _cfgs(attention_impl=impl)
    torch.manual_seed(0)
    model = BertForPreTraining(tcfg).eval()
    b = _batch(tcfg.vocab_size, 2, 16, seed=2)
    b["attention_mask"][:] = 1
    b["attention_mask"][:, 12:] = 0
    mlm1, _ = _port_logits(model, b)
    b["input_ids"][:, 12:] = 1   # scramble the padding content
    mlm2, _ = _port_logits(model, b)
    np.testing.assert_allclose(mlm1[:, :12], mlm2[:, :12], atol=TOL)


def test_mlm_gather_matches_dense_head():
    """The gathered MLM head gives the full head's logits at the masked
    columns, and the same loss and gradients (unmasked logits never enter
    the loss); a row above the cap drops and counts its excess."""
    from lddl_tpu_torch.models.train import (_mlm_gather_of, mlm_gather_cap,
                                             pretrain_loss)
    _, tcfg = _cfgs()
    batch = {k: torch.from_numpy(v)
             for k, v in _batch(tcfg.vocab_size, 4, 64, seed=3).items()}
    torch.manual_seed(0)
    model = BertForPreTraining(tcfg).eval()
    results = []
    for gather in (True, False):
        model.zero_grad()
        args = (batch["input_ids"], batch["token_type_ids"],
                batch["attention_mask"])
        labels = batch["labels"]
        kw = {}
        if gather:
            pos, labels, dropped = _mlm_gather_of(batch)
            assert int(dropped) == 0
            kw = {"masked_positions": pos}
        mlm, nsp = model(*args, **kw)
        loss, metrics = pretrain_loss(mlm, nsp, labels,
                                      batch["next_sentence_labels"])
        loss.backward()
        metrics = {k: float(v.detach()) for k, v in metrics.items()}
        results.append((metrics, [p.grad.clone() for p in model.parameters()],
                        mlm.detach(), kw))
    (m_g, g_g, mlm_g, kw), (m_f, g_f, mlm_f, _) = results
    for k in m_f:
        np.testing.assert_allclose(m_g[k], m_f[k], rtol=TOL,
                                   atol=1e-6, err_msg=k)
    for a, b in zip(g_g, g_f):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=TOL, atol=1e-6)
    pos = kw["masked_positions"]
    idx = pos[:, :, None].expand(-1, -1, mlm_f.shape[-1])
    np.testing.assert_allclose(mlm_g.numpy(),
                               torch.gather(mlm_f, 1, idx).numpy(),
                               rtol=TOL, atol=TOL)

    labels = torch.zeros((2, 64), dtype=torch.int32)   # every column masked
    cap = mlm_gather_cap(64)
    pos, gathered, dropped = _mlm_gather_of({"labels": labels})
    assert pos.shape == (2, cap) and gathered.shape == (2, cap)
    assert int(dropped) == 2 * (64 - cap)


def test_fp32_auto_flash_step_matches_dense_and_flax(monkeypatch):
    """A small fp32 BertConfig with attention_impl="auto" at L=512: auto
    resolves to flash (the single-block pair; head dim 16, zero-padded to
    64), and the train step runs it in every layer. The step's loss and
    gradients (learning rate 0 and no clipping, so the parameters stay as
    they are and the gradients are the raw ones) agree with the same
    model's dense step within 1e-5 relative (loss, global norm; each
    gradient within 1e-5 of the largest), and with the flax model's at
    fp32 ("auto" too) within the same bars. The fp32 products differ
    only in summation order."""
    from lddl_tpu.models.train import bert_batch_loss as j_loss
    from lddl_tpu_torch.models import make_optimizer, make_train_step
    from lddl_tpu_torch.models.attention import resolve_auto_impl
    from lddl_tpu_torch.ops import flash_attention as tfa

    l = 512
    jcfg, tcfg = _cfgs(attention_impl="auto", max_position_embeddings=l,
                       mlm_gather=False)
    head_dim = tcfg.hidden_size // tcfg.num_heads
    assert resolve_auto_impl(l, True, 0.0, False, head_dim=head_dim) == \
        "flash"
    batch = _batch(jcfg.vocab_size, 2, l, seed=13)
    params = _flax_params(jcfg, batch, seed=4)
    model = _port_model(tcfg, params)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}

    calls = []
    plain = tfa.onekv_fwd_plain
    monkeypatch.setattr(tfa, "onekv_fwd_plain",
                        lambda *a: calls.append(1) or plain(*a))
    results = {}
    for impl in ("auto", "dense"):
        for i in range(tcfg.num_layers):
            getattr(model, "layer_{}".format(i)).attention.attention_impl = \
                impl
        opt = make_optimizer(model.parameters(), learning_rate=0.0,
                             clip_norm=float("inf"))
        loss = float(make_train_step(model, opt)(tbatch)["loss"])
        results[impl] = (loss, {n: p.grad.clone()
                                for n, p in model.named_parameters()})
    assert len(calls) == tcfg.num_layers       # auto took flash, once a layer

    def j_objective(p):
        out = JBert(jcfg).apply({"params": p}, batch["input_ids"],
                                batch["token_type_ids"],
                                batch["attention_mask"], deterministic=True)
        return j_loss(out, batch)[0]

    j_value, j_grads = jax.value_and_grad(j_objective)(params)
    results["flax"] = (float(j_value), {
        n: torch.from_numpy(np.asarray(g)) for n, g in
        flax_to_state_dict(jax.device_get(j_grads)).items()})

    loss, grads = results["auto"]
    norm = float(torch.linalg.vector_norm(
        torch.stack([g.norm() for g in grads.values()])))
    top = max(float(g.abs().max()) for g in grads.values())
    for ref in ("dense", "flax"):
        ref_loss, ref_grads = results[ref]
        assert set(ref_grads) == set(grads)
        assert abs(loss - ref_loss) <= 1e-5 * abs(ref_loss), ref
        ref_norm = float(torch.linalg.vector_norm(
            torch.stack([g.norm() for g in ref_grads.values()])))
        assert abs(norm - ref_norm) <= 1e-5 * ref_norm, ref
        for name, g in grads.items():
            np.testing.assert_allclose(g.numpy(), ref_grads[name].numpy(),
                                       rtol=0, atol=1e-5 * top,
                                       err_msg="{} {}".format(ref, name))
