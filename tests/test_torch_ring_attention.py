"""The port's ring attention (lddl_tpu_torch.ops.ring_attention) in
spawned sp=2 and sp=4 gloo worlds on the CPU, the counterparts of
tests/test_ring_attention.py: the forward and the gradients on inputs
with ragged padding (one ring block fully padded), held to the port's
dense_attention_reference and to lddl_tpu's ring_attention on the same
inputs; tiny BERT's and BART's logits under attention_impl="ring" held to
the dense models with the same weights (BERT's also to lddl_tpu's dense
model); two sharded train steps with ring attention held to the port's
unsharded steps; and packed segments refused under ring.

Tolerances (fp32): attention outputs and gradients 2e-5 and 2e-4, the
reference's own bars; logits 5e-4, the reference's bar for the model
with ring against dense; train-step losses 1e-4 relative.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from lddl_tpu_torch.parallel import run_world
from lddl_tpu_torch.parallel import testing as ptest

CFG = dict(vocab_size=128, hidden_size=32, num_heads=4,
           intermediate_size=64, max_position_embeddings=64,
           dtype=torch.float32, hidden_dropout=0.0, attention_dropout=0.0)
BERT = dict(CFG, num_layers=2)
BART = dict(CFG, num_encoder_layers=2, num_decoder_layers=1)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _inputs(seed=0, b=4, l=32, h=4, d=16):
    g = np.random.default_rng(seed)
    q, k, v, grad = (g.standard_normal((b, l, h, d)).astype(np.float32)
                     for _ in range(4))
    # Ragged validity incl. one fully-padded ring block (cols 24..31 of
    # row 0) to hit the all-masked-block path.
    mask = np.ones((b, l), np.int32)
    mask[0, 20:] = 0
    mask[1, 29:] = 0
    return q, k, v, grad, mask


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    from lddl_tpu_torch.models import (BartConfig, BartForPreTraining,
                                       BertConfig, BertForPreTraining)
    q, k, v, grad, mask = _inputs()
    g = np.random.default_rng(7)
    data = {"q": q, "k": k, "v": v, "g": grad, "mask": mask,
            "ids": g.integers(5, 128, (4, 32)).astype(np.int64),
            "dec": g.integers(5, 128, (4, 32)).astype(np.int64),
            "typ": np.repeat([[0] * 16 + [1] * 16], 4, 0).astype(np.int64),
            "am": mask}
    torch.manual_seed(0)
    models = {"bert": BertForPreTraining(BertConfig(attention_impl="dense",
                                                    **BERT)).eval(),
              "bart": BartForPreTraining(BartConfig(attention_impl="dense",
                                                    **BART)).eval()}
    for kind, model in models.items():
        for name, t in model.state_dict().items():
            data["{}.{}".format(kind, name)] = t.numpy()
    path = str(tmp_path_factory.mktemp("ring") / "inputs.npz")
    np.savez(path, **data)
    return path, data, models


@pytest.fixture(scope="module", params=[2, 4], ids=["sp2", "sp4"])
def world(request, inputs):
    path, _, _ = inputs
    sp = request.param
    return sp, run_world(sp, ptest.ring_world, path, BERT, BART,
                         device="cpu")


def _blocks(world, key):
    return np.concatenate([r[key] for r in world], axis=1)


def test_ring_matches_dense_forward(world, inputs):
    from lddl_tpu.ops.ring_attention import ring_attention
    from lddl_tpu.parallel import compat, make_mesh
    from lddl_tpu_torch.ops.ring_attention import dense_attention_reference
    sp, res = world
    _, data, _ = inputs
    out = _blocks(res, "out")
    ref = dense_attention_reference(
        *(torch.from_numpy(data[n]) for n in ("q", "k", "v", "mask")))
    np.testing.assert_allclose(out, ref.numpy(), rtol=2e-5, atol=2e-5)
    mesh = make_mesh({"sp": sp}, devices=jax.devices()[:sp])
    with compat.set_mesh(mesh):
        j = jax.jit(lambda *a: ring_attention(*a, mesh=mesh))(
            *(jnp.asarray(data[n]) for n in ("q", "k", "v", "mask")))
    np.testing.assert_allclose(out, np.asarray(j), rtol=2e-5, atol=2e-5)


def test_ring_matches_dense_gradients(world, inputs):
    from lddl_tpu.ops.ring_attention import ring_attention
    from lddl_tpu.parallel import compat, make_mesh
    from lddl_tpu_torch.ops.ring_attention import dense_attention_reference
    sp, res = world
    _, data, _ = inputs
    q, k, v = (torch.from_numpy(data[n]).requires_grad_() for n in "qkv")
    out = dense_attention_reference(q, k, v, torch.from_numpy(data["mask"]))
    (out * torch.from_numpy(data["g"])).sum().backward()
    mesh = make_mesh({"sp": sp}, devices=jax.devices()[:sp])
    mask = jnp.asarray(data["mask"])
    g = jnp.asarray(data["g"])

    def loss(q, k, v):
        return (ring_attention(q, k, v, mask, mesh=mesh) * g).sum()

    with compat.set_mesh(mesh):
        j_grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
            *(jnp.asarray(data[n]) for n in "qkv"))
    for name, t, jg in zip(("dq", "dk", "dv"), (q, k, v), j_grads):
        got = _blocks(res, name)
        np.testing.assert_allclose(got, t.grad.numpy(), rtol=2e-4,
                                   atol=2e-4, err_msg=name)
        np.testing.assert_allclose(got, np.asarray(jg), rtol=2e-4,
                                   atol=2e-4, err_msg=name)


def test_bert_ring_matches_dense_logits(world, inputs):
    from lddl_tpu.models import BertConfig as JBertConfig
    from lddl_tpu.models import BertForPreTraining as JBert
    from lddl_tpu_torch.models.convert import state_dict_to_flax
    sp, res = world
    _, data, models = inputs
    ids, typ, am = (torch.from_numpy(data[n]) for n in ("ids", "typ", "am"))
    with torch.no_grad():
        mlm_d, nsp_d = models["bert"](ids, typ, am)
    mlm_r, nsp_r = res[0]["bert"]
    np.testing.assert_allclose(mlm_r, mlm_d.numpy(), rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(nsp_r, nsp_d.numpy(), rtol=5e-4, atol=5e-4)
    jcfg = JBertConfig(attention_impl="dense", **dict(BERT,
                                                      dtype=jnp.float32))
    params = state_dict_to_flax(models["bert"].state_dict())
    mlm_j, nsp_j = JBert(jcfg).apply(
        {"params": jax.tree.map(jnp.asarray, params)},
        *(np.asarray(data[n], np.int32) for n in ("ids", "typ", "am")),
        deterministic=True)
    np.testing.assert_allclose(mlm_r, np.asarray(mlm_j), rtol=5e-4,
                               atol=5e-4)
    np.testing.assert_allclose(nsp_r, np.asarray(nsp_j), rtol=5e-4,
                               atol=5e-4)


def test_bart_encoder_ring_matches_dense(world, inputs):
    """The encoder's self-attention rides the ring; the decoder's causal
    self-attention and the cross-attention stay dense."""
    sp, res = world
    _, data, models = inputs
    with torch.no_grad():
        ref = models["bart"](*(torch.from_numpy(data[n])
                               for n in ("ids", "am", "dec")))
    np.testing.assert_allclose(res[0]["bart"], ref.numpy(), rtol=5e-4,
                               atol=5e-4)


def test_packed_segments_under_ring_raise(world):
    _, res = world
    for r in res:
        assert r["packed"] is not None and "segments" in r["packed"]


@pytest.mark.parametrize("mesh", [{"sp": 2}, {"sp": 4}, {"dp": 2, "sp": 2}],
                         ids=["sp2", "sp4", "dp2_sp2"])
def test_ring_train_step_matches_unsharded(mesh, tmp_path):
    from lddl_tpu_torch.models import (BertConfig, BertForPreTraining,
                                       make_optimizer, make_train_step)
    from lddl_tpu_torch.testing import fake_pretrain_batch
    torch.manual_seed(0)
    model = BertForPreTraining(BertConfig(attention_impl="dense", **BERT))
    params = str(tmp_path / "params.npz")
    np.savez(params, **{k: v.numpy() for k, v in model.state_dict().items()})
    batches = [fake_pretrain_batch(128, 4, 32, seed=s, segment_split=True)
               for s in range(2)]
    for b in batches:
        b["attention_mask"][0, 20:] = 0
    path = str(tmp_path / "batches.npz")
    np.savez(path, **{k: np.stack([b[k] for b in batches])
                      for k in batches[0]})
    opt = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10)
    step = make_train_step(model, make_optimizer(model.parameters(), **opt))
    want = [float(step({k: torch.from_numpy(v) for k, v in b.items()})
                  ["loss"]) for b in batches]
    world = int(np.prod(list(mesh.values())))
    cfg = dict(BERT, attention_impl="ring")
    res = run_world(world, ptest.train_world, dict(
        mesh=mesh, cfg=cfg, params=params, batches=path, opt=opt, steps=2),
        device="cpu")
    got = [m["loss"] for m in res[0]["metrics"]]
    assert all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-4)
