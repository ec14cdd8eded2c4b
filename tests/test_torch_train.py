"""The port's train step (lddl_tpu_torch.models.train) against lddl_tpu's:
loss and metrics, the learning-rate schedule, and the slice as a whole —
the same shards through both packages' loaders into three fp32 train
steps (tiny BERT, dropout 0, attention_impl="flash"), compared after
every step with make_sharded_train_step on a 1-device CPU mesh.

Tolerances: loss and metrics 1e-5 (fp32, same math, other summation
order); learning rates 1e-6 relative (optax evaluates its schedule in
fp32, the port in fp64); one optimizer update 1e-6 absolute (the update
is lr * m / (sqrt(v) + eps), 1e-2 here, and the two libraries order its
fp32 operations differently, which shows at ~1e-5 relative where eps is
not negligible); parameters 2e-5 absolute after each step: AdamW
normalizes each update to about the learning rate (1e-3 here), so a
relative gradient difference of 1e-5 moves a parameter by ~1e-8, and
the bound leaves room for gradients that are zero up to rounding.
"""

import numpy as np
import pytest

import jax
import torch

from lddl_tpu_torch.models import BertConfig, BertForPreTraining
from lddl_tpu_torch.models.convert import flax_to_state_dict
from lddl_tpu_torch.models.train import (make_optimizer, make_train_step,
                                         pretrain_loss)

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def test_pretrain_loss_and_metrics_match_reference():
    from lddl_tpu.models.train import pretrain_loss as j_loss
    g = np.random.default_rng(0)
    mlm = g.standard_normal((3, 24, 50)).astype(np.float32)
    nsp = g.standard_normal((3, 2)).astype(np.float32)
    labels = g.integers(0, 50, (3, 24)).astype(np.int32)
    labels[g.random((3, 24)) < 0.7] = -1
    labels[0, :] = -1                      # a row with nothing masked
    nsl = g.integers(0, 2, (3,)).astype(np.int32)
    mlm[1, 3, labels[1, 3]] = 9.0 if labels[1, 3] >= 0 else 0.0
    j, jm = j_loss(mlm, nsp, labels, nsl)
    t, tm = pretrain_loss(*(torch.from_numpy(a)
                            for a in (mlm, nsp, labels, nsl)))
    assert set(tm) == set(jm)
    np.testing.assert_allclose(float(t), float(j), rtol=TOL)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=TOL,
                                   atol=1e-7, err_msg=k)


def test_learning_rates_follow_optax_schedule():
    """The rate of the n-th update is optax's schedule(n): the first update
    runs at schedule(0) = 0."""
    import optax
    warmup, total, lr = 3, 12, 2e-3
    sched = optax.warmup_cosine_decay_schedule(0.0, lr, warmup, total)
    p = torch.nn.Parameter(torch.ones(3))
    opt = make_optimizer([p], learning_rate=lr, warmup_steps=warmup,
                         total_steps=total)
    for n in range(total + 3):
        assert opt.get_last_lr() == pytest.approx(float(sched(n)), rel=1e-6,
                                                  abs=1e-12)
        p.grad = torch.ones(3)
        opt.step()


def test_optimizer_update_matches_optax():
    """One clipped AdamW update per step on random gradients, above and
    below the clip norm."""
    import optax
    from lddl_tpu.models.train import make_optimizer as j_make
    g = np.random.default_rng(1)
    w0 = g.standard_normal((4, 5)).astype(np.float32)
    tx = j_make(learning_rate=1e-2, warmup_steps=1, total_steps=6)
    params = {"w": w0}
    state = tx.init(params)
    p = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt = make_optimizer([p], learning_rate=1e-2, warmup_steps=1,
                         total_steps=6)
    for step in range(5):
        grad = (g.standard_normal((4, 5)) * (3.0 if step % 2 else 0.05)
                ).astype(np.float32)
        updates, state = tx.update({"w": grad}, state, params)
        params = optax.apply_updates(params, updates)
        p.grad = torch.from_numpy(grad.copy())
        opt.step()
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(params["w"]), rtol=1e-6,
                                   atol=1e-6)


def test_optimizer_mu_dtype_matches_optax():
    """make_optimizer(mu_dtype=bf16): three clipped updates against optax's
    adamw(mu_dtype=bfloat16) on the same gradients, and the stored first
    moments equal bit for bit (bf16: the same fp32 moment rounded once)."""
    import jax.numpy as jnp
    import optax
    from lddl_tpu.models.train import make_optimizer as j_make
    g = np.random.default_rng(2)
    w0 = g.standard_normal((4, 5)).astype(np.float32)
    tx = j_make(learning_rate=1e-2, warmup_steps=1, total_steps=6,
                mu_dtype=jnp.bfloat16)
    params = {"w": w0}
    state = tx.init(params)
    p = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt = make_optimizer([p], learning_rate=1e-2, warmup_steps=1,
                         total_steps=6, mu_dtype=torch.bfloat16)
    for step in range(3):
        grad = (g.standard_normal((4, 5)) * (3.0 if step % 2 else 0.05)
                ).astype(np.float32)
        updates, state = tx.update({"w": grad}, state, params)
        params = optax.apply_updates(params, updates)
        p.grad = torch.from_numpy(grad.copy())
        opt.step()
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(params["w"]), rtol=1e-6,
                                   atol=1e-6)
        mu = opt.optimizer.state[p]["exp_avg"]
        assert mu.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            mu.float().numpy(),
            np.asarray(state[1][0].mu["w"], np.float32))
        np.testing.assert_allclose(
            opt.optimizer.state[p]["exp_avg_sq"].numpy(),
            np.asarray(state[1][0].nu["w"]), rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("mu_dtype,want", [(None, torch.float32),
                                           (torch.bfloat16, torch.bfloat16)])
def test_optimizer_mu_dtype_opt_in(mu_dtype, want):
    """The counterpart of tests/test_models.py's mu_dtype test: the first
    moment is stored in mu_dtype (fp32 by default), the second in fp32,
    and a train step of tiny BERT is finite."""
    from lddl_tpu_torch.testing import fake_pretrain_batch
    cfg = BertConfig.tiny()
    torch.manual_seed(0)
    model = BertForPreTraining(cfg)
    opt = make_optimizer(model.parameters(), warmup_steps=1, total_steps=5,
                         mu_dtype=mu_dtype)
    batch = {k: torch.from_numpy(v) for k, v in
             fake_pretrain_batch(cfg.vocab_size, 8, 32).items()}
    metrics = make_train_step(model, opt)(batch)
    assert np.isfinite(float(metrics["loss"]))
    for p in model.parameters():
        state = opt.optimizer.state[p]
        assert state["exp_avg"].dtype == want
        assert state["exp_avg_sq"].dtype == torch.float32
        assert torch.isfinite(p).all()


def test_optimizer_mu_dtype_none_is_torch_adamw():
    """mu_dtype=None keeps torch's foreach AdamW: the same update, bit for
    bit, as the optimizer built without the argument."""
    g = np.random.default_rng(3)
    w0 = g.standard_normal((6, 3)).astype(np.float32)
    ps = [torch.nn.Parameter(torch.from_numpy(w0.copy())) for _ in range(2)]
    opts = [make_optimizer([ps[0]], learning_rate=1e-2, warmup_steps=1,
                           total_steps=6),
            make_optimizer([ps[1]], learning_rate=1e-2, warmup_steps=1,
                           total_steps=6, mu_dtype=None)]
    assert type(opts[1].optimizer) is torch.optim.AdamW
    for _ in range(3):
        grad = g.standard_normal((6, 3)).astype(np.float32)
        for p, opt in zip(ps, opts):
            p.grad = torch.from_numpy(grad.copy())
            opt.step()
        assert torch.equal(ps[0], ps[1])


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    from lddl_tpu_torch.testing import write_balanced_shards, write_vocab
    root = tmp_path_factory.mktemp("train_shards")
    vocab = str(root / "vocab.txt")
    tokens = write_vocab(vocab, 512, seed=3)
    write_balanced_shards(str(root / "bal"), tokens, num_bins=2,
                          bin_size=32, shards_per_bin=2,
                          samples_per_shard=12, masking=True, seed=3)
    return str(root / "bal"), vocab


def test_three_train_steps_match_reference(shards):
    """The slice as a whole: shards -> each package's loader -> 3 steps."""
    from lddl_tpu.loader import get_bert_pretrain_data_loader as j_loader
    from lddl_tpu.loader import to_device_batch
    from lddl_tpu.models import BertConfig as JBertConfig
    from lddl_tpu.models import create_train_state, make_sharded_train_step
    from lddl_tpu.models.train import make_optimizer as j_make
    from lddl_tpu.parallel import make_mesh
    from lddl_tpu_torch.loader import get_bert_pretrain_data_loader

    path, vocab = shards
    kw = dict(batch_size=4, fixed_seq_lengths=[32, 64], vocab_file=vocab,
              shuffle_buffer_size=16, shuffle_buffer_warmup_factor=2,
              base_seed=5)
    j_batches = list(j_loader(path, **kw))[:3]
    t_batches = list(get_bert_pretrain_data_loader(path, **kw))[:3]
    for jb, tb in zip(j_batches, t_batches):
        assert jb.keys() == tb.keys()
        for k in jb:
            np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)

    cfg_kw = dict(vocab_size=512, max_position_embeddings=64,
                  hidden_dropout=0.0, attention_dropout=0.0,
                  attention_impl="flash")
    jcfg = JBertConfig.tiny(dtype=jax.numpy.float32, **cfg_kw)
    tcfg = BertConfig.tiny(dtype=torch.float32, **cfg_kw)
    mesh = make_mesh({"dp": 1}, devices=jax.devices()[:1])
    opt_kw = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10)
    state, _ = create_train_state(jcfg, mesh, j_batches[0], seed=0,
                                  optimizer=j_make(**opt_kw))
    j_step = make_sharded_train_step(mesh, jcfg, donate=False)

    model = BertForPreTraining(tcfg)
    model.load_state_dict(flax_to_state_dict(jax.device_get(state.params)))
    t_step = make_train_step(model, make_optimizer(model.parameters(),
                                                   **opt_kw))
    for i, (jb, tb) in enumerate(zip(j_batches, t_batches)):
        state, j_metrics = j_step(state, to_device_batch(jb, mesh), seed=0)
        t_metrics = t_step({k: torch.from_numpy(v) for k, v in tb.items()})
        assert set(t_metrics) == set(j_metrics)
        for k in j_metrics:
            np.testing.assert_allclose(float(t_metrics[k]),
                                       float(j_metrics[k]), rtol=TOL,
                                       atol=1e-6,
                                       err_msg="step {} {}".format(i, k))
        want = flax_to_state_dict(jax.device_get(state.params))
        for name, p in model.state_dict().items():
            np.testing.assert_allclose(p.numpy(), want[name].numpy(),
                                       rtol=0, atol=2e-5,
                                       err_msg="step {} {}".format(i, name))
