"""The port's checkpoints (lddl_tpu_torch.models.checkpoint): a roundtrip
into a model and optimizer built from another seed restores every leaf,
and the resumed step is bit-identical to the uninterrupted one with
dropout on (dropout is a function of (seed, update count) alone); keep
prunes the oldest steps; a missing checkpoint raises; a save that fails
between its write and its publish leaves the previous step as the
latest; and a reference TrainState after 2 steps, carried across by
convert.load_flax_train_state, takes a third port step equal to the
reference's third step (fp32, dropout 0): metrics at 1e-5, params at
2e-5, as in test_torch_train.py.
"""

import os

import numpy as np
import pytest

import jax
import torch

from lddl_tpu_torch.models import (BertConfig, BertForPreTraining,
                                   make_optimizer, make_train_step)
from lddl_tpu_torch.models import checkpoint as ckpt_mod
from lddl_tpu_torch.models.checkpoint import (latest_step,
                                              restore_train_state,
                                              save_train_state)
from lddl_tpu_torch.testing import fake_pretrain_batch

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _setup(seed, mu_dtype=None, **cfg_kw):
    cfg = BertConfig.tiny(dtype=torch.float32, attention_impl="dense",
                          **cfg_kw)
    torch.manual_seed(seed)
    model = BertForPreTraining(cfg)
    opt = make_optimizer(model.parameters(), learning_rate=1e-3,
                         warmup_steps=1, total_steps=10, mu_dtype=mu_dtype)
    return model, opt, make_train_step(model, opt)


def _batch(seed=0):
    b = fake_pretrain_batch(512, 4, 32, seed=seed, segment_split=True)
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _optimizer_leaves(model, opt):
    names = {p: n for n, p in model.named_parameters()}
    return {(names[p], k): v for p in opt.params
            for k, v in opt.optimizer.state[p].items()}


def test_checkpoint_roundtrip_and_exact_resume(tmp_path):
    """Dropout on (hidden and attention 0.1): the restored step equals the
    live one bit for bit, whatever ran on the global RNG in between."""
    ckpt = str(tmp_path / "ckpt")
    model, opt, step = _setup(0)
    batch = _batch()
    for _ in range(2):
        step(batch, seed=0)
    assert save_train_state(ckpt, model, opt, 2) == 2
    assert latest_step(ckpt) == 2

    fresh, fresh_opt, fresh_step = _setup(99)
    assert not torch.equal(fresh.embeddings.word_embeddings.weight,
                           model.embeddings.word_embeddings.weight)
    assert restore_train_state(ckpt, fresh, fresh_opt) == 2
    for (name, a), b in zip(model.state_dict().items(),
                            fresh.state_dict().values()):
        assert torch.equal(a, b), name
    live, restored = (_optimizer_leaves(model, opt),
                      _optimizer_leaves(fresh, fresh_opt))
    assert live.keys() == restored.keys()
    for key in live:
        assert torch.equal(live[key], restored[key]), key
    assert fresh_opt.step_count == opt.step_count == 2
    assert fresh_opt.get_last_lr() == opt.get_last_lr()

    torch.manual_seed(12345)      # the global stream must not matter
    m_resumed = fresh_step(batch, seed=0)
    torch.rand(1000)
    m_straight = step(batch, seed=0)
    assert float(m_resumed["loss"]) == float(m_straight["loss"])
    for (name, a), b in zip(model.state_dict().items(),
                            fresh.state_dict().values()):
        assert torch.equal(a, b), name

    # Dropout is on: another seed draws other masks.
    other = _setup(0)[2]
    other(batch, seed=0)
    other(batch, seed=0)
    assert float(other(batch, seed=1)["loss"]) != float(m_straight["loss"])


def test_checkpoint_keeps_a_bf16_first_moment(tmp_path):
    """make_optimizer(mu_dtype=bf16): the first moment is saved and
    restored in bf16, into an optimizer that has not stepped yet, and the
    resumed step equals the live one bit for bit."""
    ckpt = str(tmp_path / "ckpt")
    model, opt, step = _setup(0, mu_dtype=torch.bfloat16)
    batch = _batch()
    for _ in range(2):
        step(batch, seed=0)
    save_train_state(ckpt, model, opt, 2)
    fresh, fresh_opt, fresh_step = _setup(99, mu_dtype=torch.bfloat16)
    assert restore_train_state(ckpt, fresh, fresh_opt) == 2
    live, restored = (_optimizer_leaves(model, opt),
                      _optimizer_leaves(fresh, fresh_opt))
    for key in live:
        assert live[key].dtype == restored[key].dtype, key
        assert torch.equal(live[key], restored[key]), key
    assert {v.dtype for (_, k), v in live.items() if k == "exp_avg"} == {
        torch.bfloat16}
    assert float(fresh_step(batch, seed=0)["loss"]) == float(
        step(batch, seed=0)["loss"])
    for (name, a), b in zip(model.state_dict().items(),
                            fresh.state_dict().values()):
        assert torch.equal(a, b), name


def test_checkpoint_keep_prunes_old_steps(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    model, opt, step = _setup(0)
    batch = _batch()
    for i in range(1, 5):
        step(batch, seed=0)
        save_train_state(ckpt, model, opt, i, keep=2)
    assert latest_step(ckpt) == 4
    assert {d for d in os.listdir(ckpt) if d.isdigit()} == {"3", "4"}
    with pytest.raises(FileExistsError):
        save_train_state(ckpt, model, opt, 4)


def test_restore_missing_raises(tmp_path):
    model, opt, _ = _setup(0)
    assert latest_step(str(tmp_path / "none")) is None
    assert not os.path.exists(tmp_path / "none")
    with pytest.raises(FileNotFoundError):
        restore_train_state(str(tmp_path / "none"), model, opt)
    save_train_state(str(tmp_path / "ckpt"), model, opt, 1)
    with pytest.raises(FileNotFoundError):
        restore_train_state(str(tmp_path / "ckpt"), model, opt, step=2)


def test_interrupted_publish_keeps_previous_step(tmp_path, monkeypatch):
    """A crash between the write and the publish (the publish raises):
    the previous step stays the latest and restores, and no partial step
    directory is left behind."""
    ckpt = str(tmp_path / "ckpt")
    model, opt, step = _setup(0)
    batch = _batch()
    step(batch, seed=0)
    save_train_state(ckpt, model, opt, 1)
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    step(batch, seed=0)

    def crash(tmp_path_, path):
        assert os.path.isdir(tmp_path_) and os.listdir(tmp_path_)
        raise OSError("crash before the rename")

    monkeypatch.setattr(ckpt_mod, "atomic_publish", crash)
    with pytest.raises(OSError, match="crash"):
        save_train_state(ckpt, model, opt, 2)
    monkeypatch.undo()
    assert latest_step(ckpt) == 1
    assert sorted(os.listdir(ckpt)) == ["1"]
    fresh, fresh_opt, _ = _setup(7)
    assert restore_train_state(ckpt, fresh, fresh_opt) == 1
    for name, v in fresh.state_dict().items():
        assert torch.equal(v, saved[name]), name
    assert fresh_opt.step_count == 1


def test_jax_train_state_resumes_in_port():
    import optax
    from lddl_tpu.loader import to_device_batch
    from lddl_tpu.models import BertConfig as JBertConfig
    from lddl_tpu.models import create_train_state, make_sharded_train_step
    from lddl_tpu.models.train import make_optimizer as j_make
    from lddl_tpu.parallel import make_mesh
    from lddl_tpu_torch.models.convert import (flax_to_state_dict,
                                               load_flax_train_state)
    kw = dict(vocab_size=512, hidden_dropout=0.0, attention_dropout=0.0,
              attention_impl="dense")
    jcfg = JBertConfig.tiny(dtype=jax.numpy.float32, **kw)
    batches = [fake_pretrain_batch(512, 4, 32, seed=s, segment_split=True)
               for s in range(3)]
    mesh = make_mesh({"dp": 1}, devices=jax.devices()[:1])
    opt_kw = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10)
    state, _ = create_train_state(jcfg, mesh, batches[0], seed=0,
                                  optimizer=j_make(**opt_kw))
    j_step = make_sharded_train_step(mesh, jcfg, donate=False)
    for b in batches[:2]:
        state, _ = j_step(state, to_device_batch(b, mesh), seed=0)

    host = jax.device_get(state)
    adam = [s for s in jax.tree_util.tree_leaves(
        host.opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    assert len(adam) == 1 and int(host.step) == int(adam[0].count) == 2
    model = BertForPreTraining(BertConfig.tiny(dtype=torch.float32, **kw))
    opt = make_optimizer(model.parameters(), **opt_kw)
    load_flax_train_state(model, opt, host.params, adam[0].mu, adam[0].nu,
                          int(adam[0].count))
    assert opt.step_count == 2

    state, j_metrics = j_step(state, to_device_batch(batches[2], mesh),
                              seed=0)
    t_metrics = make_train_step(model, opt)(
        {k: torch.from_numpy(v) for k, v in batches[2].items()})
    assert set(t_metrics) == set(j_metrics)
    for k in j_metrics:
        np.testing.assert_allclose(float(t_metrics[k]), float(j_metrics[k]),
                                   rtol=TOL, atol=1e-6, err_msg=k)
    want = flax_to_state_dict(jax.device_get(state.params))
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=0,
                                   atol=2e-5, err_msg=name)
