"""The rest of the port's train step (lddl_tpu_torch.models.train): the
multi-step equals single steps bit for bit with dropout on (each step
folds the seed with its own update count); the eval step's metrics match
lddl_tpu's make_eval_step, and it warns once when the gather's cap drops
labels; cfg.mlm_gather=False runs the full head, as the reference does;
cfg.remat=True gives the same loss and gradients as remat=False for BERT
and BART, dropout on (the recompute draws the same masks).

Tolerances: fp32 metrics 1e-5 against the reference (same math, other
summation order). Multi-step against single steps and remat against no
remat are exact: the same operations run on the same inputs.
"""

import warnings

import numpy as np
import pytest

import jax
import torch

from lddl_tpu_torch.models import (BartConfig, BartForPreTraining,
                                   BertConfig, BertForPreTraining,
                                   bart_batch_loss, make_eval_step,
                                   make_multi_step, make_optimizer,
                                   make_train_step)
from lddl_tpu_torch.models.convert import flax_to_state_dict
from lddl_tpu_torch.testing import fake_bart_batch, fake_pretrain_batch

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _model(seed, **kw):
    kw.setdefault("attention_impl", "dense")
    torch.manual_seed(seed)
    model = BertForPreTraining(BertConfig.tiny(dtype=torch.float32, **kw))
    return model, make_optimizer(model.parameters(), learning_rate=1e-3,
                                 warmup_steps=2, total_steps=20)


def test_multi_step_matches_single_steps():
    """The counterpart of tests/test_models.py's
    test_multi_step_matches_single_steps, with dropout on."""
    n = 3
    batches = [fake_pretrain_batch(512, 4, 32, seed=100 + i)
               for i in range(n)]
    model, opt = _model(0)
    step = make_train_step(model, opt)
    single = [step(_tensors(b), seed=7) for b in batches]

    model2, opt2 = _model(0)
    multi = make_multi_step(model2, opt2, n)
    stacked = _tensors({k: np.stack([b[k] for b in batches])
                        for k in batches[0]})
    metrics = multi(stacked, seed=7)
    assert opt2.step_count == n
    assert set(metrics) == set(single[0])
    for k in metrics:
        assert metrics[k].shape == (n,)
        assert torch.equal(metrics[k], torch.stack([m[k] for m in single]))
    losses = [float(m["loss"]) for m in single]
    assert len(set(losses)) == n
    for a, b in zip(model.state_dict().values(),
                    model2.state_dict().values()):
        assert torch.equal(a, b)


def _reference_eval(jcfg, params, batch):
    from lddl_tpu.loader import to_device_batch
    from lddl_tpu.models import make_eval_step as j_make_eval
    from lddl_tpu.parallel import make_mesh
    mesh = make_mesh({"dp": 1}, devices=jax.devices()[:1])
    return j_make_eval(mesh, jcfg)(params, to_device_batch(batch, mesh))


def _flax_params(jcfg, batch):
    import flax.linen as nn
    from lddl_tpu.models import BertForPreTraining as JBert
    variables = JBert(jcfg).init(
        jax.random.PRNGKey(0), batch["input_ids"], batch["token_type_ids"],
        batch["attention_mask"])
    return jax.device_get(nn.meta.unbox(variables)["params"])


@pytest.mark.parametrize("mlm_gather", [True, False])
def test_eval_step_matches_reference(mlm_gather):
    """Eval metrics equal the reference's with the gathered head and with
    ``mlm_gather=False`` (the full head: no masked_positions reach the
    model and no dropped-label count is reported). Dropout is configured
    on, and eval mode turns it off on both sides."""
    from lddl_tpu.models import BertConfig as JBertConfig
    kw = dict(vocab_size=512, attention_impl="dense", mlm_gather=mlm_gather)
    jcfg = JBertConfig.tiny(dtype=jax.numpy.float32, **kw)
    batch = fake_pretrain_batch(512, 4, 64, seed=3, segment_split=True)
    params = _flax_params(jcfg, batch)
    want = _reference_eval(jcfg, params, batch)

    model = BertForPreTraining(BertConfig.tiny(dtype=torch.float32, **kw))
    model.load_state_dict(flax_to_state_dict(params))
    seen = []
    model.register_forward_hook(
        lambda mod, args, kwargs, out: seen.append(sorted(kwargs)),
        with_kwargs=True)
    got = make_eval_step(model)(_tensors(batch))
    assert model.training          # the step restores the mode it found
    assert seen == [["masked_positions"] if mlm_gather else []]
    assert set(got) == set(want)
    assert ("mlm_dropped_labels" in got) == mlm_gather
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=TOL,
                                   atol=1e-6, err_msg=k)


def test_train_step_without_gather_runs_full_head():
    model, opt = _model(0, mlm_gather=False)
    seen = []
    model.register_forward_hook(
        lambda mod, args, kwargs, out: seen.append(out[0].shape),
        with_kwargs=True)
    metrics = make_train_step(model, opt)(
        _tensors(fake_pretrain_batch(512, 4, 64, seed=1)))
    assert "mlm_dropped_labels" not in metrics
    assert seen == [(4, 64, 512)]


def test_eval_step_warns_when_labels_dropped():
    model, _ = _model(0)
    eval_step = make_eval_step(model)
    batch = fake_pretrain_batch(512, 2, 64, seed=2)
    batch["labels"] = batch["input_ids"].copy()    # every column masked
    with pytest.warns(RuntimeWarning, match="mlm_gather=False"):
        metrics = eval_step(_tensors(batch))
    assert int(metrics["mlm_dropped_labels"]) > 0
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        eval_step(_tensors(batch))                 # warns once only


def _loss_and_grads(model, batch, loss_fn, seed):
    model.train()
    model.zero_grad()
    with torch.random.fork_rng():
        torch.manual_seed(seed)
        loss = loss_fn(model(*(batch[k] for k in model.BATCH_INPUTS)),
                       batch)[0]
        loss.backward()
    return loss.detach(), [p.grad.clone() for p in model.parameters()]


@pytest.mark.parametrize("family", ["bert", "bart"])
def test_remat_matches_no_remat(family):
    """The counterpart of tests/test_models.py's
    test_remat_same_loss_and_grads, for both families, dropout on."""
    from lddl_tpu_torch.models.train import bert_batch_loss
    results = []
    for remat in (False, True):
        torch.manual_seed(0)
        if family == "bert":
            model = BertForPreTraining(BertConfig.tiny(
                dtype=torch.float32, attention_impl="dense", remat=remat))
            batch, loss_fn = (fake_pretrain_batch(512, 2, 32, seed=5),
                              bert_batch_loss)
        else:
            model = BartForPreTraining(BartConfig.tiny(
                dtype=torch.float32, attention_impl="dense", remat=remat))
            batch, loss_fn = fake_bart_batch(512, 2, 32, seed=5), \
                bart_batch_loss
        results.append(_loss_and_grads(model, _tensors(batch), loss_fn, 3))
    (loss_a, grads_a), (loss_b, grads_b) = results
    assert torch.equal(loss_a, loss_b)
    for a, b in zip(grads_a, grads_b):
        assert torch.equal(a, b)
