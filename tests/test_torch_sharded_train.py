"""The port's sharded training (lddl_tpu_torch.models: create_train_state,
make_sharded_train_step, make_sharded_multi_step, make_eval_step(mesh=),
the checkpoints) in spawned gloo worlds of 4 (and 8) ranks on the CPU.

- Parity with lddl_tpu: tiny BERT, the same initial params carried across
  by flax_to_state_dict, the same global batch split by dp coordinate,
  dropout 0, three steps (the first at learning rate 0, the schedule's
  count 0) on {fsdp: 2, tp: 2}, {dp: 2, sp: 2} and {dp: 2, tp: 2}, each
  against lddl_tpu's create_train_state + make_sharded_train_step on the
  same mesh of virtual CPU devices. The port runs the single-block
  attention path (its plain version here) and lddl_tpu the dense one:
  with dropout 0 they compute the same function.
- The three places where one device and a world differ, each with data
  that differs across ranks: dp ranks with unequal masked-label counts
  (global denominators), an engaged global-norm clip (the norm of the
  unsharded gradients), and dropout 0.1 on {dp: 2, tp: 2, sp: 2} (tp
  peers draw equal masks and stay identical, dp and sp ranks draw
  different masks).
- The first update's unsharded gradients and every update's clip norm
  against the one-device step's, on {fsdp: 2, tp: 2} and {dp: 2, sp: 2},
  and the same check failing on a planted fault (gradients averaged over
  the data ranks): AdamW is blind to a gradient scaled by a constant, so
  losses and parameters alone cannot see a second average.
- The counterpart of test_mesh_portability_same_loss, the sharded eval
  and multi step, and a world-4 checkpoint whose restored next step is
  bit-identical to the live one.

Bars: losses and metrics 1e-4 relative at fp32 compute dtype, and the
reference's own 2e-2 at bf16 (tests/test_models.py). Gradients at fp32:
every clip norm within 1e-4 relative, and the first update's gradients
within 1e-4 of the global norm in the global norm of their difference.
Parameters at fp32:
all but one element in 10^4 within 2e-5 absolute per step taken (the bar
of tests/test_torch_train.py), and every element within what AdamW's
updates can move it (the learning rate per update, twice): AdamW
normalises each update to about the learning rate, so a gradient that is
zero up to rounding (the key biases, to which softmax is invariant, or
an embedding row whose contributions cancel) moves by an amount that
depends on the summation order.
"""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from lddl_tpu_torch.parallel import run_world
from lddl_tpu_torch.parallel import testing as ptest

RTOL, BF16_RTOL, PARAM_ATOL_PER_STEP, GRAD_RTOL = 1e-4, 2e-2, 2e-5, 1e-4
STEPS = 3
OPT = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10)
CFG = dict(vocab_size=512, max_position_embeddings=64, hidden_dropout=0.0,
           attention_dropout=0.0)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _batches(n=STEPS, b=8, l=64):
    from lddl_tpu_torch.testing import fake_pretrain_batch
    out = []
    for s in range(n):
        batch = fake_pretrain_batch(CFG["vocab_size"], b, l, seed=s,
                                    segment_split=True)
        batch["attention_mask"][1, 40:] = 0
        batch["attention_mask"][6, 52:] = 0
        out.append(batch)
    return out


def _save(path, batches):
    np.savez(path, **{k: np.stack([b[k] for b in batches])
                      for k in batches[0]})
    return str(path)


def _jax_run(mesh_axes, dtype, batches):
    """lddl_tpu's sharded steps on ``mesh_axes``: (initial params, metrics
    per step, params after the steps)."""
    from lddl_tpu.loader import to_device_batch
    from lddl_tpu.models import BertConfig as JBertConfig
    from lddl_tpu.models import create_train_state, make_sharded_train_step
    from lddl_tpu.models.train import make_optimizer as j_make
    from lddl_tpu.parallel import make_mesh
    n = int(np.prod(list(mesh_axes.values())))
    mesh = make_mesh(mesh_axes, devices=jax.devices()[:n])
    cfg = JBertConfig.tiny(dtype=dtype, attention_impl="dense", **CFG)
    state, _ = create_train_state(cfg, mesh, batches[0], seed=0,
                                  optimizer=j_make(**OPT))
    initial = jax.device_get(state.params)
    step = make_sharded_train_step(mesh, cfg, donate=False)
    metrics = []
    for b in batches:
        state, m = step(state, to_device_batch(b, mesh), seed=0)
        metrics.append({k: float(v) for k, v in m.items()})
    return initial, metrics, jax.device_get(state.params)


def _assert_params(got, want_sd, steps):
    assert set(got) == set(want_sd)
    beyond, total = 0, 0
    for name, value in want_sd.items():
        diff = np.abs(got[name] - value)
        assert diff.max() <= 2 * OPT["learning_rate"] * steps, name
        beyond += int((diff > PARAM_ATOL_PER_STEP * steps).sum())
        total += diff.size
    assert beyond <= total * 1e-4, (beyond, total)


def _assert_grads(got, want):
    """Every update's clip norm and the first update's unsharded
    gradients (``parallel.testing.record_clip``) against the one-device
    run's, at GRAD_RTOL of the global norm."""
    np.testing.assert_allclose(got["norms"], want["norms"], rtol=GRAD_RTOL)
    assert set(got["grads"]) == set(want["grads"])
    diff = math.sqrt(sum(float(np.square(got["grads"][k] - v).sum())
                         for k, v in want["grads"].items()))
    assert diff <= GRAD_RTOL * want["norms"][0], (diff, want["norms"][0])


def _assert_metrics(got, want, rtol):
    for g, w in zip(got, want):
        assert set(w) <= set(g)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=1e-6,
                                       err_msg=k)


PARITY = [({"fsdp": 2, "tp": 2}, "float32"), ({"dp": 2, "sp": 2}, "float32"),
          ({"dp": 2, "tp": 2}, "float32"), ({"fsdp": 2, "tp": 2}, "bfloat16")]


@pytest.mark.parametrize("mesh,dtype", PARITY,
                         ids=["fsdp2_tp2", "dp2_sp2", "dp2_tp2",
                              "fsdp2_tp2_bf16"])
def test_sharded_steps_match_reference(mesh, dtype, tmp_path):
    from lddl_tpu_torch.models.convert import flax_to_state_dict
    batches = _batches()
    initial, j_metrics, j_params = _jax_run(mesh, getattr(jnp, dtype),
                                            batches)
    params = str(tmp_path / "params.npz")
    np.savez(params, **{k: v.numpy() for k, v in
                        flax_to_state_dict(initial).items()})
    res = run_world(4, ptest.train_world, dict(
        mesh=mesh, cfg=dict(CFG, dtype=getattr(torch, dtype),
                            attention_impl="flash"),
        params=params, batches=_save(tmp_path / "batches.npz", batches),
        opt=OPT, steps=STEPS), device="cpu")
    # FSDP makes every parameter a DTensor; tp alone only the projections.
    types = (["DTensor"] if "fsdp" in mesh else
             ["DTensor", "Parameter"] if "tp" in mesh else ["Parameter"])
    for r in res:
        assert r["param_types"] == types
        # The single-block kernels' route: 2 layers x STEPS forwards.
        assert r["kernel_calls"] == 2 * STEPS
    if dtype == "bfloat16":
        _assert_metrics(res[0]["metrics"],
                        [{"loss": m["loss"]} for m in j_metrics], BF16_RTOL)
        return
    _assert_metrics(res[0]["metrics"], j_metrics, RTOL)
    _assert_params(res[0]["params"], {k: v.numpy() for k, v in
                                      flax_to_state_dict(j_params).items()},
                   STEPS)


def _unsharded(batches, tmp_path, clip_norm=1.0, extra=None, mu_dtype=None,
               **cfg):
    """The port's one-device steps on the global batches from seed-0
    weights (saved to ``params.npz``): (metrics, params, out), ``out``
    holding every update's clip norm and the first update's gradients,
    and, with ``extra``, a multi-step run and an eval step."""
    from lddl_tpu_torch.models import (BertConfig, BertForPreTraining,
                                       make_eval_step, make_multi_step,
                                       make_optimizer, make_train_step)
    torch.manual_seed(0)
    model = BertForPreTraining(BertConfig.tiny(**dict(
        CFG, dtype=torch.float32, attention_impl="flash", **cfg)))
    np.savez(tmp_path / "params.npz",
             **{k: v.numpy() for k, v in model.state_dict().items()})
    opt = make_optimizer(model.parameters(), clip_norm=clip_norm,
                         mu_dtype=mu_dtype, **OPT)
    out = {}
    ptest.record_clip(model, opt, out)
    step = make_train_step(model, opt)
    tensors = [{k: torch.from_numpy(v) for k, v in b.items()}
               for b in batches]
    metrics = [{k: float(v) for k, v in step(b).items()} for b in tensors]
    if extra:
        multi = make_multi_step(model, opt, 2)(
            {k: torch.stack([b[k] for b in tensors[:2]]) for k in tensors[0]})
        out["multi"] = {k: v.numpy() for k, v in multi.items()}
        out["eval"] = {k: float(v) for k, v in
                       make_eval_step(model)(tensors[0]).items()}
    params = {k: v.detach().numpy() for k, v in model.named_parameters()}
    return metrics, params, out


def _world(mesh, batches, tmp_path, **spec):
    n = int(np.prod(list(mesh.values())))
    cfg = dict(CFG, dtype=torch.float32, attention_impl="flash")
    cfg.update(spec.pop("cfg", {}))
    return run_world(n, ptest.train_world, dict(
        mesh=mesh, cfg=cfg, params=str(tmp_path / "params.npz"),
        batches=_save(tmp_path / "batches.npz", batches), opt=OPT,
        steps=len(batches), **spec), device="cpu")


def test_unequal_masked_label_counts_across_dp_ranks(tmp_path):
    """dp block 0 holds ~8x the masked labels of block 1: the loss's
    denominators must be the global batch's, and the gradient reduction
    a sum, for the sharded steps to equal the one-device steps."""
    batches = _batches()
    g = np.random.default_rng(5)
    for b in batches:
        ids = b["input_ids"]
        b["labels"][:4] = np.where(g.random((4, ids.shape[1])) < 0.6,
                                   ids[:4], -1)
        b["labels"][4:] = np.where(g.random((4, ids.shape[1])) < 0.06,
                                   ids[4:], -1)
        counts = [(b["labels"][:4] != -1).sum(), (b["labels"][4:] != -1)
                  .sum()]
        assert counts[0] > 5 * counts[1] > 0
    want, want_params, grads = _unsharded(batches, tmp_path,
                                          mlm_gather=False)
    res = _world({"dp": 2, "tp": 2}, batches, tmp_path,
                 cfg={"mlm_gather": False})
    _assert_metrics(res[0]["metrics"], want, RTOL)
    _assert_grads(res[0], grads)
    _assert_params(res[0]["params"], want_params,
                   STEPS)


def test_low_precision_first_moment_matches_unsharded(tmp_path):
    """mu_dtype=torch.bfloat16 (LowMuAdamW: the first Adam moment stored
    in bf16) on {fsdp: 2, tp: 2} against the one-device run with the
    same option: metrics, clip norms and first gradients, and the
    parameters within the _assert_params bars after every step. Those
    bars are wider than what bf16 moments change against fp32 ones (a
    few 1e-5 after three steps), so every rank must also hold its first
    moments in bf16."""
    batches = _batches()
    want, want_params, grads = _unsharded(batches, tmp_path,
                                          mu_dtype=torch.bfloat16)
    res = run_world(4, ptest.train_world, dict(
        mesh={"fsdp": 2, "tp": 2},
        cfg=dict(CFG, dtype=torch.float32, attention_impl="flash"),
        params=str(tmp_path / "params.npz"),
        batches=_save(tmp_path / "batches.npz", batches),
        opt=dict(OPT, mu_dtype=torch.bfloat16), steps=STEPS), device="cpu")
    assert [r["moment_dtypes"] for r in res] == [["torch.bfloat16"]] * 4
    _assert_metrics(res[0]["metrics"], want, RTOL)
    _assert_grads(res[0], grads)
    _assert_params(res[0]["params"], want_params, STEPS)


def test_engaged_clip_takes_the_unsharded_norm(tmp_path):
    batches = _batches()
    clip = 0.05
    _, unclipped, _ = _unsharded(batches, tmp_path, clip_norm=1e9)
    want, want_params, grads = _unsharded(batches, tmp_path,
                                          clip_norm=clip)
    assert max(np.abs(unclipped[k] - want_params[k]).max()
               for k in want_params) > 1e-4, "the clip did not engage"
    assert min(grads["norms"]) > clip
    spec_opt = dict(OPT, clip_norm=clip)
    res = run_world(4, ptest.train_world, dict(
        mesh={"fsdp": 2, "tp": 2},
        cfg=dict(CFG, dtype=torch.float32, attention_impl="flash"),
        params=str(tmp_path / "params.npz"),
        batches=_save(tmp_path / "batches.npz", batches), opt=spec_opt,
        steps=STEPS), device="cpu")
    _assert_metrics(res[0]["metrics"], want, RTOL)
    _assert_grads(res[0], grads)
    _assert_params(res[0]["params"], want_params,
                   STEPS)


@pytest.mark.parametrize("fault", [None, "averaged_grads"],
                         ids=["summed", "planted_average"])
@pytest.mark.parametrize("mesh", [{"fsdp": 2, "tp": 2}, {"dp": 2, "sp": 2}],
                         ids=["fsdp2_tp2", "dp2_sp2"])
def test_first_step_gradients_match_unsharded(mesh, fault, tmp_path):
    """The gradients the optimizer gets, unsharded, and every clip norm
    equal the one-device step's on the global batch; with the gradient
    reduction made an average (``planted_average``) the same check must
    fail."""
    batches = _batches()
    want, _, grads = _unsharded(batches, tmp_path)
    res = _world(mesh, batches, tmp_path, fault=fault)
    for r in res:
        if fault is None:
            _assert_metrics(r["metrics"], want, RTOL)
            _assert_grads(r, grads)
        else:
            with pytest.raises(AssertionError):
                _assert_grads(r, grads)


def test_dropout_masks_follow_the_mesh(tmp_path):
    """{dp: 2, tp: 2, sp: 2}, rank = 4 dp + 2 tp + sp: tp peers (rank ^ 2)
    draw the same embedding-dropout masks and hold bit-identical
    parameters after two steps; sp peers (rank ^ 1) and dp peers (rank ^
    4) draw different ones."""
    batches = _batches(2)
    _unsharded(batches[:1], tmp_path)          # writes params.npz
    res = _world({"dp": 2, "tp": 2, "sp": 2}, batches, tmp_path,
                 cfg={"hidden_dropout": 0.1, "attention_dropout": 0.1,
                      "attention_impl": "dense"},
                 record_dropout=True)
    for r in range(8):
        masks = res[r]["dropout_masks"]
        assert len(masks) == 2 and masks[0].mean() > 0.8
        np.testing.assert_array_equal(masks[0], res[r ^ 2]["dropout_masks"][0])
        assert (masks[0] != res[r ^ 1]["dropout_masks"][0]).any()
        assert (masks[0] != res[r ^ 4]["dropout_masks"][0]).any()
        assert (masks[0] != masks[1]).any()
        for name, value in res[0]["params"].items():
            np.testing.assert_array_equal(res[r]["params"][name], value,
                                          err_msg=name)
    assert all(np.isfinite(m["loss"]) for m in res[0]["metrics"])


def test_sharded_eval_and_multi_step(tmp_path):
    batches = _batches()
    want, want_params, extra = _unsharded(batches, tmp_path, extra=True)
    res = _world({"fsdp": 2, "tp": 2}, batches, tmp_path, multi=2,
                 eval=True)
    _assert_metrics(res[0]["metrics"], want, RTOL)
    _assert_grads(res[0], extra)
    for k, v in extra["multi"].items():
        np.testing.assert_allclose(res[0]["multi"][k], v, rtol=RTOL,
                                   atol=1e-6, err_msg=k)
    _assert_metrics([res[0]["eval"]], [extra["eval"]], RTOL)
    _assert_params(res[0]["params"], want_params,
                   STEPS + 2)


def test_mesh_portability_same_loss(tmp_path):
    """The same weights give the same eval loss (bf16) on every mesh of a
    world of 4 — sharding must not change the math."""
    from lddl_tpu_torch.models import BertConfig, BertForPreTraining
    torch.manual_seed(11)
    model = BertForPreTraining(BertConfig.tiny(**CFG))
    params = str(tmp_path / "params.npz")
    np.savez(params, **{k: v.numpy() for k, v in model.state_dict().items()})
    path = str(tmp_path / "batch.npz")
    np.savez(path, **_batches(1)[0])
    meshes = [{"dp": 4}, {"dp": 2, "tp": 2}, {"tp": 2, "sp": 2},
              {"dp": 2, "fsdp": 2}, {"fsdp": 2, "tp": 2}]
    losses = run_world(4, ptest.eval_meshes_world, meshes, CFG, params,
                       path, device="cpu")[0]
    assert np.allclose(losses, losses[0], rtol=BF16_RTOL), losses


def test_world4_checkpoint_resumes_bit_identical(tmp_path):
    """Two sharded steps with dropout 0.1, an eval step, a checkpoint
    from every rank, a restore into a model and optimizer built from
    another seed: the next step from each is bit-identical (loss and
    every local shard)."""
    batches = _batches()
    _unsharded(batches[:1], tmp_path)
    # An eval step first: FSDP2's root keeps unsharded parameters after a
    # forward without a backward, and the save must see the shards.
    res = _world({"fsdp": 2, "tp": 2}, batches[:2], tmp_path,
                 cfg={"hidden_dropout": 0.1}, eval=True,
                 checkpoint=str(tmp_path / "ckpt"))
    for r in res:
        ck = r["checkpoint"]
        assert ck["restored"] == ck["count"] == 2
        assert ck["live"] == ck["resumed"]
        assert ck["differ"] == []
    import os
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["2"]


def test_remat_under_sequence_parallel_is_exact(tmp_path):
    """remat=True recomputes each layer in the backward with the same
    dropout masks and the same ambient mesh (its sp gathers and chunks):
    the sharded steps equal the ones without remat bit for bit."""
    batches = _batches(2)
    _unsharded(batches[:1], tmp_path)
    runs = [_world({"fsdp": 2, "sp": 2}, batches, tmp_path,
                   cfg={"hidden_dropout": 0.1, "remat": remat})
            for remat in (False, True)]
    assert runs[0][0]["metrics"] == runs[1][0]["metrics"]
    for name, value in runs[0][0]["params"].items():
        np.testing.assert_array_equal(runs[1][0]["params"][name], value,
                                      err_msg=name)


def _packed_batches(n=2, b=8, l=64):
    """Rows of two packed samples each (the second ends in padding):
    segment ids, restarting positions, each sample's [CLS] column and
    NSP labels per sample."""
    out = []
    for batch in _batches(n, b, l):
        seg = np.zeros((b, l), np.int32)
        seg[:, :l // 2] = 1
        seg[:, l // 2:l - 8] = 2
        pos = np.concatenate([np.arange(l // 2), np.arange(l // 2)])
        batch.update(
            attention_mask=(seg > 0).astype(np.int32), segments=seg,
            position_ids=np.repeat(pos[None], b, 0).astype(np.int32),
            cls_positions=np.repeat([[0, l // 2]], b, 0).astype(np.int32),
            next_sentence_labels=np.stack(
                [batch["next_sentence_labels"]] * 2, 1))
        batch["labels"] = np.where(seg > 0, batch["labels"], -1)
        out.append(batch)
    return out


def test_packed_rows_sharded_match_unsharded(tmp_path):
    """BertForPreTrainingPacked takes the same plan: segment ids reach
    the single-block kernels' route as both masks on every rank."""
    from lddl_tpu_torch.models import (BertConfig, BertForPreTrainingPacked,
                                       make_optimizer, make_train_step)
    batches = _packed_batches()
    torch.manual_seed(0)
    model = BertForPreTrainingPacked(BertConfig.tiny(
        **dict(CFG, dtype=torch.float32, attention_impl="flash")))
    np.savez(tmp_path / "params.npz",
             **{k: v.numpy() for k, v in model.state_dict().items()})
    step = make_train_step(model, make_optimizer(model.parameters(), **OPT))
    want = [{k: float(v) for k, v in step(
        {k: torch.from_numpy(v) for k, v in b.items()}).items()}
        for b in batches]
    res = _world({"fsdp": 2, "tp": 2}, batches, tmp_path,
                 model="bert_packed")
    assert res[0]["kernel_calls"] == 2 * len(batches)
    _assert_metrics(res[0]["metrics"], want, RTOL)
    _assert_params(res[0]["params"], {k: v.detach().numpy() for k, v in
                                      model.named_parameters()},
                   len(batches))
