"""The port's GPipe pipeline (lddl_tpu_torch.parallel.pipeline) against
lddl_tpu's, the counterpart of tests/test_pipeline.py: the stacked layout
(equal to the reference's through the converter), the unpipelined stack
against the JAX package's, and the pipelined encoder in one spawned gloo
world of 4 on the CPU at (pp, n_micro) in {(2, 2), (2, 4), (4, 4)} on
{pp: 2, dp: 2} and {pp: 4} meshes: its forward and the gradients of
mean(y.float()**2) for the layers and x, held to the port's unpipelined
stack and to lddl_tpu's reference_encoder (and, at (2, 2), to lddl_tpu's
own pipeline on 8 virtual devices). Also: pp = 1 communicates nothing,
indivisible layers raise, the rank rule and a sharded train step on the
{pp: 2, dp: 2} mesh (equal to the step on {dp: 2}), and the dryrun's
pipeline leg at 8 and 3 ranks.

The weights are the reference test's, with random LayerNorm scales and
biases: at init every row of y is normalised, mean(y**2) is constant and
its gradients are rounding noise.

Tolerances: stacked trees exact. Within the port, pipelined against
unpipelined: forward rtol = atol = 2e-4, gradients rtol 5e-3 and atol
1e-5, the reference test's bars (the two differ only in the rows each
matmul sees); in bf16 the gradients within BF16_GRAD = 1e-2 of max |ref|
(each microbatch's contribution is rounded to bf16 on its own, see
test_pipelined_bf16). Against lddl_tpu in fp32: FP32_TOL = 2e-5
(relative and absolute) on outputs, the model tests' 1e-5 doubled for
outputs up to ~8 after 4 layers, and the reference test's gradient bars;
in bf16, 5e-2 of max |ref|, the bar of
test_torch_models.py::test_bf16_logits_close_to_flax.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from lddl_tpu_torch.models import BertConfig
from lddl_tpu_torch.models.convert import flax_to_state_dict
from lddl_tpu_torch.parallel import (make_pipelined_encoder,
                                     reference_encoder, run_world,
                                     stack_layer_params,
                                     unstack_layer_params)
from lddl_tpu_torch.parallel import testing as ptest

LAYERS = 4
CFG_KW = dict(num_layers=LAYERS, hidden_dropout=0.0, attention_dropout=0.0)
FP32_TOL = 2e-5
FWD = dict(rtol=2e-4, atol=2e-4)
GRAD = dict(rtol=5e-3, atol=1e-5)
BF16_GRAD = 1e-2
# (mesh, n_micro, dtype) of each case of the world; pp from the mesh.
PIPELINED = [({"pp": 2, "dp": 2}, 2), ({"pp": 2, "dp": 2}, 4),
             ({"pp": 4}, 4)]
CASES = ([(axes, n, "float32") for axes, n in PIPELINED]
         + [({"pp": 1, "dp": 4}, 4, "float32"),
            ({"pp": 2, "dp": 2}, 4, "bfloat16")])
TRAIN_CFG = dict(attention_impl="dense")
TRAIN_OPT = dict(warmup_steps=1, total_steps=10)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _jcfg(dtype):
    from lddl_tpu.models import BertConfig as JBertConfig
    return JBertConfig.tiny(dtype=dtype, **CFG_KW)


def _tcfg(dtype):
    return BertConfig.tiny(dtype=dtype, **CFG_KW)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The reference test's inputs: tiny BERT's flax params (4 layers),
    x [8, 32, 64] and a mask with one padded row; the reference's stacked
    tree and the port's from the converted params, saved for the ranks."""
    import flax.linen as nn
    from lddl_tpu.models.bert import BertForPreTraining as JBert
    from lddl_tpu.parallel.pipeline import stack_layer_params as j_stack
    jcfg = _jcfg(jnp.float32)
    g = np.random.default_rng(0)
    b, t = 8, 32
    ids = g.integers(0, jcfg.vocab_size, (b, t)).astype(np.int32)
    mask = np.ones((b, t), np.int32)
    mask[0, t - 5:] = 0
    params = jax.device_get(nn.meta.unbox(JBert(jcfg).init(
        jax.random.PRNGKey(0), ids, np.zeros((b, t), np.int32), mask,
        deterministic=True))["params"])
    x = g.standard_normal((b, t, jcfg.hidden_size)).astype(np.float32)
    # At init (LayerNorm scale 1, bias 0) every row of y has mean 0 and
    # variance 1, so mean(y**2) is constant and every gradient is ~0:
    # random LayerNorm parameters make the gradient checks bite.
    g_ln = np.random.default_rng(1)
    for i in range(LAYERS):
        for norm in ("attention_norm", "ffn_norm"):
            ln = params["layer_{}".format(i)][norm]
            ln["scale"] = (1 + 0.5 * g_ln.standard_normal(
                ln["scale"].shape)).astype(np.float32)
            ln["bias"] = (0.5 * g_ln.standard_normal(
                ln["bias"].shape)).astype(np.float32)
    state = flax_to_state_dict(params)
    stacked = stack_layer_params(state, LAYERS)
    path = str(tmp_path_factory.mktemp("pipeline") / "inputs.npz")
    np.savez(path, x=x, mask=mask,
             **{"w." + k: v.numpy() for k, v in stacked.items()})
    return {"params": params, "state": state, "stacked": stacked,
            "j_stacked": j_stack(params, LAYERS), "x": x, "mask": mask,
            "path": path}


def _layer_grads(j_grads):
    """The reference's gradient tree over the stacked layers ->
    {layer_<i>.<rest>: numpy} in the port's layout."""
    out = {}
    for i in range(LAYERS):
        layer = jax.tree.map(lambda a, i=i: np.asarray(a, np.float32)[i],
                             j_grads)
        out.update({"layer_{}.{}".format(i, k): v.numpy()
                    for k, v in flax_to_state_dict(layer).items()})
    return out


@pytest.fixture(scope="module")
def reference(setup):
    """lddl_tpu's unpipelined stack on the same weights: y and the
    gradients of mean(y.float()**2) in fp32, y in bf16."""
    from lddl_tpu.parallel.pipeline import reference_encoder as j_ref
    x, mask = jnp.asarray(setup["x"]), jnp.asarray(setup["mask"])
    out = {}
    for name, dtype in (("float32", jnp.float32),
                        ("bfloat16", jnp.bfloat16)):
        fn = j_ref(_jcfg(dtype))
        out[name] = np.asarray(jax.jit(fn)(setup["j_stacked"], x, mask),
                               np.float32)

    def loss(params, x):
        y = j_ref(_jcfg(jnp.float32))(params, x, mask)
        return (y.astype(jnp.float32) ** 2).mean()

    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(setup["j_stacked"], x)
    out["grads"] = _layer_grads(gp)
    out["gx"] = np.asarray(gx)
    return out


@pytest.fixture(scope="module")
def unpipelined(setup):
    """The port's unpipelined stack: {dtype: (y, gx, {name: grad})}."""
    out = {}
    for name in ("float32", "bfloat16"):
        enc = reference_encoder(_tcfg(getattr(torch, name))).load_stacked(
            setup["stacked"])
        x = torch.from_numpy(setup["x"]).requires_grad_()
        y = enc(x, torch.from_numpy(setup["mask"]))
        y.float().pow(2).mean().backward()
        out[name] = (y.detach().float().numpy(), x.grad.numpy(),
                     {n: p.grad.numpy() for n, p in enc.named_parameters()})
    return out


def _train_batches(tmp_path_factory):
    from lddl_tpu_torch.testing import fake_pretrain_batch
    batch = fake_pretrain_batch(512, 4, 32, seed=1, segment_split=True)
    batch["attention_mask"][1, 24:] = 0
    path = str(tmp_path_factory.mktemp("pipeline_train") / "batches.npz")
    np.savez(path, **{k: v[None] for k, v in batch.items()})
    return path


def _train_spec(mesh, batches):
    return dict(mesh=mesh, cfg=TRAIN_CFG, seed=0, batches=batches, steps=1,
                opt=TRAIN_OPT)


@pytest.fixture(scope="module")
def world(setup, tmp_path_factory):
    """Every multi-rank case in one gloo world of 4, then one sharded train
    step on {pp: 2, dp: 2}; and the same step on {dp: 2} in a world of 2."""
    batches = _train_batches(tmp_path_factory)
    res = run_world(4, ptest.pipeline_world, setup["path"], CFG_KW, CASES,
                    _train_spec({"pp": 2, "dp": 2}, batches), device="cpu")
    dp = run_world(2, ptest.train_world, _train_spec({"dp": 2}, batches),
                   device="cpu")
    return res, dp


def _case(world, axes, n_micro, dtype="float32"):
    res, _ = world
    i = CASES.index((axes, n_micro, dtype))
    return [r["cases"][i] for r in res]


def _ids(case):
    return "pp{}_micro{}".format(case[0]["pp"], case[1])


def test_stack_layout_matches_reference(setup):
    """stack/unstack round trip, and the port's stacked tree equal to the
    reference's stack_layer_params through the converter, leaf for leaf
    (Dense kernels transposed in each layer)."""
    stacked, state = setup["stacked"], setup["state"]
    un = unstack_layer_params(stacked, LAYERS)
    assert set(un) == {k for k in state if k.startswith("layer_")}
    for k, v in un.items():
        assert torch.equal(v, state[k]), k
    again = stack_layer_params(un, LAYERS)
    assert list(again) == list(stacked)
    for k in stacked:
        assert stacked[k].shape[0] == LAYERS
        assert torch.equal(again[k], stacked[k]), k
    j_stacked = setup["j_stacked"]
    per_layer = [flax_to_state_dict(jax.tree.map(lambda a, i=i: a[i],
                                                 j_stacked))
                 for i in range(LAYERS)]
    assert set(per_layer[0]) == set(stacked)
    assert len(jax.tree.leaves(j_stacked)) == len(stacked)
    for k, v in stacked.items():
        assert torch.equal(v, torch.stack([layer[k] for layer in per_layer]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unpipelined_stack_matches_reference(setup, reference, unpipelined,
                                             dtype):
    got, want = unpipelined[dtype][0], reference[dtype]
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=FP32_TOL, atol=FP32_TOL)
    else:
        assert np.abs(got - want).max() <= 5e-2 * np.abs(want).max()


def test_unpipelined_gradients_match_reference(reference, unpipelined):
    _, gx, grads = unpipelined["float32"]
    np.testing.assert_allclose(gx, reference["gx"], **GRAD)
    assert set(grads) == set(reference["grads"])
    for k, v in grads.items():
        np.testing.assert_allclose(v, reference["grads"][k], err_msg=k,
                                   **GRAD)


@pytest.mark.parametrize("case", PIPELINED, ids=_ids)
def test_pipelined_forward(world, reference, unpipelined, case):
    axes, n_micro = case
    pp = axes["pp"]
    ranks = _case(world, axes, n_micro)
    want = unpipelined["float32"][0]
    steps = n_micro + pp - 1
    for r in ranks:
        np.testing.assert_allclose(r["y"], want, **FWD)
        np.testing.assert_allclose(r["y"], reference["float32"],
                                   rtol=FP32_TOL, atol=FP32_TOL)
        np.testing.assert_array_equal(r["y"], ranks[0]["y"])
        # One exchange a step each way, the epilogue's broadcast and the
        # entry's all-reduce: the same sequence on every rank.
        assert r["calls"] == {"batch_isend_irecv": 2 * steps,
                              "broadcast": 1, "all_reduce": 1}
    assert sorted(r["stage"] for r in ranks) == sorted(
        list(range(pp)) * (4 // pp))


@pytest.mark.parametrize("case", PIPELINED, ids=_ids)
def test_pipelined_gradients(world, reference, unpipelined, case):
    axes, n_micro = case
    pp = axes["pp"]
    ranks = _case(world, axes, n_micro)
    _, gx, grads = unpipelined["float32"]
    per = LAYERS // pp
    for r in ranks:
        np.testing.assert_allclose(r["gx"], gx, **GRAD)
        np.testing.assert_allclose(r["gx"], reference["gx"], **GRAD)
        np.testing.assert_array_equal(r["gx"], ranks[0]["gx"])
        own = {"layer_{}".format(i)
               for i in range(r["stage"] * per, (r["stage"] + 1) * per)}
        assert {k.split(".")[0] for k in r["grads"]} == own
        assert len(r["grads"]) == len(grads) // pp
        for k, v in r["grads"].items():
            np.testing.assert_allclose(v, grads[k], err_msg=k, **GRAD)
            np.testing.assert_allclose(v, reference["grads"][k], err_msg=k,
                                       **GRAD)


def test_pipelined_bf16(world, reference, unpipelined):
    """The reference test's dtype (bf16 activations) at pp=2, n_micro=4.
    The forward and gx hold the fp32 cases' bars. A parameter's gradient
    is the sum of its microbatches' contributions, each a bf16 product
    (a bias: a bf16 sum over the microbatch's rows) where the unpipelined
    stack rounds one over all rows: held to BF16_GRAD of max |ref|."""
    y, gx, grads = unpipelined["bfloat16"]
    for r in _case(world, {"pp": 2, "dp": 2}, 4, "bfloat16"):
        np.testing.assert_allclose(r["y"], y, **FWD)
        want = reference["bfloat16"]
        assert np.abs(r["y"] - want).max() <= 5e-2 * np.abs(want).max()
        np.testing.assert_allclose(r["gx"], gx, **GRAD)
        for k, v in r["grads"].items():
            ref = grads[k]
            assert np.abs(v - ref).max() <= BF16_GRAD * np.abs(ref).max(), k


def test_jax_pipeline_matches_port(setup, world):
    """lddl_tpu's own make_pipelined_encoder at pp=2, n_micro=2 on 8
    virtual CPU devices against the port's pipeline."""
    from lddl_tpu.parallel import make_mesh
    from lddl_tpu.parallel.pipeline import make_pipelined_encoder as j_pipe
    mesh = make_mesh({"pp": 2, "dp": 4})
    y = np.asarray(jax.jit(j_pipe(mesh, _jcfg(jnp.float32), 2))(
        setup["j_stacked"], jnp.asarray(setup["x"]),
        jnp.asarray(setup["mask"])), np.float32)
    for r in _case(world, {"pp": 2, "dp": 2}, 2):
        np.testing.assert_allclose(r["y"], y, rtol=FP32_TOL, atol=FP32_TOL)


def test_pp1_is_the_unpipelined_stack_without_p2p(world, unpipelined):
    y, gx, grads = unpipelined["float32"]
    for r in _case(world, {"pp": 1, "dp": 4}, 4):
        assert r["calls"] == {}
        np.testing.assert_allclose(r["y"], y, **FWD)
        np.testing.assert_allclose(r["gx"], gx, **GRAD)
        assert set(r["grads"]) == set(grads)
        for k, v in r["grads"].items():
            np.testing.assert_allclose(v, grads[k], err_msg=k, **GRAD)


class _PPMesh:
    """A stand-in mesh with a pp axis of ``size``: enough for the
    divisibility check, which comes before any group is made."""

    mesh_dim_names = ("pp",)

    def __init__(self, size):
        self._size = size

    def size(self, dim):
        return self._size


def test_pipeline_rejects_indivisible_layers():
    from lddl_tpu.models import BertConfig as JBertConfig
    from lddl_tpu.parallel import make_mesh
    from lddl_tpu.parallel.pipeline import make_pipelined_encoder as j_pipe
    with pytest.raises(ValueError, match="not divisible"):
        j_pipe(make_mesh({"pp": 8}), JBertConfig.tiny(**CFG_KW), n_micro=2)
    for pp in (3, 8):
        with pytest.raises(ValueError, match="not divisible"):
            make_pipelined_encoder(_PPMesh(pp), _tcfg(torch.float32),
                                   n_micro=2)


def test_process_dp_info_gives_pp_peers_one_dp_rank(world):
    """On {pp: 2, dp: 2} (rank = 2·pp + dp) the pp peers share their
    dp_rank: ranks 0 and 2 read dp block 0, ranks 1 and 3 block 1."""
    for rank, r in enumerate(_case(world, {"pp": 2, "dp": 2}, 2)):
        assert r["dp_info"] == (rank % 2, 2)
        assert r["stage"] == rank // 2


def test_train_step_on_pp_mesh_equals_dp_mesh(world):
    """One make_sharded_train_step of tiny BERT on {pp: 2, dp: 2} equals
    the step on {dp: 2}: pp peers are replicas that no collective of the
    step touches."""
    res, dp = world
    for rank, r in enumerate(res):
        got, want = r["train"], dp[rank % 2]
        assert got["metrics"] == want["metrics"]
        assert np.isfinite(got["metrics"][0]["loss"])
        assert set(got["params"]) == set(want["params"])
        for k, v in got["params"].items():
            np.testing.assert_array_equal(v, want["params"][k], err_msg=k)


@pytest.mark.parametrize("n", [8, 3])
def test_dryrun_pipeline_leg(n):
    """The dryrun with its pipeline leg: at 8 ranks a {pp: 2, dp: 4} mesh,
    at 3 the first 2 ranks (the third sits the leg out)."""
    from lddl_tpu_torch.entry import dryrun_multichip
    out = dryrun_multichip(n, device="cpu")
    err = out["pp2_gpipe_max_err"]
    assert err is not None and np.isfinite(err) and err < 0.1
    assert np.isfinite(out["bert_loss"]) and np.isfinite(out["bart_loss"])
