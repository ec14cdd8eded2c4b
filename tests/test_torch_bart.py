"""The port's BART (lddl_tpu_torch.models.bart) against lddl_tpu's flax
model with the same (converted) parameters: the param-tree round trip,
logits on the dense path and on the attention kernels' online regime
(L=1000 pads to 1024), at head_dim 64 and at head_dim 256 (hidden 256,
one head: the online kernels' widest build), causal decoding, the batch
loss, and train steps against make_sharded_train_step with
``batch_loss=bart_batch_loss``.

Tolerances: fp32 logits agree to 1e-5, absolute and relative: both sides
run the same fp32 products and differ only in summation order (the online
regime sums each softmax row tile by tile, at other tile widths). The
bf16 case is held to 5e-2 of max |ref|: both take the dense softmax in
bf16, rounded at the same places, but each layer rounds its activations
to bf16 at slightly different places. Loss and metrics 1e-5;
parameters 2e-5 absolute after each step (see test_torch_train.py for
why).
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from lddl_tpu.models import BartConfig as JBartConfig
from lddl_tpu.models import BartForPreTraining as JBart
from lddl_tpu_torch.models import (BartConfig, BartForPreTraining,
                                   bart_batch_loss, make_optimizer,
                                   make_train_step)
from lddl_tpu_torch.models.convert import (flax_to_state_dict,
                                           state_dict_to_flax)
from lddl_tpu_torch.testing import fake_bart_batch

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _cfgs(**kw):
    """Tiny BART with head_dim 64 (128 wide, 2 heads) and 1024 positions,
    so L=1000 reaches the online kernels through "auto"."""
    kw.setdefault("hidden_size", 128)
    kw.setdefault("num_heads", 2)
    kw.setdefault("max_position_embeddings", 1024)
    kw.setdefault("hidden_dropout", 0.0)
    kw.setdefault("attention_dropout", 0.0)
    jdtype = kw.pop("jdtype", jnp.float32)
    tdtype = kw.pop("tdtype", torch.float32)
    return (JBartConfig.tiny(dtype=jdtype, **kw),
            BartConfig.tiny(dtype=tdtype, **kw))


def _batch(vocab, b, l, seed):
    batch = fake_bart_batch(vocab, b, l, seed=seed)
    batch["attention_mask"][0, l - l // 4:] = 0     # a padded encoder row
    batch["input_ids"][0, l - l // 4:] = 0
    if b > 1:
        batch["labels"][1, l // 2:] = -1            # padded targets
    return batch


def _inputs(batch):
    return [batch[k] for k in BartForPreTraining.BATCH_INPUTS]


def _flax_params(jcfg, batch, seed=0):
    import flax.linen as nn
    variables = JBart(jcfg).init(jax.random.PRNGKey(seed), *_inputs(batch))
    return jax.device_get(nn.meta.unbox(variables)["params"])


def _port_model(tcfg, params):
    model = BartForPreTraining(tcfg)
    model.load_state_dict(flax_to_state_dict(params), strict=True)
    return model.eval()


def _port_logits(model, batch):
    with torch.no_grad():
        return model(*(torch.from_numpy(a) for a in _inputs(batch))).numpy()


def test_convert_round_trip():
    jcfg, tcfg = _cfgs()
    params = _flax_params(jcfg, _batch(jcfg.vocab_size, 2, 16, 0))
    model = _port_model(tcfg, params)       # strict: every name and shape
    sd = model.state_dict()
    back = state_dict_to_flax(sd)
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b) == len(sd)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(leaf), flat_b[path])
    # One token table, registered once; tables stay untransposed.
    assert [n for n in sd if "shared" in n] == ["shared_embeddings.weight"]
    np.testing.assert_array_equal(
        sd["encoder_embed.positions.weight"].numpy(),
        np.asarray(params["encoder_embed"]["positions"]["embedding"]))
    np.testing.assert_array_equal(
        sd["decoder_0.cross_attention.key.weight"].numpy(),
        np.asarray(params["decoder_0"]["cross_attention"]["key"]["kernel"]).T)


@pytest.mark.parametrize("impl,l,heads", [
    pytest.param("dense", 24, {}, id="dense-24"),
    pytest.param("auto", 1000, {}, id="auto-1000"),
    pytest.param("auto", 1000, {"hidden_size": 256, "num_heads": 1},
                 id="auto-1000-d256")])
def test_logits_match_flax(impl, l, heads):
    """fp32 logits, with a padded encoder row; at L=1000 both packages'
    "auto" takes the online-softmax kernels for the encoder (at head_dim
    64, and at 256 with one head of hidden 256)."""
    jcfg, tcfg = _cfgs(attention_impl=impl, **heads)
    batch = _batch(jcfg.vocab_size, 2, l, seed=l)
    params = _flax_params(jcfg, batch, seed=1)
    want = JBart(jcfg).apply({"params": params}, *_inputs(batch),
                             deterministic=True)
    got = _port_logits(_port_model(tcfg, params), batch)
    assert got.shape == (2, l, jcfg.vocab_size) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL)


def test_bf16_logits_close_to_flax():
    """bf16 activations over fp32 params, the encoder on the online
    regime (L=1000)."""
    jcfg, tcfg = _cfgs(attention_impl="auto", jdtype=jnp.bfloat16,
                       tdtype=torch.bfloat16)
    batch = _batch(jcfg.vocab_size, 1, 1000, seed=5)
    params = _flax_params(jcfg, batch, seed=2)
    want = np.asarray(JBart(jcfg).apply({"params": params}, *_inputs(batch),
                                        deterministic=True), np.float32)
    got = _port_logits(_port_model(tcfg, params), batch)
    assert np.abs(got - want).max() <= 5e-2 * np.abs(want).max()


def test_decoder_is_causal():
    """Changing a future decoder token must not change earlier logits."""
    jcfg, tcfg = _cfgs()
    batch = _batch(tcfg.vocab_size, 1, 12, seed=3)
    model = _port_model(tcfg, _flax_params(jcfg, batch))
    base = _port_logits(model, batch)
    mutated = dict(batch, decoder_input_ids=batch["decoder_input_ids"].copy())
    mutated["decoder_input_ids"][0, 8] = (
        mutated["decoder_input_ids"][0, 8] + 1) % tcfg.vocab_size
    changed = _port_logits(model, mutated)
    np.testing.assert_allclose(base[0, :8], changed[0, :8], rtol=TOL,
                               atol=TOL)
    assert not np.allclose(base[0, 8:], changed[0, 8:])


def test_bart_batch_loss_matches_reference():
    from lddl_tpu.models.bart import bart_batch_loss as j_loss
    g = np.random.default_rng(0)
    logits = g.standard_normal((3, 20, 40)).astype(np.float32)
    labels = g.integers(0, 40, (3, 20)).astype(np.int32)
    labels[1, 12:] = -1
    labels[2, :] = -1                     # a row with no target
    logits[0, 2, labels[0, 2]] = 9.0      # one sure hit
    j, jm = j_loss(logits, {"labels": labels})
    t, tm = bart_batch_loss(torch.from_numpy(logits),
                            {"labels": torch.from_numpy(labels)})
    assert set(tm) == set(jm)
    np.testing.assert_allclose(float(t), float(j), rtol=TOL)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=TOL,
                                   atol=1e-7, err_msg=k)


def _compare_steps(jcfg, tcfg, batches, n_steps):
    """n_steps train steps of each package from the same parameters, on
    the same numpy batches; metrics and parameters checked after each."""
    from lddl_tpu.loader import to_device_batch
    from lddl_tpu.models import create_train_state, make_sharded_train_step
    from lddl_tpu.models.bart import bart_batch_loss as j_loss
    from lddl_tpu.models.train import make_optimizer as j_make
    from lddl_tpu.parallel import make_mesh

    mesh = make_mesh({"dp": 1}, devices=jax.devices()[:1])
    opt_kw = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10)
    jmodel = JBart(jcfg)
    state, _ = create_train_state(jcfg, mesh, batches[0], seed=0,
                                  optimizer=j_make(**opt_kw), model=jmodel)
    j_step = make_sharded_train_step(mesh, jcfg, model=jmodel, donate=False,
                                     batch_loss=j_loss)
    model = BartForPreTraining(tcfg)
    model.load_state_dict(flax_to_state_dict(jax.device_get(state.params)))
    t_step = make_train_step(model, make_optimizer(model.parameters(),
                                                   **opt_kw),
                             batch_loss=bart_batch_loss)
    for i, batch in enumerate(batches[:n_steps]):
        state, j_metrics = j_step(state, to_device_batch(batch, mesh),
                                  seed=0)
        t_metrics = t_step({k: torch.from_numpy(v) for k, v in batch.items()})
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


def test_three_train_steps_match_reference(tmp_path):
    """The slice as a whole at short L: write_bart_shards shards -> each
    package's BART loader (byte-equal batches) -> 3 fp32 steps."""
    from lddl_tpu.loader import get_bart_pretrain_data_loader as j_loader
    from lddl_tpu_torch.loader import get_bart_pretrain_data_loader
    from lddl_tpu_torch.testing import write_bart_shards, write_vocab
    write_vocab(str(tmp_path / "vocab.txt"), 512, seed=3)
    write_bart_shards(str(tmp_path / "bal"), 512, num_shards=2,
                      samples_per_shard=12, seed=3, min_tokens=40)
    kw = dict(batch_size=4, vocab_file=str(tmp_path / "vocab.txt"),
              max_seq_length=48, fixed_seq_length=48, base_seed=5,
              shuffle_buffer_size=16, shuffle_buffer_warmup_factor=2)
    j_batches = list(j_loader(str(tmp_path / "bal"), log_level=50, **kw))
    t_batches = list(get_bart_pretrain_data_loader(str(tmp_path / "bal"),
                                                   **kw))
    assert len(t_batches) == len(j_batches) >= 3
    for jb, tb in zip(j_batches, t_batches):
        assert jb.keys() == tb.keys()
        for k in jb:
            np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
    jcfg, tcfg = _cfgs(hidden_size=64, num_heads=4,
                       max_position_embeddings=64)
    _compare_steps(jcfg, tcfg, t_batches, 3)


def _online_step(**heads):
    jcfg, tcfg = _cfgs(num_encoder_layers=1, num_decoder_layers=1,
                       attention_impl="auto", **heads)
    _compare_steps(jcfg, tcfg, [_batch(jcfg.vocab_size, 2, 1000, seed=7)],
                   1)


def test_train_step_through_online_kernels_matches_reference():
    """One fp32 step at L=1000: the encoder's forward and backward run the
    online regime in both packages (the port's plain versions here)."""
    _online_step()


def test_train_step_through_online_kernels_at_head_dim_256():
    """The same step at head_dim 256 (hidden 256, one head): the port's
    D=256 plain versions against the reference's online kernels."""
    _online_step(hidden_size=256, num_heads=1)


def test_fp32_auto_flash_step_matches_dense(monkeypatch):
    """An fp32 step at L=1024 with attention_impl="auto": the encoder's
    self-attention takes the online regime (the port's plain versions
    here, the fp32 kernels on the card), once a layer, and the step's
    loss and gradients (learning rate 0 and no clipping, so the
    parameters stay and the gradients are the raw ones) agree with the
    same model's dense step within 1e-5 relative (loss, global norm; each
    gradient within 1e-5 of the largest)."""
    from lddl_tpu_torch.ops import flash_attention as tfa

    _, tcfg = _cfgs(num_encoder_layers=2, num_decoder_layers=1,
                    attention_impl="auto")
    torch.manual_seed(0)
    model = BartForPreTraining(tcfg)
    batch = {k: torch.from_numpy(v) for k, v in
             _batch(tcfg.vocab_size, 2, 1024, seed=9).items()}
    calls = []
    plain = tfa.online_fwd_plain
    monkeypatch.setattr(tfa, "online_fwd_plain",
                        lambda *a: calls.append(1) or plain(*a))
    results = {}
    for impl in ("auto", "dense"):
        for i in range(tcfg.num_encoder_layers):
            getattr(model, "encoder_{}".format(i)).self_attention \
                .attention_impl = impl
        opt = make_optimizer(model.parameters(), learning_rate=0.0,
                             clip_norm=float("inf"))
        step = make_train_step(model, opt, batch_loss=bart_batch_loss)
        loss = float(step(batch)["loss"])
        results[impl] = (loss, [p.grad.clone() for p in model.parameters()])
    assert len(calls) == tcfg.num_encoder_layers

    (loss, grads), (ref_loss, ref_grads) = results["auto"], results["dense"]
    assert abs(loss - ref_loss) <= 1e-5 * abs(ref_loss)

    def norm(gs):
        return float(torch.linalg.vector_norm(
            torch.stack([g.norm() for g in gs])))

    assert abs(norm(grads) - norm(ref_grads)) <= 1e-5 * norm(ref_grads)
    top = max(float(g.abs().max()) for g in ref_grads)
    for g, r in zip(grads, ref_grads):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=0,
                                   atol=1e-5 * top)


def test_batch_loss_and_ignore_index_are_exclusive():
    _, tcfg = _cfgs()
    model = BartForPreTraining(tcfg)
    opt = make_optimizer(model.parameters())
    with pytest.raises(ValueError, match="ignore_index"):
        make_train_step(model, opt, ignore_index=0,
                        batch_loss=functools.partial(bart_batch_loss,
                                                     ignore_index=0))


def test_v1_collate_on_a_keep_accents_dir_matches_reference(tmp_path):
    """A schema-v1 BART collate batch (chunk text, tokenized every
    epoch) from a tokenizer directory whose normalizer keeps accents:
    the port tokenizes with the fast tokenizer, as the reference's
    BertTokenizerFast does, and the noised batch is the reference's."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import _torch_tokenizers as toks
    from lddl_tpu.loader.bart import BartCollate as RefCollate
    from lddl_tpu.preprocess import get_tokenizer as ref_tokenizer
    from lddl_tpu_torch.loader.bart import BartCollate
    from lddl_tpu_torch.preprocess import build_wordpiece_vocab, get_tokenizer
    words = ("alpha beta gamma Café naïve café Dr. U.S. 3.14 e.g. "
             "delta epsilon").split()
    g = np.random.default_rng(4)
    chunks = [" ".join(" ".join(words[int(i)] for i in
                                g.integers(0, len(words), 9)).capitalize()
                       + "." for _ in range(3)) for _ in range(6)]
    vocab = build_wordpiece_vocab(chunks, str(tmp_path / "vocab.txt"),
                                  vocab_size=80)
    path = toks.keep_accents_dir(str(tmp_path / "tok"), vocab)
    ref = RefCollate(ref_tokenizer(pretrained_model_name=path),
                     max_seq_length=64)
    port_tok = get_tokenizer(pretrained_model_name=path)
    port = BartCollate(port_tok, max_seq_length=64)
    want = ref(chunks, np.random.Generator(np.random.Philox(key=[0, 9])))
    got = port(chunks, np.random.Generator(np.random.Philox(key=[0, 9])))
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]))
    assert port_tok.convert_tokens_to_ids("café") in np.asarray(
        want["labels"])
