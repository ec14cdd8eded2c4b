"""Packed rows in the port against lddl_tpu: the packers (StreamPacker,
packed_layout_arrays, ffd_pack, pack_columns) give equal output on seeded
inputs; the port's loaders give byte-equal packed batches over two epochs
(load-time packing of unbinned shards, and offline-packed shards built
live by lddl_tpu's preprocess and balancer, each with static and dynamic
masking); the port's packed-shard writer gives lddl_tpu's rows; the
factory refuses what the reference refuses, with the same message; and
the packed model and 3 packed train steps match the flax reference.

Tolerances: fp32 logits and metrics 1e-5 (same math, other summation
order), parameters 2e-5 after each step, as in test_torch_train.py.
Within the port, a packed sample's logits equal its unpacked logits to
1e-5 (fp32: the masked keys' weights underflow to exactly 0 in both), and
the flash plain path equals the dense block-diagonal path to 1e-5.
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from lddl_tpu_torch import testing as ttesting
from lddl_tpu_torch.loader import (BertCollate, BertPackedCollate, Vocab,
                                   get_bert_pretrain_data_loader,
                                   packed_shape_of_dir)
from lddl_tpu_torch.models import (BertConfig, BertForPreTrainingPacked,
                                   make_optimizer, make_train_step)
from lddl_tpu_torch.models.convert import flax_to_state_dict
from lddl_tpu_torch.ops import packing as tpack
from lddl_tpu_torch.preprocess import packing as tprep

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def test_stream_packer_and_layout_match_reference():
    from lddl_tpu.ops import packing as jpack
    g = np.random.default_rng(0)
    lengths = [int(x) for x in g.integers(1, 65, 300)]
    for horizon in (None, 3):
        outs = []
        for mod in (jpack, tpack):
            p = mod.StreamPacker(64, 4, 3, horizon=horizon)
            out = []
            for length in lengths:
                o = p.add(length)
                if o is None:
                    out.append(p.emit_fullest())
                    o = p.add(length)
                out.append(o)
            out.append(p.flush())
            outs.append(out)
        assert outs[1] == outs[0]
        for rows in (x for x in outs[0] if isinstance(x, list) and x):
            # Global ordinals -> batch-local ones, as the loader relabels.
            local = {o: i for i, o in enumerate(
                sorted(o for row in rows for o, _ in row))}
            rows = [[(local[o], n) for o, n in row] for row in rows]
            want = jpack.packed_layout_arrays(rows, 64, 3)
            got = tpack.packed_layout_arrays(rows, 64, 3)
            assert got.keys() == want.keys()
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with pytest.raises(ValueError, match="exceeds pack capacity"):
        tpack.StreamPacker(8, 2, 2).add(9)
    ids = [list(range(n)) for n in (3, 130, 0)]
    for a, b in zip(tpack.pad_to_bucket(ids), jpack.pad_to_bucket(ids)):
        np.testing.assert_array_equal(a, b)
    assert tpack.round_up(129, 128) == jpack.round_up(129, 128) == 256


def _sample_columns(n, masking, seed, lo=8, hi=64):
    """Per-sample schema-v2 columns (pyarrow lists) from the port's data
    maker, as both packers consume them."""
    rng = np.random.default_rng(seed)
    a, b, nsp, totals, pos, labels = ttesting._samples_of_bin(
        rng, n, lo, hi, 512, masking)
    cols = {"A_ids": ttesting._int32_lists(a),
            "B_ids": ttesting._int32_lists(b),
            "is_random_next": nsp, "num_tokens": totals}
    if masking:
        cols["masked_lm_positions_ids"] = ttesting._int32_lists(pos)
        cols["masked_lm_label_ids"] = ttesting._int32_lists(labels)
    return cols


@pytest.mark.parametrize("masking", [True, False],
                         ids=["static", "dynamic"])
def test_ffd_pack_and_pack_columns_match_reference(masking):
    from lddl_tpu.preprocess import packing as jprep
    lengths = np.random.default_rng(1).integers(1, 129, 500)
    for per_row in (1, 3, 8):
        for got, want in zip(tprep.ffd_pack(lengths, 128, per_row),
                             jprep.ffd_pack(lengths, 128, per_row)):
            np.testing.assert_array_equal(got, want)
    cols = _sample_columns(200, masking, seed=2)
    got, n_got, s_got = tprep.pack_columns(cols, 200, 128, 4, 2, 3,
                                           masking=masking)
    want, n_want, s_want = jprep.pack_columns(cols, 200, 128, 4, 2, 3,
                                              masking=masking)
    assert (n_got, s_got) == (n_want, s_want)
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], np.ndarray):
            np.testing.assert_array_equal(got[k], want[k])
            assert got[k].dtype == want[k].dtype
        else:
            assert got[k].equals(want[k]), k
    assert tprep.pack_meta_of(128, 4) == jprep.pack_meta_of(128, 4)


@pytest.mark.parametrize("max_per_row", [1, 8])
def test_fake_packed_pretrain_batch_matches_reference(max_per_row):
    """The port's synthetic packed batch equals lddl_tpu's array for array,
    dtypes included."""
    from lddl_tpu.models.testing import fake_packed_pretrain_batch as j_fake
    want = j_fake(512, 3, 64, max_per_row, seed=4)
    got = ttesting.fake_packed_pretrain_batch(512, 3, 64, max_per_row,
                                              seed=4)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_packed_shard_writer_matches_reference(tmp_path):
    """testing.write_packed_shards (the port's pack_columns) against
    lddl_tpu's write_packed_shard on the same samples: the same packed
    rows (the port deals them round-robin over its shards) and the same
    row shape in the footer."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    from lddl_tpu.preprocess.packing import write_packed_shard
    tokens = ttesting.write_vocab(str(tmp_path / "vocab.txt"), 512)
    n, shards = 150, 3
    kw = dict(pack_seq_length=128, pack_max_per_row=4, min_tokens=8,
              max_tokens=64, masking=True, seed=4)
    counts, _ = ttesting.write_packed_shards(str(tmp_path / "port"), tokens,
                                             num_samples=n,
                                             num_shards=shards, **kw)
    cols = _sample_columns(n, True, seed=4)
    ref = write_packed_shard(cols, n, str(tmp_path / "ref"), 0, 128, 4,
                             cls_id=2, sep_id=3, masking=True)
    want = pq.read_table(list(ref)[0])
    parts = [pq.read_table(str(tmp_path / "port" / name))
             for name in sorted(counts)]
    assert sum(counts.values()) == want.num_rows
    assert max(counts.values()) - min(counts.values()) <= 1
    for t in parts:
        assert t.schema.equals(want.schema, check_metadata=True)
    order = np.argsort(np.concatenate(
        [np.arange(i, want.num_rows, shards) for i in range(shards)]),
        kind="stable")
    got = pa.concat_tables(parts).take(order)
    assert got.equals(want)
    assert packed_shape_of_dir(str(tmp_path / "port")) == (128, 4)


def _write_corpus(root):
    """A tiny one-document-per-line corpus (the tests' tiny_corpus)."""
    source = os.path.join(root, "source")
    os.makedirs(source)
    words = ("alpha beta gamma delta epsilon zeta eta theta iota kappa "
             "lambda mu nu xi omicron pi rho sigma tau upsilon").split()
    g = np.random.Generator(np.random.Philox(key=[0, 7]))
    docs = []
    for d in range(48):
        sents = []
        for _ in range(int(g.integers(2, 9))):
            picks = [words[int(g.integers(0, len(words)))]
                     for _ in range(int(g.integers(4, 14)))]
            sents.append(" ".join(picks).capitalize() + ".")
        docs.append("doc-{} {}".format(d, " ".join(sents)))
    texts = []
    for shard in range(4):
        text = "".join(line + "\n" for line in docs[shard::4])
        with open(os.path.join(source, "{}.txt".format(shard)), "w") as f:
            f.write(text)
        texts.append(text)
    return texts


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """lddl_tpu preprocess -> balance, unbinned and offline-packed
    (pack_seq_length 64, 4 per row), static and dynamic masking."""
    from lddl_tpu.balance import balance_shards
    from lddl_tpu.preprocess import (BertPretrainConfig,
                                     build_wordpiece_vocab, get_tokenizer,
                                     run_bert_preprocess)
    root = str(tmp_path_factory.mktemp("packed_corpus"))
    texts = _write_corpus(root)
    vocab = build_wordpiece_vocab(texts, os.path.join(root, "vocab.txt"),
                                  vocab_size=300)
    tok = get_tokenizer(vocab_file=vocab)
    out = {"vocab": vocab}
    for masking in (True, False):
        for pack in (None, 64):
            key = (masking, pack)
            pre = os.path.join(root, "pre_{}_{}".format(*key))
            run_bert_preprocess(
                {"wiki": root}, pre, tok,
                config=BertPretrainConfig(max_seq_length=64,
                                          duplicate_factor=3,
                                          masking=masking),
                num_blocks=4, sample_ratio=1.0, seed=0,
                pack_seq_length=pack, pack_max_per_row=4)
            out[key] = os.path.join(root, "bal_{}_{}".format(*key))
            balance_shards(pre, out[key], 2)
    return out


def _assert_same_epochs(ref, port, epochs=2):
    n = 0
    for _ in range(epochs):
        ref_batches, port_batches = list(ref), list(port)
        assert len(port_batches) == len(ref_batches) > 0
        for rb, pb in zip(ref_batches, port_batches):
            assert pb.keys() == rb.keys()
            for k in rb:
                assert pb[k].dtype == rb[k].dtype, k
                np.testing.assert_array_equal(pb[k], rb[k], err_msg=k)
        n += len(port_batches)
    return n


@pytest.mark.parametrize("masking", [True, False],
                         ids=["static", "dynamic"])
def test_load_time_packed_batches_byte_equal(shards, masking):
    from lddl_tpu.loader import get_bert_pretrain_data_loader as j_loader
    path = shards[(masking, None)]
    assert packed_shape_of_dir(path) is None
    for dp_rank, num_dp_groups, num_workers in ((0, 1, 2), (1, 2, 1)):
        kw = dict(dp_rank=dp_rank, num_dp_groups=num_dp_groups,
                  num_workers=num_workers, batch_size=8,
                  vocab_file=shards["vocab"], shuffle_buffer_size=32,
                  shuffle_buffer_warmup_factor=4, base_seed=11,
                  pack_seq_length=64, pack_rows=4, pack_max_per_row=4,
                  pack_allow_uneven_epochs=True)
        ref = j_loader(path, **kw)
        port = get_bert_pretrain_data_loader(path, **kw)
        assert _assert_same_epochs(ref, port) > 0
        assert port.n_samples == ref.n_samples > 0
        assert port.pad_ratio == ref.pad_ratio


@pytest.mark.parametrize("masking", [True, False],
                         ids=["static", "dynamic"])
def test_offline_packed_batches_byte_equal(shards, masking, tmp_path):
    """Offline-packed shards detected from the manifest's
    ``__meta__.packed`` (as lddl_tpu's balancer publishes it) and, with
    the manifest gone, from a shard's footer."""
    import shutil
    from lddl_tpu.loader import get_bert_pretrain_data_loader as j_loader
    from lddl_tpu.loader.bert import packed_shape_of_dir as j_shape
    path = shards[(masking, 64)]
    assert packed_shape_of_dir(path) == j_shape(path) == (64, 4)
    bare = str(tmp_path / "bare")
    shutil.copytree(path, bare)
    os.remove(os.path.join(bare, ".manifest.json"))
    assert packed_shape_of_dir(bare) == (64, 4)
    for root in (path, bare):
        for dp_rank, num_dp_groups in ((0, 1), (1, 2)):
            kw = dict(dp_rank=dp_rank, num_dp_groups=num_dp_groups,
                      batch_size=8, vocab_file=shards["vocab"],
                      shuffle_buffer_size=32,
                      shuffle_buffer_warmup_factor=4, base_seed=5,
                      pack_rows=4)
            _assert_same_epochs(j_loader(root, **kw),
                                get_bert_pretrain_data_loader(root, **kw))


def test_packing_errors_match_reference(shards, tmp_path):
    """The factory's ValueErrors, message for message: binned shards with
    packing, return_raw_samples with packing, a half-specified packing,
    uneven dp groups, and a pack_seq_length other than the one an
    offline-packed directory was packed at."""
    from lddl_tpu.loader import get_bert_pretrain_data_loader as j_loader
    tokens = ttesting.write_vocab(str(tmp_path / "vocab.txt"), 512)
    binned = str(tmp_path / "binned")
    ttesting.write_balanced_shards(binned, tokens, num_bins=2, bin_size=32,
                                   shards_per_bin=2, samples_per_shard=8)
    vocab = shards["vocab"]
    cases = [
        (binned, dict(vocab_file=str(tmp_path / "vocab.txt"),
                      pack_seq_length=64, pack_rows=4)),
        (shards[(True, None)], dict(vocab_file=vocab, pack_seq_length=64,
                                    pack_rows=4, return_raw_samples=True)),
        (shards[(True, None)], dict(vocab_file=vocab, pack_seq_length=64)),
        (shards[(True, None)], dict(vocab_file=vocab, pack_rows=4)),
        (shards[(True, None)], dict(vocab_file=vocab, pack_seq_length=64,
                                    pack_rows=4, num_dp_groups=2)),
        (shards[(True, 64)], dict(vocab_file=vocab, pack_seq_length=128)),
        (shards[(True, 64)], dict(vocab_file=vocab,
                                  return_raw_samples=True)),
        (shards[(True, 64)], dict(vocab_file=vocab, fixed_seq_lengths=64)),
    ]
    for path, kw in cases:
        with pytest.raises(ValueError) as want:
            j_loader(path, **kw)
        with pytest.raises(ValueError) as got:
            get_bert_pretrain_data_loader(path, **kw)
        assert str(got.value) == str(want.value)


def test_raw_samples_match_reference(shards):
    from lddl_tpu.loader import get_bert_pretrain_data_loader as j_loader
    kw = dict(vocab_file=shards["vocab"], batch_size=8, base_seed=2,
              shuffle_buffer_size=16, return_raw_samples=True)
    path = shards[(False, None)]
    ref = list(j_loader(path, **kw))
    port = list(get_bert_pretrain_data_loader(path, **kw))
    assert len(port) == len(ref) > 0
    for rb, pb in zip(ref, port):
        assert len(pb) == len(rb)
        for rs, ps in zip(rb, pb):
            for a, b in zip(rs, ps):
                np.testing.assert_array_equal(b, a)


# ------------------------------------------------------------ the model


def _samples(n, seed, vocab_size=512, lo=2, hi=20):
    g = np.random.default_rng(seed)
    return [(g.integers(5, vocab_size, int(g.integers(lo, hi)))
             .astype(np.int32),
             g.integers(5, vocab_size, int(g.integers(lo, hi)))
             .astype(np.int32), int(g.integers(0, 2)))
            for _ in range(n)]


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("vocab") / "vocab.txt")
    ttesting.write_vocab(path, 512)
    return Vocab(path)


def _packed(vocab, samples, L=64, R=3, P=4):
    """(packed batch, layout, unpacked batch) of ``samples``, unmasked."""
    packer = tpack.StreamPacker(L, R, P)
    for a, b, _ in samples:
        assert packer.add(len(a) + len(b) + 3) is not None
    rows = packer.flush()
    collate = BertPackedCollate(vocab, L, R, P, mlm_prob=0.0)
    batch, stats = collate(rows, samples, g=np.random.default_rng(0))
    assert stats["n_samples"] == len(samples)
    unpacked = BertCollate(vocab, fixed_seq_length=L, mlm_prob=0.0)(
        samples, g=np.random.default_rng(0))
    return batch, tpack.packed_layout_arrays(rows, L, P), unpacked


def _cfgs(impl, **kw):
    from lddl_tpu.models import BertConfig as JBertConfig
    kw = dict(vocab_size=512, max_position_embeddings=64,
              hidden_dropout=0.0, attention_dropout=0.0,
              attention_impl=impl, **kw)
    return (JBertConfig.tiny(dtype=jnp.float32, **kw),
            BertConfig.tiny(dtype=torch.float32, **kw))


def _flax_params(jcfg, batch):
    import flax.linen as nn
    from lddl_tpu.models import BertForPreTrainingPacked as JPacked
    model = JPacked(jcfg)
    inputs = [batch[k] for k in model.BATCH_INPUTS]
    params = jax.device_get(nn.meta.unbox(
        model.init(jax.random.PRNGKey(0), *inputs,
                   deterministic=True))["params"])
    return model, inputs, params


def _port_outputs(model, batch):
    with torch.no_grad():
        mlm, nsp = model(*(torch.from_numpy(batch[k])
                           for k in model.BATCH_INPUTS))
    return mlm.numpy(), nsp.numpy()


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_packed_logits_match_flax(vocab, impl):
    batch, _, _ = _packed(vocab, _samples(7, seed=3))
    assert batch["segments"].max() >= 2
    jcfg, tcfg = _cfgs(impl)
    jmodel, inputs, params = _flax_params(jcfg, batch)
    j_mlm, j_nsp = jmodel.apply({"params": params}, *inputs,
                                deterministic=True)
    model = BertForPreTrainingPacked(tcfg)
    model.load_state_dict(flax_to_state_dict(params))
    mlm, nsp = _port_outputs(model.eval(), batch)
    assert nsp.shape == (3, 4, 2)
    np.testing.assert_allclose(mlm, np.asarray(j_mlm), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(nsp, np.asarray(j_nsp), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_packed_forward_matches_unpacked_per_sample(vocab, impl):
    """Every packed sample's MLM logits over its own span and its NSP
    logits equal the sample run alone (block-diagonal attention and
    restarted positions), on the same params."""
    samples = _samples(6, seed=4)
    batch, layout, unpacked = _packed(vocab, samples)
    _, tcfg = _cfgs(impl)
    torch.manual_seed(0)
    model = BertForPreTrainingPacked(tcfg).eval()
    mlm_p, nsp_p = _port_outputs(model, batch)
    with torch.no_grad():
        mlm_u, nsp_u = model(*(torch.from_numpy(unpacked[k]) for k in (
            "input_ids", "token_type_ids", "attention_mask")))
    for s, (a, b, _) in enumerate(samples):
        n = len(a) + len(b) + 3
        r, off = int(layout["row_of"][s]), int(layout["offset_of"][s])
        np.testing.assert_allclose(mlm_p[r, off:off + n],
                                   mlm_u[s, :n].numpy(), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(nsp_p[r, int(layout["slot_of"][s])],
                                   nsp_u[s].numpy(), rtol=TOL, atol=TOL)


def test_packed_flash_matches_packed_dense():
    """The kernels' segment masks (plain versions here) against the dense
    path's block-diagonal bias, through MultiHeadAttention."""
    from lddl_tpu_torch.models.attention import MultiHeadAttention
    from lddl_tpu_torch.ops.flash_attention import flash_attention
    torch.manual_seed(0)
    b, l, hidden, heads = 2, 128, 128, 4
    seg = torch.zeros((b, l), dtype=torch.int32)
    seg[0, :50], seg[0, 50:100], seg[1, :] = 1, 2, 1
    x = torch.randn(b, l, hidden)
    outs = {}
    attn = MultiHeadAttention(hidden, heads, dtype=torch.float32)
    for impl in ("flash", "dense"):
        attn.attention_impl = impl
        with torch.no_grad():
            outs[impl] = attn(x, x, (seg > 0).to(torch.int32),
                              segments=seg)
    valid = seg > 0
    np.testing.assert_allclose(outs["flash"][valid].numpy(),
                               outs["dense"][valid].numpy(), rtol=TOL,
                               atol=TOL)
    q = torch.randn(b, l, heads, 32)
    with pytest.raises(ValueError, match="exclusive"):
        flash_attention(q, q, q, seg, segments=seg)


def test_three_packed_train_steps_match_reference(tmp_path):
    """Unbinned shards -> each package's load-time packed loader
    (byte-equal batches) -> 3 fp32 train steps of the packed model (flash,
    dropout 0), metrics and params after every step held to
    make_sharded_train_step's; the metrics include mlm_dropped_labels
    under the packed cap mlm_gather_cap(64, 4)."""
    from lddl_tpu.loader import get_bert_pretrain_data_loader as j_loader
    from lddl_tpu.loader import to_device_batch
    from lddl_tpu.models import (BertForPreTrainingPacked as JPacked,
                                 create_train_state, make_sharded_train_step)
    from lddl_tpu.models.train import make_optimizer as j_make
    from lddl_tpu.parallel import make_mesh
    tokens = ttesting.write_vocab(str(tmp_path / "vocab.txt"), 512, seed=3)
    path = str(tmp_path / "shards")
    ttesting.write_unbinned_shards(path, tokens, num_shards=2,
                                   samples_per_shard=24, min_tokens=8,
                                   max_tokens=40, masking=True, seed=3)
    kw = dict(batch_size=8, vocab_file=str(tmp_path / "vocab.txt"),
              shuffle_buffer_size=16, shuffle_buffer_warmup_factor=2,
              base_seed=5, pack_seq_length=64, pack_rows=4,
              pack_max_per_row=4)
    j_batches = list(j_loader(path, **kw))[:3]
    t_batches = list(get_bert_pretrain_data_loader(path, **kw))[:3]
    assert len(t_batches) == 3
    for jb, tb in zip(j_batches, t_batches):
        for k in jb:
            np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)

    jcfg, tcfg = _cfgs("flash")
    jmodel = JPacked(jcfg)
    mesh = make_mesh({"dp": 1}, devices=jax.devices()[:1])
    opt_kw = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10)
    state, _ = create_train_state(jcfg, mesh, j_batches[0], seed=0,
                                  optimizer=j_make(**opt_kw), model=jmodel)
    j_step = make_sharded_train_step(mesh, jcfg, model=jmodel, donate=False)
    model = BertForPreTrainingPacked(tcfg)
    model.load_state_dict(flax_to_state_dict(jax.device_get(state.params)))
    t_step = make_train_step(model, make_optimizer(model.parameters(),
                                                   **opt_kw))
    for i, (jb, tb) in enumerate(zip(j_batches, t_batches)):
        state, j_metrics = j_step(state, to_device_batch(jb, mesh), seed=0)
        t_metrics = t_step({k: torch.from_numpy(v) for k, v in tb.items()})
        assert "mlm_dropped_labels" in t_metrics
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
