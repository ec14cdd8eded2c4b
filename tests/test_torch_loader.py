"""The port's loaders (lddl_tpu_torch.loader) against lddl_tpu's: shards
built live by lddl_tpu's preprocess -> balance over the tiny corpus, then
byte-equal batches from both packages' get_bert_pretrain_data_loader over
two epochs, for dp ranks 0 and 1 of 2 (and two workers of one group), in
every bin, with static and dynamic masking; the same for
get_bart_pretrain_data_loader over BART shards (schema v2 from lddl_tpu's
BART preprocess with a tokenizer and from ``testing.write_bart_shards``,
schema v1 from the preprocess without one).
The reference loaders get their tokenizer from transformers over the same
vocab file the port reads with its own Vocab.
"""

import glob
import os

import numpy as np
import pytest

import torch

from lddl_tpu_torch.loader import (Vocab, get_bart_pretrain_data_loader,
                                   get_bert_pretrain_data_loader,
                                   prefetch_to_device)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _build_shards(corpus_root, masking):
    """lddl_tpu preprocess (4 length bins of 16 tokens) -> balance into 2
    shards per bin; returns (balanced dir, vocab file)."""
    from lddl_tpu.balance import balance_shards
    from lddl_tpu.preprocess import (BertPretrainConfig,
                                     build_wordpiece_vocab, get_tokenizer,
                                     run_bert_preprocess)
    texts = []
    for p in sorted(glob.glob(os.path.join(corpus_root, "source", "*.txt"))):
        with open(p) as f:
            texts.append(f.read())
    vocab = build_wordpiece_vocab(texts, os.path.join(corpus_root,
                                                      "vocab.txt"),
                                  vocab_size=300)
    pre = os.path.join(corpus_root, "pre")
    run_bert_preprocess(
        {"wiki": corpus_root}, pre, get_tokenizer(vocab_file=vocab),
        config=BertPretrainConfig(max_seq_length=64, duplicate_factor=5,
                                  masking=masking),
        num_blocks=4, sample_ratio=1.0, seed=0, bin_size=16)
    bal = os.path.join(corpus_root, "bal")
    balance_shards(pre, bal, 2)
    return bal, vocab


@pytest.mark.parametrize("masking", [True, False], ids=["static", "dynamic"])
def test_batches_byte_equal_to_reference(tiny_corpus, masking):
    from lddl_tpu.loader import get_bert_pretrain_data_loader as j_loader
    path, vocab = _build_shards(tiny_corpus, masking)
    n_bins = len({os.path.basename(p).split("_")[-1]
                  for p in glob.glob(os.path.join(path, "*.parquet_*"))})
    assert n_bins == 4
    for dp_rank, num_dp_groups, num_workers in ((0, 2, 1), (1, 2, 1),
                                                (0, 1, 2)):
        kw = dict(dp_rank=dp_rank, num_dp_groups=num_dp_groups,
                  num_workers=num_workers, batch_size=8, vocab_file=vocab,
                  shuffle_buffer_size=32, shuffle_buffer_warmup_factor=4,
                  fixed_seq_lengths=[16, 32, 48, 64], base_seed=11)
        ref, port = j_loader(path, **kw), get_bert_pretrain_data_loader(
            path, **kw)
        assert len(port) == len(ref)
        seen = set()
        for epoch in range(2):
            ref_batches, port_batches = list(ref), list(port)
            assert len(port_batches) == len(ref_batches) == len(ref)
            for i, (rb, pb) in enumerate(zip(ref_batches, port_batches)):
                assert pb.keys() == rb.keys()
                for k in rb:
                    assert pb[k].dtype == rb[k].dtype, k
                    np.testing.assert_array_equal(
                        pb[k], rb[k], err_msg="epoch {} batch {} {}".format(
                            epoch, i, k))
                seen.add(rb["input_ids"].shape[1])
        assert seen == {16, 32, 48, 64}


def test_vocab_matches_hf_tokenizer(tiny_corpus):
    """The collate's tokenizer interface, read without transformers."""
    from lddl_tpu.preprocess import build_wordpiece_vocab, get_tokenizer
    with open(os.path.join(tiny_corpus, "source", "0.txt")) as f:
        vocab_file = build_wordpiece_vocab(
            [f.read()], os.path.join(tiny_corpus, "v.txt"), vocab_size=200)
    hf, port = get_tokenizer(vocab_file=vocab_file), Vocab(vocab_file)
    assert len(port) == len(hf)
    assert port.get_vocab() == dict(hf.get_vocab())
    for tok in ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "alpha",
                "not-in-vocab"):
        assert port.convert_tokens_to_ids(tok) == \
            hf.convert_tokens_to_ids(tok), tok
    assert port.unk_token == hf.unk_token


def test_prefetch_to_device_keeps_order(tmp_path):
    """The prefetcher yields the loader's batches, in order, as tensors;
    each iteration runs one epoch of the wrapped loader."""
    from lddl_tpu_torch.testing import write_balanced_shards, write_vocab
    tokens = write_vocab(str(tmp_path / "vocab.txt"), 128, seed=1)
    write_balanced_shards(str(tmp_path / "bal"), tokens, num_bins=2,
                          bin_size=32, shards_per_bin=1,
                          samples_per_shard=10, masking=False, seed=1)

    def loader(start_epoch=0):
        return get_bert_pretrain_data_loader(
            str(tmp_path / "bal"), vocab_file=str(tmp_path / "vocab.txt"),
            batch_size=3, fixed_seq_lengths=[32, 64], base_seed=2,
            start_epoch=start_epoch)

    prefetched = prefetch_to_device(loader(), device="cpu", depth=1)
    for epoch in range(2):
        got = list(prefetched)
        want = list(loader(start_epoch=epoch))
        assert len(got) == len(want) == len(prefetched)
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for k in w:
                assert isinstance(g[k], torch.Tensor)
                np.testing.assert_array_equal(g[k].numpy(), w[k])


def _build_bart_shards(corpus_root, tokenized):
    """lddl_tpu BART preprocess (schema v2 with a tokenizer, v1 without)
    -> balance into 2 shards; returns (balanced dir, vocab file)."""
    from lddl_tpu.balance import balance_shards
    from lddl_tpu.preprocess import (BartPretrainConfig,
                                     build_wordpiece_vocab, get_tokenizer,
                                     run_bart_preprocess)
    texts = []
    for p in sorted(glob.glob(os.path.join(corpus_root, "source", "*.txt"))):
        with open(p) as f:
            texts.append(f.read())
    vocab = build_wordpiece_vocab(texts, os.path.join(corpus_root,
                                                      "bart_vocab.txt"),
                                  vocab_size=300)
    tag = "v2" if tokenized else "v1"
    pre = os.path.join(corpus_root, "bart_pre_" + tag)
    run_bart_preprocess(
        {"wiki": corpus_root}, pre,
        config=BartPretrainConfig(target_seq_length=48), num_blocks=4,
        sample_ratio=1.0, seed=0,
        tokenizer=get_tokenizer(vocab_file=vocab) if tokenized else None)
    bal = os.path.join(corpus_root, "bart_bal_" + tag)
    balance_shards(pre, bal, 2)
    return bal, vocab


def _assert_bart_batches_equal(path, vocab, **extra):
    from lddl_tpu.loader import get_bart_pretrain_data_loader as j_loader
    for dp_rank in (0, 1):
        kw = dict(dp_rank=dp_rank, num_dp_groups=2, batch_size=4,
                  vocab_file=vocab, shuffle_buffer_size=32,
                  shuffle_buffer_warmup_factor=4, base_seed=11, **extra)
        ref = j_loader(path, log_level=50, **kw)
        port = get_bart_pretrain_data_loader(path, **kw)
        assert len(port) == len(ref)
        for epoch in range(2):
            ref_batches, port_batches = list(ref), list(port)
            assert len(port_batches) == len(ref_batches) == len(ref) > 0
            for i, (rb, pb) in enumerate(zip(ref_batches, port_batches)):
                assert pb.keys() == rb.keys()
                for k in rb:
                    assert pb[k].dtype == rb[k].dtype, k
                    np.testing.assert_array_equal(
                        pb[k], rb[k], err_msg="rank {} epoch {} batch {} {}"
                        .format(dp_rank, epoch, i, k))


def test_bart_batches_byte_equal_to_reference(tiny_corpus):
    """Shards from lddl_tpu's BART preprocess (schema v2) + balance."""
    path, vocab = _build_bart_shards(tiny_corpus, tokenized=True)
    _assert_bart_batches_equal(path, vocab, max_seq_length=64)


def test_bart_batches_byte_equal_on_written_shards(tmp_path):
    """write_bart_shards shards at the chip run's window: every batch is
    padded to exactly 1024 and the clean window is full."""
    from lddl_tpu_torch.testing import write_bart_shards, write_vocab
    write_vocab(str(tmp_path / "vocab.txt"), 512, seed=4)
    write_bart_shards(str(tmp_path / "bal"), 512, num_shards=2,
                      samples_per_shard=8, seed=4)
    _assert_bart_batches_equal(str(tmp_path / "bal"),
                               str(tmp_path / "vocab.txt"),
                               max_seq_length=1024, fixed_seq_length=1024)
    batch = next(iter(get_bart_pretrain_data_loader(
        str(tmp_path / "bal"), vocab_file=str(tmp_path / "vocab.txt"),
        batch_size=4, max_seq_length=1024, fixed_seq_length=1024)))
    assert batch["input_ids"].shape == (4, 1024)
    assert ((batch["labels"] != -1).sum(axis=1) == 1024).all()


def test_bart_schema_v1_shards_are_refused(tiny_corpus):
    """Text-only (schema-v1) BART shards were once refused by the port;
    they now load, split and tokenized in the collate, to the reference's
    batches byte for byte."""
    path, vocab = _build_bart_shards(tiny_corpus, tokenized=False)
    _assert_bart_batches_equal(path, vocab, max_seq_length=64)
