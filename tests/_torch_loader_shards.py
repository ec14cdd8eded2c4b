"""Shared helpers of the port's loader-runtime tests: a small corpus,
balanced shards made live by lddl_tpu's preprocess and balancer, and
batch comparison of the port's loaders against lddl_tpu's."""

import hashlib
import os

import numpy as np

WORDS = ("alpha beta gamma delta epsilon zeta eta theta iota kappa lambda "
         "mu nu xi omicron pi rho sigma tau upsilon").split()


def build_corpus(root, num_docs=48, num_files=3, seed=31):
    """A one-document-per-line corpus under ``root/source`` and its
    WordPiece vocab (lddl_tpu's trainer); returns (root, vocab file)."""
    from lddl_tpu.preprocess import build_wordpiece_vocab
    source = os.path.join(root, "source")
    os.makedirs(source, exist_ok=True)
    g = np.random.Generator(np.random.Philox(key=[0, seed]))
    docs = []
    for d in range(num_docs):
        sents = []
        for _ in range(int(g.integers(2, 8))):
            n = int(g.integers(4, 14))
            sents.append(" ".join(WORDS[int(g.integers(0, len(WORDS)))]
                                  for _ in range(n)).capitalize() + ".")
        docs.append("doc-{} {}".format(d, " ".join(sents)))
    for f in range(num_files):
        with open(os.path.join(source, "{}.txt".format(f)), "w") as fh:
            for line in docs[f::num_files]:
                fh.write(line + "\n")
    vocab = build_wordpiece_vocab([" ".join(WORDS)] * 3,
                                  os.path.join(root, "vocab.txt"),
                                  vocab_size=300)
    return root, vocab


def ref_shards(corpus, vocab, out, num_shards, bin_size=None,
               masking=False, schema_version=2):
    """lddl_tpu preprocess (max_seq_length 64) -> balance into
    ``num_shards`` shards (a bin); returns the balanced directory."""
    from lddl_tpu.balance import balance_shards
    from lddl_tpu.preprocess import (BertPretrainConfig, get_tokenizer,
                                     run_bert_preprocess)
    pre = out + "_pre"
    run_bert_preprocess(
        {"wiki": corpus}, pre, get_tokenizer(vocab_file=vocab),
        config=BertPretrainConfig(max_seq_length=64, duplicate_factor=2,
                                  masking=masking,
                                  schema_version=schema_version),
        num_blocks=4, sample_ratio=1.0, seed=0, bin_size=bin_size)
    balance_shards(pre, out, num_shards)
    return out


def ref_loader(path, **kw):
    from lddl_tpu.loader import get_bert_pretrain_data_loader
    return get_bert_pretrain_data_loader(path, log_level=50, **kw)


def port_loader(path, **kw):
    from lddl_tpu_torch.loader import get_bert_pretrain_data_loader
    return get_bert_pretrain_data_loader(path, **kw)


def as_numpy(batch):
    if isinstance(batch, dict):
        return {k: np.asarray(v) for k, v in batch.items()}
    return batch


def assert_same_batches(got, want, what=""):
    """Byte-equal batch streams: same count, keys, dtypes and values."""
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0, (what, len(got), len(want))
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = as_numpy(g), as_numpy(w)
        if not isinstance(w, dict):
            assert repr(g) == repr(w), (what, i)
            continue
        assert sorted(g) == sorted(w), (what, i)
        for k in w:
            assert g[k].dtype == w[k].dtype, (what, i, k)
            np.testing.assert_array_equal(
                g[k], w[k], err_msg="{} batch {} {}".format(what, i, k))


def digest(batches):
    """(count, sha256) over every batch's arrays, keys in order."""
    h = hashlib.sha256()
    n = 0
    for batch in batches:
        for key in sorted(batch):
            h.update(key.encode())
            h.update(np.ascontiguousarray(np.asarray(batch[key])).tobytes())
        n += 1
    return n, h.hexdigest()
