"""The cell's inputs: the same seed gives the same shards, and the shards
hold the traffic file's mix."""

import os

import numpy as np
import pyarrow.parquet as pq

from portbench import data
from portbench.tests.tiny import tiny_cell


def _tables(shards):
    names = sorted(f for f in os.listdir(shards) if ".parquet" in f)
    return names, [pq.read_table(os.path.join(shards, n)) for n in names]


def test_bert_same_seed_same_shards(tmp_path):
    cell = tiny_cell("bert_large.p2_binned")
    out = [data.bert_binned(str(tmp_path / d), cell.traffic,
                            cell.cfg["vocab_size"], s)
           for d, s in (("a", 7), ("b", 7), ("c", 8))]
    (na, ta), (nb, tb), (_, tc) = (_tables(o[0]) for o in out)
    assert na == nb and all(x.equals(y) for x, y in zip(ta, tb))
    assert not all(x.equals(y) for x, y in zip(ta, tc))
    with open(out[0][1]) as f, open(out[1][1]) as g:
        assert f.read() == g.read()


def test_bert_bins_hold_the_traffic_mix(tmp_path):
    cell = tiny_cell("bert_large.p2_binned")
    tr = cell.traffic
    shards, _, index = data.bert_binned(str(tmp_path), tr,
                                        cell.cfg["vocab_size"], 3)
    want = data.bert_lengths(tr)
    names, tables = _tables(shards)
    per_bin = {}
    for name, t in zip(names, tables):
        k = int(name.rsplit("_", 1)[1])
        lens = t.column("num_tokens").to_numpy().astype(int)
        per_bin.setdefault(k, []).extend(lens.tolist())
        size = tr["bin_size"]
        assert lens.min() >= max(k * size + 1, 5)
        assert lens.max() <= (k + 1) * size
        assert set(t.column("bin_id").to_pylist()) == {k}
        k_pred = np.array([len(x) for x in
                           t.column("masked_lm_label_ids").to_pylist()])
        body = lens - 3
        assert np.all(k_pred <= tr["max_predictions_per_seq"])
        assert np.all(k_pred == np.clip(np.rint(0.15 * body), 1,
                                         tr["max_predictions_per_seq"]))
    assert sum(len(v) for v in per_bin.values()) == len(index)
    for k, lens in enumerate(want):
        # the same lengths for every seed, only their order is the seed's
        assert sorted(per_bin.get(k, [])) == lens.tolist()
    shares = np.asarray(tr["length_shares"])
    total = sum(len(x) for x in want)
    for k, lens in enumerate(want):
        share = shares[k * tr["bin_size"]:(k + 1) * tr["bin_size"]].sum()
        # rounding a count a length, and each bin cut to its shards
        assert abs(len(lens) - share * total) <= tr["bin_size"] / 2 + \
            tr["shards_per_bin"]


def test_traffic_length_shares_follow_the_rule():
    """The shares the BERT mix holds are those portbench.lengths derives
    from its rule, and the rule's samples are mostly full-length with a
    tail of short ones (one document in ten targets a shorter length)."""
    import json
    import os
    from portbench import lengths
    from portbench.harness import ROOT
    with open(os.path.join(ROOT, "traffic", "p2_binned.json")) as f:
        tr = json.load(f)
    assert lengths.derive(tr["lengths"]) == tr["length_shares"]
    shares = np.asarray(tr["length_shares"])
    assert abs(shares.sum() - 1) < 1e-6 and shares[:4].sum() == 0
    assert 0.6 < shares[-1] < 0.8
    assert 0 < shares[:128].sum() < shares[-128:].sum()


def test_bert_masks_as_stored(tmp_path):
    cell = tiny_cell("bert_large.p2_binned")
    _, _, index = data.bert_binned(str(tmp_path), cell.traffic,
                                   cell.cfg["vocab_size"], 11)
    kept = masked = 0
    for _, a, b, _, pos, lab in index.values():
        seq = np.concatenate([[data.CLS], a, [data.SEP], b, [data.SEP]])
        assert np.all(np.diff(pos) > 0) and pos.min() >= 1
        assert not np.isin(pos, [0, len(a) + 1, len(seq) - 1]).any()
        masked += int((seq[pos] == data.MASK).sum())
        kept += int((seq[pos] == lab).sum())
    total = sum(len(v[4]) for v in index.values())
    assert 0.75 < masked / total < 0.85 and 0.07 < kept / total < 0.13


def test_bart_chunks(tmp_path):
    cell = tiny_cell("bart_base.L1024")
    tr = cell.traffic
    shards, _, index = data.bart_chunks(str(tmp_path), tr,
                                        cell.cfg["vocab_size"], 5)
    names, tables = _tables(shards)
    assert len(names) == tr["shards"] and len(index) == tr["chunks"]
    for t in tables:
        ids = t.column("sentence_ids").to_pylist()
        lens = t.column("sentence_lens").to_pylist()
        for i, ls in zip(ids, lens):
            assert len(i) == sum(ls) >= tr["min_chunk_tokens"]
            lo, hi = tr["sentence_tokens"]
            assert min(ls) >= lo and max(ls) <= hi
    again = data.bart_chunks(str(tmp_path / "again"), tr,
                             cell.cfg["vocab_size"], 5)[2]
    assert all(np.array_equal(index[k], again[k]) for k in index)
