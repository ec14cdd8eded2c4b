"""The port's preprocess CI smokes on the CPU: ``sink_smoke`` (serial
against async sink), ``thread_smoke`` (1 against N native threads) and
``elastic_smoke`` (legacy against batched coordination), each run at
0.25 MiB through its ``LDDL_TPU_*_SMOKE_MB`` and exiting 0 with
``identical: true``; each one's gate rejects a perturbed digest, and a
smoke whose two legs differ exits 1. Also the counterpart of the
reference's ``tests/test_fused.py::test_fused_identity_smoke``: masked,
binned, schema-v2 shards byte-equal across the fused, staged and hf
rungs (``ci_check.sh``'s ``LDDL_TPU_CI_SMOKE_NATIVE`` block runs it).
"""

import os
import shutil
import sys

import pytest

from lddl_tpu_torch.tools import elastic_smoke, sink_smoke, smoke_common

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _torch_smokes import flip_byte, run_smoke  # noqa: E402


@pytest.mark.parametrize("name, var", [
    ("sink", "LDDL_TPU_SINK_SMOKE_MB"),
    ("thread", "LDDL_TPU_THREAD_SMOKE_MB"),
    ("elastic", "LDDL_TPU_ELASTIC_SMOKE_MB")])
def test_smoke_exits_0_identical(name, var):
    rc, report, err = run_smoke(name, var)
    assert rc == 0, err
    assert report["identical"] is True, report
    if name == "sink":
        assert report["corpus_mb"] == 0.25
        assert report["sink"]["tasks"] > 0 and report["sink"]["units"] > 0
    elif name == "thread":
        assert report["n_threads"] >= 2
        assert set(report["tokenize_mb_per_s_by_threads"]) >= {"1", "2"}
    else:
        assert report["units"]["legacy"] == report["units"]["batched"] > 0
        assert report["ops_per_unit"]["batched"] > 0


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A small preprocess output of the port (shards and manifest)."""
    from lddl_tpu_torch.preprocess import (BertPretrainConfig,
                                           get_tokenizer,
                                           run_bert_preprocess)
    tmp = str(tmp_path_factory.mktemp("smoketree"))
    corpus, _, vocab, _ = smoke_common.corpus_with_vocab(tmp, 0.05, 50_000)
    out = os.path.join(tmp, "out")
    run_bert_preprocess(
        {"wikipedia": corpus}, out, get_tokenizer(vocab_file=vocab),
        config=BertPretrainConfig(max_seq_length=128, duplicate_factor=1,
                                  masking=True),
        num_blocks=4, sample_ratio=1.0, seed=12345, bin_size=32,
        num_workers=1)
    return out


def test_tree_digest_gate_rejects_a_flipped_byte(tree, tmp_path):
    """The sink and thread smokes' gate: one flipped byte of a shard, or a
    manifest renamed, is a divergence."""
    copy = str(tmp_path / "copy")
    shutil.copytree(tree, copy)
    same = smoke_common.tree_digest(copy)
    assert smoke_common.identical(smoke_common.tree_digest(tree), same)
    shard = sorted(n for n in os.listdir(copy) if ".parquet" in n)[0]
    flip_byte(os.path.join(copy, shard))
    assert not smoke_common.identical(smoke_common.tree_digest(tree),
                                      smoke_common.tree_digest(copy))
    flip_byte(os.path.join(copy, shard))
    os.rename(os.path.join(copy, ".manifest.json"),
              os.path.join(copy, ".manifest2.json"))
    assert not smoke_common.identical(smoke_common.tree_digest(tree),
                                      smoke_common.tree_digest(copy))


def test_parquet_digest_gate_rejects_a_perturbed_digest(tree):
    """The elastic smoke's gate: equal non-empty shard digests pass; one
    perturbed digest, a missing shard or no shards at all do not."""
    digests = smoke_common.parquet_digests(tree)
    assert digests and all(".parquet" in n for n in digests)
    assert smoke_common.identical(digests, dict(digests))
    name = sorted(digests)[0]
    bad = dict(digests, **{name: digests[name][::-1]})
    assert not smoke_common.identical(digests, bad)
    assert not smoke_common.identical(
        digests, {k: v for k, v in digests.items() if k != name})
    assert not smoke_common.identical({}, {})


def test_sink_smoke_exits_1_on_a_divergence(monkeypatch):
    """A smoke whose legs differ reports it and exits 1 (the async leg's
    tree digest perturbed)."""
    monkeypatch.setenv("LDDL_TPU_SINK_SMOKE_MB", "0.05")
    real = smoke_common.tree_digest

    def perturbed(out):
        d = real(out)
        return d[::-1] if os.path.basename(out) == "async" else d

    monkeypatch.setattr(sink_smoke, "tree_digest", perturbed)
    assert sink_smoke.main() == 1


def test_elastic_counter_sums_every_holder(tmp_path):
    """The lease-op counter the elastic smoke reports sums the newest
    snapshots of every holder, and only the label asked for."""
    import json
    for holder, values in (("s0", {"a": 2, "b": 1}), ("s1", {"a": 3})):
        d = tmp_path / ".telemetry" / holder
        d.mkdir(parents=True)
        (d / "snapshot-pid1.json").write_text(json.dumps(
            {"metrics": {"lease_ops_total": {"values": values}}}))
        (d / "other.json").write_text("{}")
    assert elastic_smoke.counter(str(tmp_path), "lease_ops_total") == 6
    assert elastic_smoke.counter(str(tmp_path), "lease_ops_total",
                                 label="a") == 5
    assert elastic_smoke.counter(str(tmp_path / "none"), "x") == 0


def _shards(out):
    import hashlib
    digests = {}
    for name in sorted(os.listdir(out)):
        if "parquet" in name:
            with open(os.path.join(out, name), "rb") as f:
                digests[name] = hashlib.sha256(f.read()).hexdigest()
    return digests


def test_fused_identity_smoke(tmp_path, monkeypatch):
    """Masked, binned, schema-v2 shards are byte-equal across the fused,
    staged (``LDDL_TPU_NATIVE_FUSED=0``) and hf rungs."""
    from lddl_tpu_torch.preprocess import (BertPretrainConfig,
                                           get_tokenizer,
                                           run_bert_preprocess)
    for key in ("LDDL_TPU_NATIVE_FUSED", "LDDL_TPU_NATIVE_FUSED_MASK",
                "LDDL_TPU_NATIVE_MASK"):
        monkeypatch.delenv(key, raising=False)
    corpus, _, vocab, _ = smoke_common.corpus_with_vocab(str(tmp_path), 0.05,
                                                         50_000)
    tokenizer = get_tokenizer(vocab_file=vocab)

    def run(name, engine="native", env=None):
        for key, value in (env or {}).items():
            monkeypatch.setenv(key, value)
        try:
            out = str(tmp_path / name)
            run_bert_preprocess(
                {"wikipedia": corpus}, out, tokenizer,
                config=BertPretrainConfig(max_seq_length=48,
                                          duplicate_factor=2, masking=True,
                                          schema_version=2,
                                          tokenizer_engine=engine),
                num_blocks=3, sample_ratio=1.0, seed=7, bin_size=16)
        finally:
            for key in (env or {}):
                monkeypatch.delenv(key, raising=False)
        return _shards(out)

    fused = run("fused")
    staged = run("staged", env={"LDDL_TPU_NATIVE_FUSED": "0"})
    hf = run("hf", engine="hf")
    assert fused == staged == hf
    assert len(fused) > 1
