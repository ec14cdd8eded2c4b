"""The port's end-to-end recipe, ``lddl_tpu_torch/examples/local_example.sh``,
at its defaults (only ``DATA`` set): its eight stages all run (``set -e``
stops it at the first that fails), ``validate_seqlen`` prints ``PASS``,
the corpus is byte for byte the root ``bench.make_corpus``'s for the same
arguments, and the packed stage's batch count and pad ratio are what
``lddl_tpu``'s loader gives on the port's ``bal_unb`` tree."""

import os
import re
import subprocess

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = os.path.join(ROOT, "lddl_tpu_torch", "examples", "local_example.sh")
STAGES = ("corpus", "vocab", "preprocess", "balance", "mock training",
          "validate binning", "BART family", "sequence packing")


@pytest.fixture(scope="module")
def recipe(tmp_path_factory):
    data = str(tmp_path_factory.mktemp("recipe") / "data")
    proc = subprocess.run(["bash", RECIPE], capture_output=True, text=True,
                          timeout=240, env=dict(os.environ, DATA=data))
    return data, proc


def test_recipe_runs_every_stage(recipe):
    data, proc = recipe
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    banners = re.findall(r"^== (\d)\. (.*) ==$", proc.stdout, re.M)
    assert [int(n) for n, _ in banners] == list(range(1, 9))
    for (_, title), stage in zip(banners, STAGES):
        assert title.startswith(stage), (title, stage)
    assert proc.stdout.splitlines()[-1] == "example complete: " + data
    # Stage 6's verdict; stage 5 wrote one dump per simulated dp group.
    six = proc.stdout.split("== 6.")[1].split("== 7.")[0]
    assert six.strip().splitlines()[-1] == "PASS"
    assert sorted(os.listdir(os.path.join(data, "seqlens"))) == [
        "lens_0.npz", "lens_1.npz"]
    for out in ("pre", "bal", "bart_pre", "bart_bal", "pre_unb", "bal_unb"):
        assert any(".parquet" in n for n in os.listdir(os.path.join(
            data, out))), out


def test_recipe_corpus_is_bench_corpus(recipe, tmp_path):
    import bench
    data, proc = recipe
    assert proc.returncode == 0, proc.stderr[-3000:]
    n, _ = bench.make_corpus(str(tmp_path / "wiki"), target_mb=4, shards=4)
    assert "corpus bytes: {}\n".format(n) in proc.stdout
    ref = tmp_path / "wiki" / "source"
    got = os.path.join(data, "wiki", "source")
    assert sorted(os.listdir(got)) == sorted(os.listdir(ref))
    for name in sorted(os.listdir(ref)):
        with open(os.path.join(got, name), "rb") as a, \
                open(ref / name, "rb") as b:
            assert a.read() == b.read(), name


def test_recipe_packing_matches_reference_loader(recipe):
    from lddl_tpu.loader import get_bert_pretrain_data_loader
    data, proc = recipe
    assert proc.returncode == 0, proc.stderr[-3000:]
    loader = get_bert_pretrain_data_loader(
        data + "/bal_unb", vocab_file=data + "/vocab.txt", batch_size=32,
        pack_seq_length=256, pack_rows=8)
    n = sum(1 for _ in loader)
    want = "packed: {} batches of [8, 256], {} samples, pad ratio " \
        "{:.2%}".format(n, loader.n_samples, loader.pad_ratio)
    assert n > 0 and want in proc.stdout.splitlines()
