"""The port's balancer (lddl_tpu_torch.balance) against lddl_tpu's on the
same unbalanced inputs: the same shard files with equal tables and the
same .num_samples.json and .manifest.json bytes, at worlds 1, 2 and 4
(ThreadGroupCommunicator rank-threads), binned and unbinned; the same
transfer plan, metadata-only, on the reference tests' adversarial size
cases (tests/test_balance.py:200-244: giant + empties, uniform, heavy
tail, totals straddling the +-1 boundary); and the cache CLI.

Then the whole chain: the port's preprocess CLI -> balance CLI -> loader
gives batches byte-equal to lddl_tpu's preprocess -> balancer -> loader
on the same corpus, vocab and seeds.
"""

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from lddl_tpu.balance import balance_shards as r_balance
from lddl_tpu.balance import balancer as rbal
from lddl_tpu.parallel import ThreadGroupCommunicator as RThreads
from lddl_tpu_torch.balance import balance_shards as t_balance
from lddl_tpu_torch.balance import balancer as tbal
from lddl_tpu_torch.parallel import ThreadGroupCommunicator as TThreads


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _write_unbalanced(dir_path, sizes, bin_id=None, tag=0):
    os.makedirs(dir_path, exist_ok=True)
    postfix = "" if bin_id is None else "_{}".format(bin_id)
    for i, n in enumerate(sizes):
        t = pa.table({
            "A": ["{}-{}-{}".format(tag, i, j) for j in range(n)],
            "B": ["b"] * n,
            "is_random_next": [j % 3 == 0 for j in range(n)],
            "num_tokens": pa.array([5 + j % 7 for j in range(n)],
                                   type=pa.uint16()),
            "A_ids": pa.array([[i, j] for j in range(n)],
                              type=pa.list_(pa.int32())),
        })
        pq.write_table(t, os.path.join(
            dir_path, "part.{}.parquet{}".format(i, postfix)))


def _assert_same_dir(got, want):
    names = sorted(os.listdir(want))
    assert sorted(os.listdir(got)) == names
    for name in names:
        a, b = os.path.join(got, name), os.path.join(want, name)
        if ".parquet" in name:
            assert pq.read_table(a).equals(pq.read_table(b)), name
        else:
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), name


def _balance(fn, threads, src, dst, num_shards, world):
    if world == 1:
        return [fn(src, dst, num_shards)]
    return threads.spawn(world, lambda comm: fn(src, dst, num_shards,
                                                comm=comm))


@pytest.mark.parametrize("world", [1, 2, 4])
@pytest.mark.parametrize("binned", [False, True])
def test_balance_matches_reference(tmp_path, world, binned):
    src = str(tmp_path / "src")
    if binned:
        _write_unbalanced(src, [40, 2, 0, 17], bin_id=0, tag=0)
        _write_unbalanced(src, [7, 31, 1, 5], bin_id=1, tag=1)
    else:
        _write_unbalanced(src, [23, 1, 64, 9, 0, 41, 13])
    want = _balance(r_balance, RThreads, src, str(tmp_path / "ref"), 4, 1)
    got = _balance(t_balance, TThreads, src, str(tmp_path / "port"), 4,
                   world)
    assert all(counts == want[0] for counts in got)
    _assert_same_dir(str(tmp_path / "port"), str(tmp_path / "ref"))


class _MetaComm:
    """A communicator on which no rank owns a transfer: the plan runs
    metadata-only (what a non-owner rank executes)."""
    world_size = 1 << 30
    rank = world_size - 1

    def barrier(self):
        pass


def _random_sizes(g):
    """The reference tests' adversarial scenarios."""
    kind = int(g.integers(0, 4))
    n_files = int(g.integers(1, 40))
    if kind == 0:  # one giant file + many (near-)empty files
        sizes = [int(g.integers(0, 3)) for _ in range(n_files)]
        sizes[int(g.integers(0, n_files))] = int(g.integers(10_000,
                                                            1_000_000))
    elif kind == 1:  # uniform-ish
        sizes = [int(g.integers(0, 200)) for _ in range(n_files)]
    elif kind == 2:  # heavy-tailed
        sizes = [int(g.pareto(0.8) * 50) for _ in range(n_files)]
    else:  # totals straddling the boundary: k*s + r for tiny r
        hint = int(g.integers(1, 13))
        total = int(g.integers(1, 50)) * hint + min(
            int(g.integers(0, 2)) * int(g.integers(1, hint + 1)), hint - 1)
        sizes, left = [], total
        for _ in range(n_files - 1):
            take = int(g.integers(0, left + 1)) if left else 0
            sizes.append(take)
            left -= take
        sizes.append(left)
    return sizes


def _plan(mod, file_cls, sizes, num_shards):
    files = [file_cls("mem://{}".format(i), n) for i, n in enumerate(sizes)]
    targets = mod.compute_targets(sum(sizes), num_shards)
    stats = {}
    shards = [mod._Shard(i, files[i::num_shards], "mem://", stats=stats)
              for i in range(num_shards)]
    iters = mod._converge(shards, targets, _MetaComm())
    parts = [[(f.path, f.num_samples) for f in s.input_files + s.output_parts]
             for s in shards]
    return iters, [s.num_samples for s in shards], targets, stats, parts


@pytest.mark.parametrize("seed", range(20))
def test_balance_plan_matches_reference(seed):
    from lddl_tpu.utils.types import File as RFile
    from lddl_tpu_torch.utils.types import File as TFile
    g = np.random.default_rng(seed)
    sizes = _random_sizes(g)
    num_shards = int(g.integers(1, 13))
    if sum(sizes) < num_shards:
        sizes.append(num_shards - sum(sizes))
    got = _plan(tbal, TFile, sizes, num_shards)
    assert got == _plan(rbal, RFile, sizes, num_shards)
    iters, counts, targets, stats, _ = got
    assert iters <= 1 and counts == targets
    assert stats.get("rows_read", 0) <= sum(sizes)


def test_cache_cli_matches_reference(tmp_path):
    from lddl_tpu.balance import generate_num_samples_cache as r_cache
    from lddl_tpu_torch.cli import generate_num_samples_cache as cli
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    _write_unbalanced(a, [5, 8, 0])
    _write_unbalanced(b, [5, 8, 0])
    cli.main(cli.attach_args().parse_args(["--path", a]))
    r_cache(b)
    _assert_same_dir(a, b)


def _batches(loader_fn, path, vocab):
    """Every batch of two epochs (each iteration runs one epoch)."""
    loader = loader_fn(path, vocab_file=vocab, batch_size=4,
                       fixed_seq_lengths=[32, 64], base_seed=5,
                       shuffle_buffer_size=64, shuffle_buffer_warmup_factor=4)
    return [b for _ in range(2) for b in loader]


def test_cli_chain_feeds_the_loader_reference_batches(tmp_path, tiny_corpus):
    """Port preprocess CLI -> port balance CLI -> port loader, against the
    reference's whole chain: byte-equal batches over two epochs."""
    from lddl_tpu.loader import get_bert_pretrain_data_loader as r_loader
    from lddl_tpu.preprocess import (BertPretrainConfig, get_tokenizer,
                                     run_bert_preprocess)
    from lddl_tpu_torch.cli import balance_shards as bal_cli
    from lddl_tpu_torch.cli import preprocess_bert_pretrain as pre_cli
    from lddl_tpu_torch.loader import get_bert_pretrain_data_loader
    from lddl_tpu_torch.preprocess import build_wordpiece_vocab
    texts = [open(os.path.join(tiny_corpus, "source", n)).read()
             for n in sorted(os.listdir(os.path.join(tiny_corpus,
                                                     "source")))]
    vocab = build_wordpiece_vocab(texts, str(tmp_path / "vocab.txt"),
                                  vocab_size=150)
    pre_cli.main(pre_cli.attach_args().parse_args([
        "--wikipedia", tiny_corpus, "--sink", str(tmp_path / "pre"),
        "--vocab-file", vocab, "--target-seq-length", "64",
        "--bin-size", "32", "--masking", "--duplicate-factor", "2",
        "--num-blocks", "4", "--local-workers", "1", "--seed", "9"]))
    bal_cli.main(bal_cli.attach_args().parse_args([
        "--indir", str(tmp_path / "pre"), "--outdir", str(tmp_path / "bal"),
        "--num-shards", "2"]))
    run_bert_preprocess(
        {"wikipedia": tiny_corpus}, str(tmp_path / "rpre"),
        get_tokenizer(vocab_file=vocab),
        config=BertPretrainConfig(max_seq_length=64, masking=True,
                                  duplicate_factor=2),
        num_blocks=4, seed=9, bin_size=32)
    r_balance(str(tmp_path / "rpre"), str(tmp_path / "rbal"), 2)
    _assert_same_dir(str(tmp_path / "bal"), str(tmp_path / "rbal"))
    got = _batches(get_bert_pretrain_data_loader, str(tmp_path / "bal"),
                   vocab)
    want = _batches(r_loader, str(tmp_path / "rbal"), vocab)
    assert len(got) == len(want) >= 30
    assert {b["input_ids"].shape[1] for b in want} == {32, 64}
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b)
        for k in b:
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


def _cli_world(module, args, world=2):
    """``python -m lddl_tpu_torch.cli.<module> --multihost`` on ``world``
    local processes joined in a gloo group; raises on a failed rank. The
    test serves the rendezvous store itself, on a port the kernel picks,
    and holds it until every rank has ended; with
    ``TORCHELASTIC_USE_AGENT_STORE`` each rank's ``tcp://`` rendezvous is
    a client of it, so no rank binds the coordinator's port."""
    import subprocess
    import sys
    import torch.distributed as dist
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root,
               TORCHELASTIC_USE_AGENT_STORE="True")
    store = dist.TCPStore("127.0.0.1", 0, world, is_master=True,
                          wait_for_workers=False)
    addr = "127.0.0.1:{}".format(store.port)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "lddl_tpu_torch.cli." + module, *args,
         "--multihost", "--coordinator-address", addr, "--num-processes",
         str(world), "--process-id", str(rank)], cwd=root, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(world)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    del store
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out


def test_multihost_clis_equal_one_process(tmp_path, tiny_corpus):
    """--multihost: the preprocess and balance CLIs as a gloo world of 2
    processes write what one process writes."""
    from lddl_tpu_torch.cli import balance_shards as bal_cli
    from lddl_tpu_torch.cli import preprocess_bert_pretrain as pre_cli
    from lddl_tpu_torch.testing import write_vocab
    vocab = str(tmp_path / "vocab.txt")
    write_vocab(vocab, 300, seed=1)
    pre = ["--wikipedia", tiny_corpus, "--vocab-file", vocab,
           "--target-seq-length", "64", "--bin-size", "32", "--masking",
           "--duplicate-factor", "1", "--num-blocks", "4",
           "--local-workers", "1"]
    _cli_world("preprocess_bert_pretrain",
               pre + ["--sink", str(tmp_path / "pre2")])
    _cli_world("balance_shards", ["--indir", str(tmp_path / "pre2"),
                                  "--outdir", str(tmp_path / "bal2"),
                                  "--num-shards", "3"])
    pre_cli.main(pre_cli.attach_args().parse_args(
        pre + ["--sink", str(tmp_path / "pre1")]))
    bal_cli.main(bal_cli.attach_args().parse_args([
        "--indir", str(tmp_path / "pre1"), "--outdir", str(tmp_path / "bal1"),
        "--num-shards", "3"]))
    _assert_same_dir(str(tmp_path / "pre2"), str(tmp_path / "pre1"))
    _assert_same_dir(str(tmp_path / "bal2"), str(tmp_path / "bal1"))
