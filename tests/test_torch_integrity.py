"""The port's startup shard verification (lddl_tpu_torch.resilience.
integrity.verify_shards and the loaders' ``on_corrupt``) against
lddl_tpu's: a truncated shard fails startup by name or is quarantined
(exactly it), same-size corruption is caught by the CRC re-hash, a
transient stat error heals, ranks exclude the same shards, a quarantined
whole bin is named as such, and the survivors load to the reference's
batches. Also the resilient I/O layer's fault grammar and retries."""

import os
import shutil
import warnings

import pyarrow as pa
import pytest

from lddl_tpu_torch.resilience import faults, integrity
from lddl_tpu_torch.resilience import io as rio


@pytest.fixture(autouse=True)
def _always_disarm(monkeypatch):
    monkeypatch.setenv("LDDL_TPU_RETRY_BASE_DELAY_S", "0.001")
    faults.disarm()
    yield
    faults.disarm()


def _make_shards(d, n_shards=4, bins=None):
    """Balanced schema-v1 BERT shards (3 rows each), a sample-count cache
    and the manifest; returns the shard paths."""
    from lddl_tpu_torch.utils.fs import write_num_samples_cache
    os.makedirs(d, exist_ok=True)
    paths, counts = [], {}
    for b in (bins or [None]):
        for i in range(n_shards):
            rows = {"A": ["alpha beta"] * 3, "B": ["gamma delta"] * 3,
                    "is_random_next": [False, True, False],
                    "num_tokens": [7, 7, 7]}
            name = "shard-{}.parquet".format(i)
            if b is not None:
                rows["bin_id"] = [b] * 3
                name += "_{}".format(b)
            p = os.path.join(d, name)
            rio.write_table_atomic(pa.table(rows), p)
            paths.append(p)
            counts[name] = 3
    write_num_samples_cache(d, counts)
    integrity.build_manifest(d)
    return paths


def _truncate(path, size):
    with open(path, "r+b") as f:
        f.truncate(size)


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    from lddl_tpu.preprocess import build_wordpiece_vocab
    d = tmp_path_factory.mktemp("vocab")
    return build_wordpiece_vocab(["alpha beta gamma delta"] * 3,
                                 str(d / "vocab.txt"), vocab_size=100)


@pytest.mark.parametrize("policy", ["fail", "quarantine"])
def test_truncated_shard_matches_reference_verdict(tmp_path, policy):
    from lddl_tpu.resilience import integrity as ref
    paths = _make_shards(str(tmp_path))
    _truncate(paths[2], os.path.getsize(paths[2]) // 2)
    if policy == "fail":
        for mod in (integrity, ref):
            with pytest.raises(mod.ShardIntegrityError, match="shard-2"):
                mod.verify_shards(paths)
        return
    with pytest.warns(UserWarning, match="QUARANTINED"):
        good, excluded = integrity.verify_shards(paths, on_corrupt=policy)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert (good, excluded) == ref.verify_shards(paths,
                                                     on_corrupt=policy)
    assert good == [paths[0], paths[1], paths[3]]
    assert [p for p, _ in excluded] == [paths[2]]
    assert "size mismatch" in excluded[0][1]


def test_same_size_corruption_caught_by_crc(tmp_path, monkeypatch):
    paths = _make_shards(str(tmp_path))
    size = os.path.getsize(paths[0])
    with open(paths[0], "r+b") as f:
        f.seek(size // 2)
        f.write(b"\xff\xfe")
    good, _ = integrity.verify_shards(paths, on_corrupt="quarantine")
    assert good == paths   # a size check cannot see it
    monkeypatch.setenv("LDDL_TPU_VERIFY_CRC", "1")
    with pytest.warns(UserWarning, match="crc32 mismatch"):
        good, excluded = integrity.verify_shards(paths,
                                                 on_corrupt="quarantine")
    assert [p for p, _ in excluded] == [paths[0]]


def test_verify_retries_transient_stat_errors(tmp_path):
    paths = _make_shards(str(tmp_path))
    faults.arm("open:eio:nth=1")
    assert integrity.verify_shards(paths) == (paths, [])


def test_verify_is_rank_strided_and_spmd_consistent(tmp_path):
    from lddl_tpu_torch.parallel.distributed import ThreadGroupCommunicator
    paths = _make_shards(str(tmp_path), n_shards=5)
    _truncate(paths[3], 4)

    def check(comm):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            good, excluded = integrity.verify_shards(
                paths, on_corrupt="quarantine", comm=comm)
        return good, [p for p, _ in excluded]

    results = ThreadGroupCommunicator.spawn(3, check)
    assert results[0] == results[1] == results[2]
    assert results[0][1] == [paths[3]]


def test_missing_manifest_and_unknown_policy(tmp_path):
    paths = _make_shards(str(tmp_path))
    os.remove(os.path.join(str(tmp_path), integrity.MANIFEST_NAME))
    _truncate(paths[0], 3)
    assert integrity.verify_shards(paths) == (paths, [])
    with pytest.raises(ValueError, match="on_corrupt"):
        integrity.verify_shards([], on_corrupt="shrug")


def test_whole_bin_quarantined_names_the_quarantine(tmp_path, vocab):
    from lddl_tpu_torch.loader import get_bert_pretrain_data_loader
    d = str(tmp_path / "binned")
    _make_shards(d, n_shards=2, bins=[0, 1, 2])
    for i in range(2):   # all of bin 1
        _truncate(os.path.join(d, "shard-{}.parquet_1".format(i)), 4)
    with pytest.warns(UserWarning):
        with pytest.raises(ValueError, match="quarantined at startup"):
            get_bert_pretrain_data_loader(d, vocab_file=vocab, batch_size=2,
                                          on_corrupt="quarantine")


@pytest.mark.parametrize("how", ["argument", "env"])
def test_loader_quarantine_serves_reference_batches(tmp_path, vocab,
                                                    monkeypatch, how):
    import sys
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import _torch_loader_shards as shards
    src = str(tmp_path / "src")
    _make_shards(src)
    d = str(tmp_path / "shards")
    shutil.copytree(src, d)
    _truncate(os.path.join(d, "shard-2.parquet"), 100)
    kw = dict(vocab_file=vocab, batch_size=2)
    with pytest.raises(integrity.ShardIntegrityError, match="shard-2"):
        shards.port_loader(d, **kw)
    if how == "argument":
        kw["on_corrupt"] = "quarantine"
    else:
        monkeypatch.setenv("LDDL_TPU_ON_CORRUPT", "quarantine")
    with pytest.warns(UserWarning, match="shard-2"):
        port = shards.port_loader(d, **kw)
    assert len(port.dataset) == 9   # 3 survivors x 3 samples
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = shards.ref_loader(d, **kw)
    shards.assert_same_batches(port, ref)


def test_truncate_fault_surfaces_at_parquet_read(tmp_path):
    path = str(tmp_path / "t.parquet")
    rio.write_table_atomic(pa.table({"x": [1, 2]}), path)
    faults.arm("read:truncate:nth=1")
    with pytest.raises(ValueError, match="truncated parquet read"):
        rio.read_table(path, retries=False)
    faults.arm("read:truncate:nth=1")
    with pytest.raises(ValueError, match="injected truncated parquet"):
        rio.read_shard_bytes(path)


@pytest.mark.parametrize("spec,error", [
    ("read", "needs at least"),
    ("read:melt:nth=1", "unknown fault kind"),
    ("read:eio", "exactly one of"),
    ("read:eio:nth=1:bogus=2", "unknown option"),
])
def test_fault_spec_errors_match_reference(spec, error):
    from lddl_tpu.resilience import faults as ref
    with pytest.raises(faults.FaultSpecError, match=error):
        faults._parse(spec)
    with pytest.raises(ref.FaultSpecError):
        ref._parse(spec)


def test_retries_give_up_with_a_named_error(tmp_path, monkeypatch):
    monkeypatch.setenv("LDDL_TPU_RETRY_ATTEMPTS", "3")
    path = str(tmp_path / "x.bin")
    rio.atomic_write(path, b"payload")
    faults.arm("read:eio:p=1.0")
    with pytest.raises(OSError, match="failed after 3 attempt"):
        rio.read_bytes(path)
    faults.disarm()
    assert rio.read_bytes(path) == b"payload"
    assert rio.read_json(str(tmp_path / "absent.json")) == (None, "missing")


# ------------------------------------------- the census through resilient I/O


def _census_pkg(name):
    """The census's modules of one package: (fs, faults, io, backend,
    observability)."""
    from importlib import import_module
    return tuple(import_module(name + "." + m) for m in (
        "utils.fs", "resilience.faults", "resilience.io",
        "resilience.backend", "observability"))


PACKAGES = ["lddl_tpu", "lddl_tpu_torch"]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_census_truncate_fault_names_the_shard(tmp_path, pkg):
    """An injected ``read:truncate`` at the census is the named
    ValueError a torn footer gives, in both packages (a chaos run must
    not pass on the port where it fails on the reference)."""
    fs, flt, io_, _, _ = _census_pkg(pkg)
    path = str(tmp_path / "part.0.parquet")
    io_.write_table_atomic(pa.table({"x": [1, 2, 3]}), path)
    flt.arm("read:truncate:nth=1")
    try:
        with pytest.raises(ValueError, match=r"corrupt or truncated parquet "
                                             r"shard .*part\.0\.parquet"):
            fs.get_num_samples_of_parquet(path)
    finally:
        flt.disarm()
    assert fs.get_num_samples_of_parquet(path) == 3


@pytest.mark.parametrize("pkg", PACKAGES)
def test_census_open_fault_is_retried(tmp_path, monkeypatch, pkg):
    """An ``open:eio`` at the census fires once and is retried: the count
    is right AND the retry counter shows the retry."""
    fs, flt, io_, _, obs = _census_pkg(pkg)
    path = str(tmp_path / "part.0.parquet")
    io_.write_table_atomic(pa.table({"x": [1, 2, 3]}), path)
    monkeypatch.setenv("LDDL_TPU_METRICS_DIR", str(tmp_path / "metrics"))
    obs.registry().reset()
    flt.arm("open:eio:nth=1")
    try:
        assert fs.get_num_samples_of_parquet(path) == 3
    finally:
        flt.disarm()
    retries = obs.registry().counter("resilience_retry_attempts_total")
    assert retries.value(op="parquet") == 1


@pytest.mark.parametrize("pkg", PACKAGES)
def test_census_is_ranged_only_on_the_mock_store(tmp_path, monkeypatch, pkg):
    """On the mock object store the census reads the footer by two ranged
    gets (the 8-byte tail probe, then the footer) and never fetches a
    whole object."""
    fs, _, _, storage, _ = _census_pkg(pkg)
    monkeypatch.setenv(storage.ENV_VAR, "mock")
    bk = storage.get_backend()
    sink = pa.BufferOutputStream()
    import pyarrow.parquet as pq
    pq.write_table(pa.table({"A": ["r{}".format(i) for i in range(37)]}),
                   sink)
    path = str(tmp_path / "census.parquet")
    bk.put_atomic(path, sink.getvalue().to_pybytes())

    def no_full_fetch(p):
        raise AssertionError("census fetched full shard bytes")

    ranged = []
    real_get = bk.get

    def ranged_only(p, start=None, length=None):
        assert start is not None and length is not None, \
            "census made a whole-object get"
        ranged.append((start, length))
        return real_get(p, start=start, length=length)

    monkeypatch.setattr(bk, "get_versioned", no_full_fetch)
    monkeypatch.setattr(bk, "get", ranged_only)
    assert fs.get_num_samples_of_parquet(path) == 37
    assert len(ranged) == 2 and ranged[0][1] == 8
