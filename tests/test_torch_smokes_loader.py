"""The port's storage and loader CI smokes on the CPU: ``backend_smoke``
(local against mock store, end to end), ``cache_smoke`` (sync against
prefetch + cache on a latency-injected mock store) and ``status_smoke``
(``pipeline_status``'s diagnosis and exit-code contract), each run at
0.25 MiB through its ``LDDL_TPU_*_SMOKE_MB`` and exiting 0 with
``identical: true`` (the status smoke, which compares no bytes, with its
contract held); each one's gate rejects a perturbed digest or document.
"""

import os
import shutil
import sys

import pytest

from lddl_tpu_torch.tools import cache_smoke, smoke_common, status_smoke

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _torch_smokes import flip_byte, run_smoke  # noqa: E402


@pytest.mark.parametrize("name, var", [
    ("backend", "LDDL_TPU_BACKEND_SMOKE_MB"),
    ("cache", "LDDL_TPU_CACHE_SMOKE_MB"),
    ("status", "LDDL_TPU_STATUS_SMOKE_MB")])
def test_smoke_exits_0(name, var):
    rc, report, err = run_smoke(name, var)
    assert rc == 0, err
    if name == "status":
        assert report["alert_fire_resolve"] is True, report
        assert report["windowed_metrics"] > 0 and report["verdict"]
        return
    assert report["identical"] is True, report
    if name == "backend":
        assert report["loader_identical"] is True
        assert report["samples"]["local"] == report["samples"]["mock"] > 0
        assert report["shards"] > 0
    else:
        assert report["samples"] > 0 and report["shards"] == 8
        assert report["latency_ms"] == 10.0
        assert set(report["wall_s"]) == {"sync", "prefetch_cold",
                                         "prefetch_warm"}


def test_cache_gate_rejects_a_perturbed_leg():
    legs = [(96, "ab", 0.1), (96, "ab", 0.05), (96, "ab", 0.01)]
    assert cache_smoke.identical(legs)
    assert not cache_smoke.identical([legs[0], (96, "ba", 0.05), legs[2]])
    assert not cache_smoke.identical([legs[0], legs[1], (95, "ab", 0.01)])
    assert not cache_smoke.identical([(0, "ab", 0.1), (0, "ab", 0.1)])
    assert not cache_smoke.identical([])


def test_leg_env_sets_and_restores(monkeypatch):
    monkeypatch.setenv("LDDL_TPU_LOADER_CACHE_BYTES", "123")
    monkeypatch.delenv("LDDL_TPU_LOADER_PREFETCH_SHARDS", raising=False)
    with cache_smoke.leg_env(dict(cache_smoke.LEGS)["sync"]):
        assert os.environ["LDDL_TPU_LOADER_PREFETCH_SHARDS"] == "0"
        assert os.environ["LDDL_TPU_LOADER_CACHE_BYTES"] == "0"
    with cache_smoke.leg_env(dict(cache_smoke.LEGS)["prefetch_cold"]):
        assert "LDDL_TPU_LOADER_CACHE_BYTES" not in os.environ
    assert os.environ["LDDL_TPU_LOADER_CACHE_BYTES"] == "123"
    assert "LDDL_TPU_LOADER_PREFETCH_SHARDS" not in os.environ


@pytest.fixture(scope="module")
def mock_tree(tmp_path_factory):
    """A small balanced dataset published through the mock store."""
    from lddl_tpu_torch.resilience import backend
    tmp = str(tmp_path_factory.mktemp("smokemock"))
    saved = os.environ.get("LDDL_TPU_STORAGE_BACKEND")
    os.environ["LDDL_TPU_STORAGE_BACKEND"] = "mock"
    try:
        bal, vocab = cache_smoke.build(tmp, 0.05)
    finally:
        if saved is None:
            os.environ.pop("LDDL_TPU_STORAGE_BACKEND", None)
        else:
            os.environ["LDDL_TPU_STORAGE_BACKEND"] = saved
        backend._instances.pop("mock", None)
    return bal, vocab


def test_published_digest_gate_rejects_a_flipped_byte(mock_tree, tmp_path):
    """The backend smoke's gate reads what a data consumer sees: the
    store's own ``.obj.*`` records do not count, a flipped shard byte
    does."""
    bal, _ = mock_tree
    digests = smoke_common.published_digests(bal)
    assert any(".parquet" in n for n in digests)
    assert not any(n.startswith(".") for n in digests)
    assert any(n.startswith(".obj.") for n in os.listdir(bal))
    copy = str(tmp_path / "copy")
    shutil.copytree(bal, copy)
    for name in os.listdir(copy):
        if name.startswith(".obj."):
            shutil.rmtree(os.path.join(copy, name))
    assert smoke_common.identical(digests,
                                  smoke_common.published_digests(copy))
    shard = sorted(n for n in digests if ".parquet" in n)[0]
    flip_byte(os.path.join(copy, shard))
    assert not smoke_common.identical(digests,
                                      smoke_common.published_digests(copy))


def test_loader_digest_sees_a_changed_sample(mock_tree, tmp_path):
    """The backend and cache smokes' loader digest changes with one
    changed token of one sample."""
    import pyarrow.parquet as pq
    bal, vocab = mock_tree
    n, digest, _ = smoke_common.loader_digest(bal, vocab)
    copy = str(tmp_path / "copy")
    shutil.copytree(bal, copy, ignore=shutil.ignore_patterns(".obj.*",
                                                             ".manifest*"))
    assert smoke_common.loader_digest(copy, vocab)[:2] == (n, digest)
    shard = sorted(x for x in os.listdir(copy) if ".parquet" in x)[0]
    table = pq.read_table(os.path.join(copy, shard))
    ids = table.column("A_ids").to_pylist()
    ids[0][0] = 5 if ids[0][0] != 5 else 6
    import pyarrow as pa
    table = table.set_column(table.schema.get_field_index("A_ids"), "A_ids",
                             pa.array(ids, type=table.schema.field(
                                 "A_ids").type))
    pq.write_table(table, os.path.join(copy, shard))
    got = smoke_common.loader_digest(copy, vocab)
    assert got[0] == n and got[1] != digest


HEALTHY = {"attribution": {"verdict": "balanced", "input_share": 0.2},
           "window": {"rates": {"x": 1.0}}, "health": {"verdicts": []}}


@pytest.mark.parametrize("rc, doc, broken", [
    (0, HEALTHY, None),
    (2, HEALTHY, "healthy run exited 2"),
    (0, dict(HEALTHY, attribution={}), "no attribution verdict"),
    (0, dict(HEALTHY, attribution=None), "no attribution verdict"),
    (0, dict(HEALTHY, window={"rates": {}}), "no series rates"),
    (0, dict(HEALTHY, window=None), "no series rates")])
def test_status_healthy_check(rc, doc, broken):
    got = status_smoke.check_healthy(rc, doc)
    assert (got is None) if broken is None else broken in got


@pytest.mark.parametrize("rc, firing, ok", [
    (2, ["tripped"], True), (0, ["tripped"], False), (2, [], False),
    (2, ["tripped", "other"], False), (1, ["tripped"], False)])
def test_status_tripped_check(rc, firing, ok):
    got = status_smoke.check_tripped(rc, {"alerts": {"firing": firing}})
    assert (got is None) == ok


@pytest.mark.parametrize("rc, kinds, ok", [
    (0, ["alert.resolved"], True), (2, ["alert.resolved"], False),
    (0, [], False), (0, ["alert.fired", "alert.resolved"], False)])
def test_status_resolved_check(rc, kinds, ok):
    doc = {"alerts": {"transitions": [{"kind": k} for k in kinds]}}
    assert (status_smoke.check_resolved(rc, doc) is None) == ok
