"""The port's loader telemetry (lddl_tpu_torch.observability): the
attribution verdict and shares equal lddl_tpu's function on the same
stage seconds; a real loader under a known consumer step partitions the
observed wall; process workers export their stage seconds per pid; the
device prefetcher's h2d/prefetch stages; and telemetry on or off gives
the same batch bytes as lddl_tpu's loader."""

import json
import os
import sys
import time

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import _torch_loader_shards as shards  # noqa: E402

from lddl_tpu_torch import observability as obs  # noqa: E402
from lddl_tpu_torch.observability import attribution  # noqa: E402

STAGE_CASES = [
    {"batch_wait": 8.0, "step_gap": 2.0, "shard_read": 3.0, "decode": 1.0},
    {"batch_wait": 1.0, "step_gap": 9.0},
    {"batch_wait": 3.0, "step_gap": 7.0},
    {"batch_wait": 4.0, "step_gap": 6.0, "collate": 1.0},
    {"batch_wait": 1.5, "step_gap": 8.5, "ipc": 0.2},
    {"prefetch_wait": 5.0, "prefetch_gap": 5.0, "batch_wait": 99.0,
     "step_gap": 1.0, "h2d": 2.0},
    {"prefetch_wait": 0.0, "prefetch_gap": 0.0, "batch_wait": 2.0,
     "step_gap": 3.0, "shard_fetch": 1.0, "shard_read": 0.5},
    {},
    {"decode": 1.0},
    {"batch_wait": "x", "step_gap": 1.0},
]


@pytest.fixture
def telemetry(monkeypatch, tmp_path):
    d = str(tmp_path / "metrics")
    monkeypatch.setenv("LDDL_TPU_METRICS_DIR", d)
    obs.registry().reset()
    yield d
    obs.registry().reset()


@pytest.mark.parametrize("stages", STAGE_CASES)
def test_verdict_and_shares_equal_reference(stages):
    from lddl_tpu.observability import attribution as ref
    got = attribution.from_stage_seconds(stages)
    assert got == ref.from_stage_seconds(stages)
    assert attribution.format_report(got) == ref.format_report(got)
    if got is not None:
        assert sum(got["shares"].values()) == pytest.approx(1.0)
    assert (attribution.INPUT_BOUND_SHARE,
            attribution.COMPUTE_BOUND_SHARE) == (0.40, 0.15)
    assert attribution.STAGES == ref.STAGES


def test_registry_and_tracing(telemetry):
    reg = obs.registry()
    obs.inc("c_total", 2, stage="a")
    obs.inc("c_total", -5, stage="a")   # clamps
    obs.set_gauge("g", 0.5)
    obs.observe("h_seconds", 0.25)
    obs.observe("h_seconds", 1.0)
    assert reg.counter("c_total").value(stage="a") == 2
    assert reg.gauge("g").value() == 0.5
    st = reg.histogram("h_seconds").stats()
    assert (st["count"], st["sum"], st["min"], st["max"]) == (2, 1.25,
                                                              0.25, 1.0)
    with pytest.raises(TypeError):
        reg.gauge("c_total")
    with obs.span("unit.span", k=1):
        obs.event("unit.event")
    with open(obs.flush()) as f:
        names = [json.loads(line)["name"] for line in f]
    assert "unit.span" in names and "unit.event" in names
    with open(obs.export_jsonl()) as f:
        line = json.loads(f.read().splitlines()[-1])
    assert line["metrics"]["c_total"]["values"] == {"stage=a": 2}


def test_disabled_telemetry_is_inert(monkeypatch):
    monkeypatch.delenv("LDDL_TPU_METRICS_DIR", raising=False)
    obs.registry().reset()
    obs.inc("x_total")
    with obs.span("s"):
        pass
    assert obs.registry().names() == [] and not obs.enabled()
    assert attribution.snapshot() is None


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("attribution"))
    corpus, vocab = shards.build_corpus(root)
    return {"vocab": vocab,
            "dyn": shards.ref_shards(corpus, vocab,
                                     os.path.join(root, "dyn"), 4),
            "bin": shards.ref_shards(corpus, vocab,
                                     os.path.join(root, "bin"), 2,
                                     bin_size=32, masking=True)}


def _kw(built, **extra):
    kw = dict(vocab_file=built["vocab"], batch_size=4, base_seed=5,
              num_workers=2)
    kw.update(extra)
    return kw


def test_known_step_sleep_partitions_the_wall(telemetry, built):
    # Unbinned: each bin of a Binned loader has its own loader boundary,
    # whose step_gap also covers the other bins' batches.
    loader = shards.port_loader(built["dyn"], **_kw(built))
    step_s = 0.01
    t0 = time.perf_counter()
    n = 0
    for _ in loader:
        time.sleep(step_s)
        n += 1
    wall = time.perf_counter() - t0
    rep = loader.attribution_snapshot()
    assert rep["boundary"] == "loader"
    assert sum(rep["shares"].values()) == pytest.approx(1.0)
    assert n * step_s * 0.9 <= rep["wall_seconds"] <= wall + 0.001
    stages = rep["stages_seconds"]
    assert stages["step_gap"] >= n * step_s * 0.9
    for stage in ("shard_read", "decode", "collate"):
        assert stages.get(stage, 0.0) > 0.0, (stage, stages)
    assert rep == attribution.from_stage_seconds(
        attribution.stage_seconds())
    snap = obs.registry().snapshot()
    assert attribution.VERDICT_GAUGE in snap
    assert snap["loader_padding_efficiency"]["values"][""] > 0


def test_prefetcher_stages_and_process_worker_exports(telemetry, built):
    """Through prefetch_to_device (CPU tensors) with process workers: the
    prefetch boundary is the outermost, h2d and ipc are timed here, and
    each worker exports its own collate seconds under its pid."""
    from lddl_tpu_torch.loader import prefetch_to_device
    loader = shards.port_loader(built["bin"], **_kw(
        built, worker_mode="process"))
    try:
        n = 0
        for batch in prefetch_to_device(loader, device="cpu"):
            time.sleep(0.005)
            n += 1
        pids = {str(p.pid) for dl in loader._dataloaders for p in dl._procs}
    finally:
        loader.shutdown_workers()   # workers exit and write their exports
    rep = attribution.from_stage_seconds(attribution.stage_seconds())
    assert rep["boundary"] == "prefetch"
    for stage in ("h2d", "ipc", "prefetch_wait", "prefetch_gap"):
        assert rep["stages_seconds"].get(stage, 0.0) > 0.0, stage
    assert obs.registry().counter(
        "loader_prefetch_batches_total").value() == n
    exported = {}
    for name in os.listdir(telemetry):
        # The final export also writes the Prometheus textfile
        # (metrics-*.prom) beside the JSONL snapshots read here.
        if name.startswith("metrics-") and name.endswith(".jsonl") \
                and name.split("pid")[1].split(".")[0] in pids:
            with open(os.path.join(telemetry, name)) as f:
                last = json.loads(f.read().splitlines()[-1])
            exported[name] = last["metrics"].get(
                attribution.STAGE_METRIC, {}).get("values", {})
    assert exported and all(v.get("stage=collate", 0) > 0
                            for v in exported.values()), exported


@pytest.mark.parametrize("worker_mode", ["thread", "process"])
def test_telemetry_is_byte_inert(built, tmp_path, monkeypatch, worker_mode):
    want = shards.digest(shards.ref_loader(built["bin"], **_kw(built)))
    for armed in (False, True):
        if armed:
            monkeypatch.setenv("LDDL_TPU_METRICS_DIR", str(tmp_path / "m"))
        else:
            monkeypatch.delenv("LDDL_TPU_METRICS_DIR", raising=False)
        loader = shards.port_loader(built["bin"], **_kw(
            built, worker_mode=worker_mode))
        try:
            assert shards.digest(loader) == want, armed
        finally:
            loader.shutdown_workers()
    obs.registry().reset()
