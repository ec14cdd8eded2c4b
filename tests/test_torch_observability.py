"""The port's exporters, stage spans and telemetry inertness against
lddl_tpu's (counterparts of the exporter, stage-span, trace-summary,
inertness and padding-efficiency tests of ``tests/test_observability.py``):

- the same recorded metrics give the same registry snapshot, the same
  Prometheus text (``export_prom``), the same JSONL line and the same
  ``summary()`` in both packages; exports fail inertly; the periodic
  exporter and ``configure``/``disable`` behave as the reference's;
- one SIGTERM handler chain: the registry's end-of-process export and
  ``install_signal_flush`` flush once, chain a Python handler, and die
  by the signal under ``SIG_DFL``;
- the stage files open the reference's top-level stage spans
  (``lddl_tpu.analysis.rules.STAGE_SPANS``), held by a plain AST walk
  (the port has no analyzer yet);
- a telemetry-armed port preprocess -> balance -> load is byte-equal to
  a live telemetry-off ``lddl_tpu`` run, and its static preprocess and
  balance counters equal a live telemetry-armed ``lddl_tpu`` run's for
  the same corpus and plan;
- the padding-efficiency gauge equals the reference loader's on the same
  shards, and binned loading beats unbinned.

Each side runs in its own metrics directory (both registries would
export into the same ``metrics-rank<r>-pid<p>`` names otherwise).
"""

import ast
import importlib
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_fleet_common as fc  # noqa: E402

REF, PORT = fc.REF, fc.PORT
obs, tracing, exporters = PORT.obs, PORT.tracing, PORT.exporters


@pytest.fixture(autouse=True)
def clean_telemetry():
    fc.reset_both()
    yield
    fc.reset_both()


def _record_sample_metrics(pkg):
    o = pkg.obs
    o.inc("loader_real_tokens_total", 90)
    o.inc("loader_padded_slots_total", 100)
    o.inc("resilience_retry_attempts_total", 2, op="read")
    o.inc("req_total")
    o.inc("req_total", 2, stage="a")
    o.inc("req_total", -7)  # counters are monotonic: clamped to 0
    o.set_gauge("fill", 0.5)
    o.set_gauge("fill", 0.25, worker=1)
    for v in (0.001, 0.002, 0.004, 3.0, 0.0, 0.004):
        o.observe("loader_batch_latency_seconds", v)
    o.observe("lat_by_op", 0.5, op="get", backend="local")
    pkg.attribution.stage_counter().inc(0.3, stage="decode")
    pkg.attribution.stage_counter().inc(0.9, stage="step_gap")
    pkg.attribution.stage_counter().inc(0.1, stage="batch_wait")


# ------------------------------------------------------------ registry


def test_disabled_helpers_record_nothing():
    for pkg in (REF, PORT):
        assert not pkg.obs.enabled()
        pkg.obs.inc("x_total", 5)
        pkg.obs.set_gauge("g", 1.0)
        pkg.obs.observe("h", 2.0)
        assert pkg.obs.registry().names() == []


def test_disabled_span_is_shared_noop():
    s1 = obs.span("a")
    s2 = obs.span("b", k=1)
    assert s1 is s2  # a shared singleton: no per-call allocation
    with s1:
        pass
    obs.event("e")
    assert tracing.pending_events() == 0 == REF.tracing.pending_events()


def test_counter_gauge_histogram_snapshots_equal(tmp_path):
    snaps = {}
    for pkg in (REF, PORT):
        pkg.obs.configure(dir=str(tmp_path / pkg.pkg))
        _record_sample_metrics(pkg)
        snaps[pkg.pkg] = pkg.obs.registry().snapshot()
        fc.reset_both()
    assert snaps["lddl_tpu_torch"] == snaps["lddl_tpu"]
    snap = snaps["lddl_tpu_torch"]
    assert snap["req_total"]["values"] == {"": 1, "stage=a": 2}
    assert snap["fill"]["values"] == {"": 0.5, "worker=1": 0.25}
    h = snap["loader_batch_latency_seconds"]["values"][""]
    assert h["count"] == 6 and h["min"] == 0.0 and h["max"] == 3.0
    assert h["buckets"]["le_0"] == 1
    with pytest.raises(TypeError):
        obs.registry().counter("g_total")
        obs.registry().gauge("g_total")


# ----------------------------------------------------------- exporters


def test_prom_jsonl_and_summary_exports_equal_reference(tmp_path):
    out = {}
    for pkg in (REF, PORT):
        d = str(tmp_path / pkg.pkg)
        pkg.obs.configure(dir=d, rank=0)
        _record_sample_metrics(pkg)
        with open(pkg.obs.export_prom()) as f:
            prom = f.read()
        with open(pkg.obs.export_jsonl()) as f:
            line = json.loads(f.read().splitlines()[-1])
        summary = pkg.obs.summary()
        with open(pkg.obs.write_summary()) as f:
            written = json.load(f)
        out[pkg.pkg] = (prom, line["metrics"], line["rank"], summary,
                        written)
        assert os.path.basename(pkg.exporters.export_jsonl()) == \
            "metrics-rank0-pid{}.jsonl".format(os.getpid())
        pkg.obs.disable()
        fc.reset_both()
    assert out["lddl_tpu_torch"] == out["lddl_tpu"]
    prom, metrics, _, summary, written = out["lddl_tpu_torch"]
    assert "# TYPE loader_real_tokens_total counter" in prom
    assert "loader_real_tokens_total 90" in prom
    assert 'resilience_retry_attempts_total{op="read"} 2' in prom
    assert 'loader_batch_latency_seconds_bucket{le="+Inf"} 6' in prom
    assert "loader_batch_latency_seconds_count 6" in prom
    assert metrics["loader_real_tokens_total"]["values"][""] == 90
    assert summary["padding_efficiency"] == pytest.approx(0.9)
    assert summary["retries"] == 2
    assert summary["loader_attribution"]["verdict"] == "compute-bound"
    assert written["real_tokens"] == 90


def test_export_failure_is_inert(tmp_path):
    target = tmp_path / "file"
    target.write_text("not a dir")
    os.environ["LDDL_TPU_METRICS_DIR"] = str(target / "sub")
    for pkg in (REF, PORT):
        pkg.obs.inc("x_total")
        with pkg.obs.span("s"):
            pass
        assert pkg.obs.export_prom() is None
        assert pkg.obs.export_jsonl() is None
        assert pkg.obs.write_summary() is None


def test_configure_disable_and_periodic_export(tmp_path):
    d = str(tmp_path / "m")
    os.environ["LDDL_TPU_METRICS_INTERVAL_S"] = "0.05"
    assert exporters.configure(dir=d, rank=3, periodic=True) == d
    assert obs.metrics_dir() == d and obs.rank() == 3
    obs.inc("tick_total", 4)
    with obs.span("stage.tick"):
        pass
    jsonl = os.path.join(d, "metrics-rank3-pid{}.jsonl".format(
        os.getpid()))
    deadline = time.monotonic() + 20.0
    while time.monotonic() < deadline and not os.path.exists(jsonl):
        time.sleep(0.02)
    assert exporters._exporter["thread"].is_alive()
    exporters.disable()
    assert not obs.enabled() and exporters._exporter["thread"] is None
    with open(jsonl) as f:
        line = json.loads(f.read().splitlines()[-1])
    assert line["rank"] == 3
    assert line["metrics"]["tick_total"]["values"][""] == 4
    assert os.path.exists(os.path.join(d, "metrics-rank3-pid{}.prom".format(
        os.getpid())))
    assert os.path.exists(tracing.trace_path() or os.path.join(
        d, "trace-rank3-pid{}.jsonl".format(os.getpid())))


_CHAIN_PROBE = """
import os, signal, sys, time
def prior(signum, frame):
    print("PRIOR", flush=True)
    signal.signal(signal.SIGTERM, signal.SIG_DFL)
    os.kill(os.getpid(), signal.SIGTERM)
if sys.argv[2] == "chain":
    signal.signal(signal.SIGTERM, prior)
os.environ["LDDL_TPU_METRICS_DIR"] = sys.argv[1]
import lddl_tpu_torch.observability as obs
obs.inc("before_term_total", 3)   # arms the end-of-process export
obs.install_signal_flush()        # idempotent: still one handler
print("READY", flush=True)
time.sleep(120)
"""


@pytest.mark.parametrize("mode", ["chain", "default"])
def test_one_sigterm_handler_chain(tmp_path, mode):
    """The registry's end-of-process export and ``install_signal_flush``
    install ONE SIGTERM handler: it exports the registry, then calls a
    prior Python handler ("chain") or dies by the re-raised signal under
    ``SIG_DFL`` ("default")."""
    d = str(tmp_path / "m")
    proc = subprocess.Popen([sys.executable, "-c", _CHAIN_PROBE, d, mode],
                            env=fc.subprocess_env(), cwd=fc.REPO_ROOT,
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        assert proc.stdout.readline().strip() == "READY"
        proc.send_signal(signal.SIGTERM)
        out = proc.communicate(timeout=60)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
    assert proc.returncode == -signal.SIGTERM, out
    assert ("PRIOR" in out) == (mode == "chain"), out
    jsonl = os.path.join(d, "metrics-rank0-pid{}.jsonl".format(proc.pid))
    with open(jsonl) as f:
        lines = f.read().splitlines()
    assert len(lines) == 1  # flushed once, not once per handler
    assert json.loads(lines[0])["metrics"]["before_term_total"][
        "values"][""] == 3
    assert os.path.exists(jsonl[:-len(".jsonl")] + ".prom")


# ------------------------------------------------- stage spans (AST walk)


def _spans_opened(source, path):
    """Names of every ``with <x>.span("<name>", ...)`` in a source."""
    names = set()
    for node in ast.walk(ast.parse(source, path)):
        if not isinstance(node, (ast.With, ast.AsyncWith)):
            continue
        for item in node.items:
            call = item.context_expr
            if (isinstance(call, ast.Call)
                    and getattr(call.func, "attr",
                                getattr(call.func, "id", None)) == "span"
                    and call.args and isinstance(call.args[0], ast.Constant)):
                names.add(call.args[0].value)
    return names


def test_every_stage_entry_point_opens_a_top_level_span():
    """The port's stage files open the reference's stage spans: the set
    is ``lddl_tpu.analysis.rules.STAGE_SPANS`` (pinned as
    ``tests/test_observability.py`` pins it), mapped onto
    ``lddl_tpu_torch/``. The walk still fails a stage file that loses
    its span."""
    from lddl_tpu.analysis.rules import STAGE_SPANS
    assert set(STAGE_SPANS.items()) == {
        ("lddl_tpu/preprocess/runner.py", ("preprocess.run",)),
        ("lddl_tpu/preprocess/steal.py", ("preprocess.gather",
                                          "preprocess.finalize")),
        ("lddl_tpu/balance/balancer.py", ("balance.run",)),
        ("lddl_tpu/loader/dataloader.py", ("loader.epoch",)),
        ("lddl_tpu/ingest/incremental.py", ("ingest.run",)),
    }
    missing = {}
    for ref_path, names in STAGE_SPANS.items():
        path = os.path.join(fc.REPO_ROOT, "lddl_tpu_torch",
                            ref_path.split("/", 1)[1])
        with open(path) as f:
            opened = _spans_opened(f.read(), path)
        lost = set(names) - opened
        if lost:
            missing[path] = sorted(lost)
    assert not missing, missing
    assert _spans_opened("def balance_shards(a, b):\n    return None\n",
                         "balancer.py") == set()


# ------------------------------------------------------ trace_summary


def test_trace_summary_tool_equals_reference(tmp_path, capsys):
    d = str(tmp_path / "m")
    obs.configure(dir=d)
    with obs.span("preprocess.run"):
        with obs.span("preprocess.scatter"):
            pass
    with obs.span("loader.epoch"):
        pass
    obs.event("resilience.retry", op="read")
    obs.flush()
    texts, collected = [], []
    for tool in (fc.ref_tool("trace_summary"),
                 fc.port_tool("trace_summary")):
        collected.append(tool.collect(tool.resolve_paths([d])))
        assert tool.main([d]) == 0
        texts.append(capsys.readouterr().out)
    assert collected[0] == collected[1] and texts[0] == texts[1]
    ts = fc.port_tool("trace_summary")
    spans, instants = collected[1]
    assert spans["preprocess.run"]["count"] == 1
    assert spans["preprocess.scatter"]["total_us"] <= \
        spans["preprocess.run"]["total_us"]
    assert instants["resilience.retry"] == 1
    stages = ts.rollup_stages(spans)
    assert set(stages) == {"preprocess", "loader"}
    assert "per-stage wall time:" in texts[1]


# ------------------------------------------ inertness and the counters


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The reference test's demo corpus recipe (48 documents, Philox seed
    23, 3 files) and its WordPiece vocab."""
    from lddl_tpu.preprocess import build_wordpiece_vocab
    root = tmp_path_factory.mktemp("tobs_corpus")
    source = root / "corpus" / "source"
    source.mkdir(parents=True)
    words = ("alpha beta gamma delta epsilon zeta eta theta iota kappa "
             "lambda mu nu xi omicron pi rho sigma tau upsilon").split()
    g = np.random.Generator(np.random.Philox(key=[0, 23]))
    docs = []
    for d in range(48):
        sents = []
        for _ in range(int(g.integers(2, 8))):
            n = int(g.integers(4, 12))
            sents.append(" ".join(
                words[int(g.integers(0, len(words)))] for _ in range(n)
            ).capitalize() + ".")
        docs.append("doc-{} {}".format(d, " ".join(sents)))
    for shard in range(3):
        with open(source / "{}.txt".format(shard), "w") as f:
            for line in docs[shard::3]:
                f.write(line + "\n")
    vocab = build_wordpiece_vocab([" ".join(words)] * 3,
                                  str(root / "vocab.txt"), vocab_size=300)
    return {"root": root, "corpus": str(root / "corpus"), "vocab": vocab}


def _run_pipeline(pkg, corpus, out_root, bin_size=None):
    """One package's preprocess -> balance of the corpus (the reference
    tokenizes natively: the port's engine)."""
    pre_mod = importlib.import_module(pkg + ".preprocess")
    bal_mod = importlib.import_module(pkg + ".balance")
    pre = os.path.join(str(out_root), "pre")
    bal = os.path.join(str(out_root), "bal")
    cfg = dict(max_seq_length=64, duplicate_factor=2, masking=True)
    if pkg == "lddl_tpu":
        cfg["tokenizer_engine"] = "native"
    pre_mod.run_bert_preprocess(
        {"wiki": corpus["corpus"]}, pre,
        pre_mod.get_tokenizer(vocab_file=corpus["vocab"]),
        config=pre_mod.BertPretrainConfig(**cfg),
        num_blocks=4, sample_ratio=1.0, seed=0, bin_size=bin_size)
    bal_mod.balance_shards(pre, bal, 4)
    return pre, bal


def _first_batches(pkg, path, vocab, n=6, base_seed=11, fixed=None):
    """First ``n`` batches of one fully drained epoch."""
    loader_mod = importlib.import_module(pkg + ".loader")
    kw = dict(vocab_file=vocab, batch_size=16, num_workers=1,
              shuffle_buffer_size=64, shuffle_buffer_warmup_factor=4,
              base_seed=base_seed)
    if fixed is not None:
        kw["fixed_seq_lengths"] = fixed
    if pkg == "lddl_tpu":
        kw["log_level"] = 50
    out = []
    for i, batch in enumerate(loader_mod.get_bert_pretrain_data_loader(
            path, **kw)):
        if i < n:
            out.append({k: np.asarray(v).copy() for k, v in batch.items()})
    return out


@pytest.fixture(scope="module")
def binned_ref_off(corpus, tmp_path_factory):
    """A telemetry-off live lddl_tpu run, binned by 16."""
    fc.reset_both()
    return _run_pipeline("lddl_tpu", corpus,
                         tmp_path_factory.mktemp("binned_ref_off"),
                         bin_size=16)


@pytest.fixture(scope="module")
def unbinned_ref_off(corpus, tmp_path_factory):
    fc.reset_both()
    return _run_pipeline("lddl_tpu", corpus,
                         tmp_path_factory.mktemp("unbinned_ref_off"))


def _tree_bytes(d):
    out = {}
    for name in sorted(os.listdir(d)):
        p = os.path.join(d, name)
        if os.path.isfile(p):
            with open(p, "rb") as f:
                out[name] = f.read()
    return out


def test_pipeline_bytes_identical_with_observability_on(
        corpus, binned_ref_off, tmp_path):
    """A telemetry-armed port preprocess -> balance -> load is byte-equal
    to a telemetry-off lddl_tpu run (shards, caches, manifests, the first
    batches), and the armed run recorded its stage telemetry."""
    pre_off, bal_off = binned_ref_off
    batches_off = _first_batches("lddl_tpu", bal_off, corpus["vocab"])
    obs.configure(dir=str(tmp_path / "metrics"))
    pre_on, bal_on = _run_pipeline("lddl_tpu_torch", corpus,
                                   tmp_path / "on", bin_size=16)
    batches_on = _first_batches("lddl_tpu_torch", bal_on, corpus["vocab"])
    snap = obs.registry().snapshot()
    trace = obs.flush()
    obs.disable()
    for d_off, d_on in ((pre_off, pre_on), (bal_off, bal_on)):
        assert _tree_bytes(d_on) == _tree_bytes(d_off)
    assert len(batches_on) == len(batches_off) > 0
    for a, b in zip(batches_on, batches_off):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert sum(snap["preprocess_samples_total"]["values"].values()) > 0
    assert sum(snap["loader_batches_total"]["values"].values()) > 0
    assert snap["loader_padding_efficiency"]["values"][""] > 0
    with open(trace) as f:
        names = [json.loads(line)["name"] for line in f]
    for required in ("preprocess.run", "preprocess.scatter",
                     "preprocess.scatter_block", "preprocess.gather",
                     "preprocess.gather_group", "balance.run",
                     "balance.bin", "loader.epoch"):
        assert required in names, "missing span {}".format(required)


# Counters and histograms of the static stages that are functions of the
# corpus and plan (seconds-valued ones and the sink's queue high-water
# are timing and stay out).
_TIMING = ("preprocess_sink_stall_seconds_total",
           "preprocess_sink_write_seconds_total",
           "preprocess_sink_queue_depth",
           "native_thread_busy_seconds_total",
           "preprocess_samples_per_second", "preprocess_docs_per_second")


def _stage_metrics(snap):
    out = {}
    for name, data in snap.items():
        if not name.startswith(("preprocess_", "balance_", "native_")) \
                or name in _TIMING:
            continue
        if data["type"] == "histogram":
            out[name] = {k: (v["count"], v["sum"], v["buckets"])
                         for k, v in data["values"].items()}
        else:
            out[name] = data["values"]
    return out


@pytest.mark.parametrize("bin_size", [None, 16], ids=["unbinned", "binned"])
def test_static_stage_counters_equal_reference(corpus, tmp_path, bin_size):
    """The static preprocess's and balancer's counters, gauges and
    histograms (docs, doc bytes, tokens, samples and shards per bin,
    bucket sizes, native threads, samples moved, bytes rewritten) equal a
    live telemetry-armed lddl_tpu run's for the same corpus and plan."""
    metrics = {}
    for pkg in (REF, PORT):
        pkg.obs.configure(dir=str(tmp_path / pkg.pkg / "metrics"))
        _run_pipeline(pkg.pkg, corpus, tmp_path / pkg.pkg,
                      bin_size=bin_size)
        metrics[pkg.pkg] = _stage_metrics(pkg.obs.registry().snapshot())
        pkg.obs.disable()
        fc.reset_both()
    assert metrics["lddl_tpu_torch"] == metrics["lddl_tpu"]
    got = metrics["lddl_tpu_torch"]
    for name in ("preprocess_docs_total", "preprocess_doc_bytes_total",
                 "preprocess_tokens_total", "preprocess_samples_total",
                 "preprocess_shards_total", "preprocess_bucket_samples",
                 "balance_samples_moved_total",
                 "balance_bytes_rewritten_total", "native_threads"):
        assert name in got, (name, sorted(got))
    assert got["preprocess_docs_total"][""] == 48


def test_packed_fill_counters_equal_reference(corpus, tmp_path):
    """The offline packer's fill counters and gauge equal the
    reference's for the same corpus and plan."""
    metrics = {}
    for pkg in (REF, PORT):
        pre_mod = importlib.import_module(pkg.pkg + ".preprocess")
        pkg.obs.configure(dir=str(tmp_path / pkg.pkg / "metrics"))
        cfg = dict(max_seq_length=64, duplicate_factor=2, masking=True)
        if pkg is REF:
            cfg["tokenizer_engine"] = "native"
        pre_mod.run_bert_preprocess(
            {"wiki": corpus["corpus"]}, str(tmp_path / pkg.pkg / "pre"),
            pre_mod.get_tokenizer(vocab_file=corpus["vocab"]),
            config=pre_mod.BertPretrainConfig(**cfg), num_blocks=4,
            sample_ratio=1.0, seed=0, pack_seq_length=64)
        snap = pkg.obs.registry().snapshot()
        metrics[pkg.pkg] = {k: snap[k]["values"] for k in (
            "preprocess_pack_tokens_total",
            "preprocess_pack_slot_tokens_total",
            "preprocess_pack_rows_total", "preprocess_pack_fill_ratio")}
        pkg.obs.disable()
        fc.reset_both()
    assert metrics["lddl_tpu_torch"] == metrics["lddl_tpu"]
    assert 0 < metrics["lddl_tpu_torch"]["preprocess_pack_fill_ratio"][
        ""] <= 1


def test_padding_efficiency_reproduces_bin_gap(corpus, binned_ref_off,
                                               unbinned_ref_off, tmp_path):
    """The padding-efficiency gauge of the port's loader equals the
    reference loader's on the same shards, and binned loading wastes
    fewer padded slots than unbinned."""

    def efficiency(pkg, bal, fixed):
        pkg.obs.configure(dir=str(tmp_path / pkg.pkg / "metrics"))
        _first_batches(pkg.pkg, bal, corpus["vocab"], fixed=fixed)
        eff = pkg.obs.registry().gauge("loader_padding_efficiency").value()
        pkg.obs.disable()
        fc.reset_both()
        return eff

    effs = {}
    for pkg in (REF, PORT):
        effs[pkg.pkg] = (efficiency(pkg, unbinned_ref_off[1], [64]),
                         efficiency(pkg, binned_ref_off[1],
                                    [16, 32, 48, 64]))
    assert effs["lddl_tpu_torch"] == effs["lddl_tpu"]
    eff_unbinned, eff_binned = effs["lddl_tpu_torch"]
    assert eff_binned > eff_unbinned


def test_registry_thread_safety(tmp_path):
    obs.configure(dir=str(tmp_path))
    c = obs.registry().counter("n_total")

    def worker():
        for _ in range(10000):
            c.inc()

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert c.value() == 80000
