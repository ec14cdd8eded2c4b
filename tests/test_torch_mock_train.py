"""The port's loader harness (``lddl_tpu_torch.tools.mock_train``) and
``validate_seqlen`` against the reference's ``benchmarks/mock_train.py``
and ``benchmarks/validate_seqlen.py``, on the same shards, written once by
the port's ``testing`` makers. The reference scripts run as subprocesses
on JAX's CPU platform; the port's model-less harness runs as
``python -m`` (it imports no torch), the model runs in this process.

What must be equal: every printed line in which no clock enters (the
``padded-zero ratio`` line, the per-epoch sample counts, the ``--debug``
lines byte for byte, the refusals), the ``lens_<rank>.npz`` dumps, and
``validate_seqlen``'s verdict lines and exit code, on clean and on
doctored dumps. ``--with-model tiny`` (fp32, dropout 0, flash attention,
as ``test_torch_train.py::test_three_train_steps_match_reference``): from
the reference's initial parameters, the first step's loss on the first
loader batch within ``TOL`` (1e-5 relative, fp32 with another summation
order) of the reference harness's.
"""

import json
import os
import pickle
import re
import subprocess
import sys

import numpy as np
import pytest

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
BINS = ["32", "64", "96", "128"]
TIMED = ("samples/s", "ms/batch", "ms avg")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    from lddl_tpu_torch import testing
    root = tmp_path_factory.mktemp("mock_train_shards")
    vocab = str(root / "vocab.txt")
    tokens = testing.write_vocab(vocab, 512, seed=3)
    testing.write_balanced_shards(str(root / "bal"), tokens, num_bins=4,
                                  bin_size=32, shards_per_bin=2,
                                  samples_per_shard=24, masking=True, seed=3)
    testing.write_unbinned_shards(str(root / "unb"), tokens, num_shards=2,
                                  samples_per_shard=48, max_tokens=128,
                                  seed=4)
    testing.write_packed_shards(str(root / "packed"), tokens,
                                num_samples=96, num_shards=2,
                                pack_seq_length=128, max_tokens=128, seed=5)
    testing.write_bart_shards(str(root / "bart"), 512, num_shards=2,
                              samples_per_shard=16, seed=6, min_tokens=200)
    return {"root": root, "vocab": vocab,
            **{k: str(root / k) for k in ("bal", "unb", "packed", "bart")}}


def _run(cmd, env=None):
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=300,
                          env=dict(os.environ, JAX_PLATFORMS="cpu",
                                   PYTHONPATH=ROOT, **(env or {})))
    return proc.returncode, proc.stdout, proc.stderr


def _ref(args, script="mock_train"):
    return _run([sys.executable,
                 os.path.join(ROOT, "benchmarks", script + ".py")] + args)


def _port(args, tool="mock_train"):
    return _run([sys.executable, "-m", "lddl_tpu_torch.tools." + tool]
                + args)


def _untimed(stdout, seq_len_dir=None):
    """The lines in which no clock enters, the dump's directory masked."""
    lines = [ln for ln in stdout.splitlines()
             if not any(t in ln for t in TIMED)]
    if seq_len_dir:
        lines = [ln.replace(seq_len_dir, "<dir>") for ln in lines]
    return lines


def _epoch_samples(stdout):
    return re.findall(r"^epoch (\d+) sustained: .* \((\d+) samples / ",
                      stdout, re.M)


def _both(args, tmp_path, name):
    """Run the reference and the port on ``args`` (each with a dump dir
    of its own); assert equal untimed lines, per-epoch sample counts and
    exit codes; return (ref dump dir, port dump dir, port stdout)."""
    out = {}
    for who, fn in (("ref", _ref), ("port", _port)):
        d = str(tmp_path / "{}_{}".format(name, who))
        rc, stdout, stderr = fn(args + ["--seq-len-dir", d])
        assert rc == 0, stderr[-3000:]
        out[who] = (d, stdout)
    (rd, rs), (pd, ps) = out["ref"], out["port"]
    assert _untimed(ps, pd) == _untimed(rs, rd)
    assert _epoch_samples(ps) == _epoch_samples(rs) and _epoch_samples(ps)
    assert re.search(r"^padded-zero ratio: ", ps, re.M)
    return rd, pd, ps


def _same_dumps(ref_dir, port_dir, ranks):
    for r in ranks:
        a = np.load(os.path.join(ref_dir, "lens_{}.npz".format(r)))
        b = np.load(os.path.join(port_dir, "lens_{}.npz".format(r)))
        assert sorted(a.files) == sorted(b.files) == [
            "batch_lens", "max_lens", "min_lens"]
        for k in a.files:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)


@pytest.mark.parametrize("case", ["binned", "offline_packed"])
def test_bert_ranks_match_reference(shards, tmp_path, case):
    """(a) Two dp ranks: the same dumps, pad line and sample counts."""
    if case == "binned":
        args = ["--path", shards["bal"], "--fixed-seq-lengths"] + BINS + [
            "--epochs", "2"]
    else:
        args = ["--path", shards["packed"], "--epochs", "1"]
    args += ["--vocab-file", shards["vocab"], "--batch-size", "4",
             "--num-dp-groups", "2", "--log-freq", "5"]
    for rank in (0, 1):
        rd, pd, _ = _both(args + ["--dp-rank", str(rank)], tmp_path, case)
        _same_dumps(rd, pd, [rank])


def test_load_time_packing_matches_reference(shards, tmp_path):
    """(a) The load-time packer: both refuse two dp groups with the same
    message (uneven per-group batch counts), and give the same dumps and
    lines at one."""
    args = ["--path", shards["unb"], "--vocab-file", shards["vocab"],
            "--batch-size", "4", "--pack-seq-length", "128",
            "--pack-rows", "4", "--epochs", "2"]
    two = args + ["--num-dp-groups", "2", "--dp-rank", "1"]
    (rrc, _, rerr), (prc, _, perr) = _ref(two), _port(two)
    assert rrc == prc == 1
    assert perr.strip().splitlines()[-1] == rerr.strip().splitlines()[-1]
    assert "uneven per-group batch counts" in perr
    rd, pd, ps = _both(args, tmp_path, "load_packed")
    _same_dumps(rd, pd, [0])


def test_debug_output_matches_reference(shards):
    """(a) ``--debug``: the raw samples' masked and de-masked lines, byte
    for byte."""
    args = ["--path", shards["bal"], "--vocab-file", shards["vocab"],
            "--batch-size", "4", "--debug"]
    (rrc, rout, rerr), (prc, pout, perr) = _ref(args), _port(args)
    assert rrc == prc == 0, perr[-3000:]
    assert pout == rout
    lines = pout.splitlines()
    for head in ("masked: [CLS] ", "demasked: [CLS] "):
        # 2 samples a batch, 3 batches
        assert sum(ln.startswith(head) for ln in lines) == 6, head


def test_bart_matches_reference(shards, tmp_path):
    """(b) BART at one fixed length: the same dumps, pad line and sample
    counts; the same refusals for ``--debug`` and for two lengths."""
    base = ["--family", "bart", "--path", shards["bart"], "--vocab-file",
            shards["vocab"], "--batch-size", "4"]
    rd, pd, _ = _both(base + ["--fixed-seq-lengths", "128", "--epochs",
                              "1"], tmp_path, "bart")
    _same_dumps(rd, pd, [0])
    for extra in (["--debug"], ["--fixed-seq-lengths", "64", "128"]):
        (rrc, rout, rerr), (prc, pout, perr) = (_ref(base + extra),
                                                _port(base + extra))
        assert rrc == prc == 1
        assert perr.strip().splitlines()[-1] == \
            rerr.strip().splitlines()[-1]
        assert pout == rout == ""


@pytest.fixture(scope="module")
def binned_dumps(shards):
    """The port's dumps of the binned shards at two dp ranks."""
    d = str(shards["root"] / "lens")
    for rank in (0, 1):
        rc, _, err = _port(["--path", shards["bal"], "--vocab-file",
                            shards["vocab"], "--batch-size", "4",
                            "--epochs", "1", "--fixed-seq-lengths"] + BINS
                           + ["--num-dp-groups", "2", "--dp-rank",
                              str(rank), "--seq-len-dir", d])
        assert rc == 0, err[-3000:]
    return d


def _doctor(src, dst, fn):
    os.makedirs(dst)
    for name in sorted(os.listdir(src)):
        rank = int(name[len("lens_"):-len(".npz")])
        d = dict(np.load(os.path.join(src, name)))
        fn(rank, d)
        np.savez(os.path.join(dst, name), **d)


def _mix_bins(rank, d):
    # Two iterations whose samples span more than one bin width.
    d["min_lens"][[1, 4]] = d["max_lens"][[1, 4]] - 40


def _desync(rank, d):
    # Rank 1 pads three iterations to another bin.
    if rank == 1:
        d["batch_lens"][[0, 2, 5]] += 32


@pytest.mark.parametrize("doctor", [None, _mix_bins, _desync],
                         ids=["clean", "mixed_bins", "desynced_ranks"])
def test_validate_seqlen_matches_reference(binned_dumps, tmp_path,
                                          doctor):
    """(c) The verdict lines and exit code on the port's dumps, clean
    (PASS) and doctored to mix bins or to desynchronise the ranks (both
    scripts exit 1 with the same counts)."""
    d = binned_dumps
    if doctor is not None:
        _doctor(d, str(tmp_path / "doctored"), doctor)
        d = str(tmp_path / "doctored")
    args = ["--seq-len-dir", d, "--bin-size", "32"]
    (rrc, rout, rerr), (prc, pout, perr) = (
        _ref(args, "validate_seqlen"), _port(args, "validate_seqlen"))
    assert pout == rout and prc == rrc, (pout, rout, perr)
    if doctor is None:
        assert prc == 0 and pout.splitlines()[-1] == "PASS"
    else:
        # Two iterations on each of two ranks, or three iterations.
        want = 4 if doctor is _mix_bins else 3
        assert prc == 1
        assert pout.splitlines()[-1] == "FAIL: {} violations".format(want)


def test_validate_seqlen_refusals(tmp_path):
    """No dumps: both scripts refuse with the same message. Plots without
    matplotlib: the port says so plainly after its verdict."""
    args = ["--seq-len-dir", str(tmp_path), "--bin-size", "32"]
    (rrc, _, rerr), (prc, _, perr) = (_ref(args, "validate_seqlen"),
                                      _port(args, "validate_seqlen"))
    assert rrc == prc == 1
    assert perr.strip().splitlines()[-1] == rerr.strip().splitlines()[-1]
    np.savez(str(tmp_path / "lens_0.npz"), min_lens=np.array([1]),
             max_lens=np.array([2]), batch_lens=np.array([32]))
    code = ("import sys; sys.modules['matplotlib'] = None; "
            "from lddl_tpu_torch.tools import validate_seqlen as v; "
            "v.main(sys.argv[1:])")
    rc, out, err = _run([sys.executable, "-c", code] + args
                        + ["--plots-dir", str(tmp_path / "plots")])
    assert rc == 1 and out.splitlines()[-1].startswith("padding upper")
    assert "needs matplotlib" in err


# The reference harness with fp32 activations, dropout 0 and its initial
# parameters and step losses written out: a wrapper around
# benchmarks/mock_train.py's main().
_REF_WRAPPER = r"""
import json, pickle, runpy, sys
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import lddl_tpu.models as M
out = sys.argv[1]
sys.argv = ["mock_train.py"] + sys.argv[2:]
over = dict(dtype=jnp.float32, hidden_dropout=0.0, attention_dropout=0.0)
for cls in (M.BertConfig, M.BartConfig):
    tiny = cls.tiny
    cls.tiny = staticmethod(lambda _t=tiny, **kw: _t(**{**kw, **over}))
seen = {"losses": []}
create = M.create_train_state
def create_train_state(*a, **kw):
    state, rest = create(*a, **kw)
    seen["params"] = jax.device_get(state.params)
    return state, rest
make = M.make_sharded_train_step
def make_sharded_train_step(*a, **kw):
    fn = make(*a, **kw)
    def step(state, batch, **k):
        state, metrics = fn(state, batch, **k)
        seen["losses"].append(float(metrics["loss"]))
        return state, metrics
    return step
M.create_train_state = create_train_state
M.make_sharded_train_step = make_sharded_train_step
runpy.run_path("benchmarks/mock_train.py", run_name="__main__")
with open(out, "wb") as f:
    pickle.dump(seen, f)
"""


@pytest.mark.parametrize("family", ["bert", "bart"])
def test_first_step_loss_matches_reference(shards, tmp_path, monkeypatch,
                                           capsys, family):
    """(d) ``--with-model tiny --device cpu`` from the reference harness's
    initial parameters (``convert.flax_to_state_dict``): the first step's
    loss on the first loader batch within TOL of the reference's."""
    import lddl_tpu_torch.models as models
    from lddl_tpu_torch.models.convert import flax_to_state_dict
    from lddl_tpu_torch.tools import mock_train

    if family == "bert":
        args = ["--path", shards["bal"], "--fixed-seq-lengths"] + BINS
    else:
        args = ["--family", "bart", "--path", shards["bart"],
                "--fixed-seq-lengths", "128"]
    args += ["--vocab-file", shards["vocab"], "--batch-size", "4",
             "--epochs", "1", "--with-model", "tiny", "--attention-impl",
             "flash"]
    out = str(tmp_path / "ref.pkl")
    # One CPU device: the reference's default mesh (dp over every
    # device) is then the mesh of one device the port's step stands for.
    rc, stdout, err = _run([sys.executable, "-c", _REF_WRAPPER, out] + args,
                           env={"XLA_FLAGS": ""})
    assert rc == 0, err[-3000:]
    with open(out, "rb") as f:
        ref = pickle.load(f)

    over = dict(dtype=torch.float32, hidden_dropout=0.0,
                attention_dropout=0.0)
    for cls in (models.BertConfig, models.BartConfig):
        tiny = cls.tiny
        monkeypatch.setattr(cls, "tiny", staticmethod(
            lambda _t=tiny, **kw: _t(**{**kw, **over})))
    make = models.make_train_step

    def make_train_step(model, optimizer, **kw):
        model.load_state_dict(flax_to_state_dict(ref["params"]))
        return make(model, optimizer, **kw)

    monkeypatch.setattr(models, "make_train_step", make_train_step)
    summary = mock_train.run(mock_train.attach_args().parse_args(
        args + ["--device", "cpu"]))
    printed = capsys.readouterr().out
    assert summary["mesh"] == {"dp": 1}
    assert "train step: " in printed and "on mesh {'dp': 1}" in printed
    assert len(summary["losses"]) == len(ref["losses"]) > 0
    assert np.isfinite(summary["losses"]).all()
    np.testing.assert_allclose(summary["losses"][0], ref["losses"][0],
                               rtol=TOL)
    assert _untimed(printed) == _untimed(stdout)


def test_metrics_dir_writes_summary_and_span(shards, tmp_path):
    """(e) ``--metrics-dir``: a summary holding
    ``mock_train_sustained_samples_per_second`` and a ``mock_train.run``
    span in the trace."""
    m = str(tmp_path / "metrics")
    rc, out, err = _port(["--path", shards["bal"], "--vocab-file",
                          shards["vocab"], "--batch-size", "4", "--epochs",
                          "1", "--metrics-dir", m])
    assert rc == 0, err[-3000:]
    assert "telemetry: wrote " in out
    summaries = [n for n in os.listdir(m) if n.startswith("summary")
                 and n.endswith(".json")]
    assert summaries, os.listdir(m)
    with open(os.path.join(m, summaries[0])) as f:
        text = f.read()
    assert "mock_train_sustained_samples_per_second" in text
    rate = float(re.search(r"^loader sustained: ([0-9.]+) samples/s", out,
                           re.M).group(1))
    gauge = json.loads(text)["metrics"][
        "mock_train_sustained_samples_per_second"]
    assert gauge["type"] == "gauge"
    value = list(gauge["values"].values())[0]
    assert abs(value - rate) <= 0.05 + 1e-4 * rate   # printed to 0.1
    spans = []
    for name in os.listdir(m):
        if "trace" in name:
            with open(os.path.join(m, name)) as f:
                spans += [json.loads(ln) for ln in f if ln.strip()]
    assert any(s.get("name") == "mock_train.run" for s in spans), \
        sorted(os.listdir(m))

