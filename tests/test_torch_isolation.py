"""The port stands alone: no module of lddl_tpu_torch (nor the chip_*.py
scripts at the root) imports JAX, flax, optax, orbax, transformers,
lddl_tpu or the root bench.py, importing the package loads no JAX and no
HF package (``tokenizers`` is imported only lazily, by
``native/gen_tables.py`` when the tables are regenerated by hand), the
preprocess workers, the downloaders (CLIs and spawned sharding workers),
the analyzer, the loader's process workers and a one-host preprocess or
balance CLI run import no torch, and entry points refuse to fall back to the CPU when CUDA is asked
for (explicitly or by default) and absent."""

import ast
import os
import re
import subprocess
import sys

import pytest

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# ``bench`` is the reference's root benchmark script (its corpus maker is
# copied into ``lddl_tpu_torch.testing``).
FORBIDDEN = ("jax", "flax", "optax", "orbax", "lddl_tpu", "transformers",
             "bench")


def _port_sources():
    paths = [os.path.join(ROOT, n) for n in sorted(os.listdir(ROOT))
             if n.startswith("chip_") and n.endswith(".py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "lddl_tpu_torch")):
        paths.extend(os.path.join(dirpath, n) for n in sorted(names)
                     if n.endswith(".py"))
    return sorted(paths)


def _forbidden(module):
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def test_no_forbidden_imports():
    sources = _port_sources()
    assert len(sources) > 10
    bad = []
    for path in sources:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            elif (isinstance(node, ast.Call)
                  and getattr(node.func, "attr", getattr(node.func, "id",
                                                         None))
                  in ("import_module", "__import__") and node.args
                  and isinstance(node.args[0], ast.Constant)):
                mods = [str(node.args[0].value)]
            else:
                continue
            bad.extend("{}:{} {}".format(os.path.relpath(path, ROOT),
                                         node.lineno, m)
                       for m in mods if _forbidden(m))
    assert not bad, bad
    # The prefix check itself: the port's own name is not forbidden.
    assert not _forbidden("lddl_tpu_torch.ops")
    assert _forbidden("lddl_tpu.ops") and _forbidden("jax.numpy")
    assert _forbidden("bench") and not _forbidden("benchmarks")


def test_import_leaves_jax_unloaded():
    code = ("import sys, lddl_tpu_torch, lddl_tpu_torch.loader, "
            "lddl_tpu_torch.models, lddl_tpu_torch.models.convert, "
            "lddl_tpu_torch.models.checkpoint, lddl_tpu_torch.ops.packing, "
            "lddl_tpu_torch.preprocess.packing, lddl_tpu_torch.utils.io, "
            "lddl_tpu_torch.ops.flash_attention, lddl_tpu_torch.testing, "
            "lddl_tpu_torch.parallel, lddl_tpu_torch.parallel.testing, "
            "lddl_tpu_torch.loader.sharding, lddl_tpu_torch.models.sharding, "
            "lddl_tpu_torch.ops.ring_attention, lddl_tpu_torch.entry, "
            "lddl_tpu_torch.preprocess, lddl_tpu_torch.preprocess.runner, "
            "lddl_tpu_torch.native, lddl_tpu_torch.native.build, "
            "lddl_tpu_torch.native.gen_tables, lddl_tpu_torch.ops.masking, "
            "lddl_tpu_torch.balance, lddl_tpu_torch.resilience.integrity, "
            "lddl_tpu_torch.cli.preprocess_bert_pretrain, "
            "lddl_tpu_torch.cli.balance_shards, "
            "lddl_tpu_torch.cli.generate_num_samples_cache, "
            "lddl_tpu_torch.observability, lddl_tpu_torch.resilience.io, "
            "lddl_tpu_torch.resilience.backend, "
            "lddl_tpu_torch.resilience.faults, "
            "lddl_tpu_torch.loader.qserde, lddl_tpu_torch.loader.shardcache, "
            "lddl_tpu_torch.preprocess.bart, lddl_tpu_torch.ingest, "
            "lddl_tpu_torch.ingest.journal, "
            "lddl_tpu_torch.ingest.incremental, "
            "lddl_tpu_torch.balance.delta, "
            "lddl_tpu_torch.cli.preprocess_bart_pretrain, "
            "lddl_tpu_torch.cli.ingest_watch, lddl_tpu_torch.cli.common, "
            "lddl_tpu_torch.preprocess.steal, "
            "lddl_tpu_torch.resilience.leases, "
            "lddl_tpu_torch.observability.exporters, "
            "lddl_tpu_torch.observability.series, "
            "lddl_tpu_torch.observability.fleet, "
            "lddl_tpu_torch.observability.alerts, "
            "lddl_tpu_torch.observability.autoscale, "
            "lddl_tpu_torch.tools, lddl_tpu_torch.tools.pipeline_status, "
            "lddl_tpu_torch.tools.trace_summary, "
            "lddl_tpu_torch.tools.lddl_check, lddl_tpu_torch.download, "
            "lddl_tpu_torch.tools.mock_train, "
            "lddl_tpu_torch.tools.validate_seqlen, "
            "lddl_tpu_torch.download.utils, "
            "lddl_tpu_torch.download.wikipedia, "
            "lddl_tpu_torch.download.books, "
            "lddl_tpu_torch.download.openwebtext, "
            "lddl_tpu_torch.download.common_crawl, "
            "lddl_tpu_torch.analysis, lddl_tpu_torch.analysis.core, "
            "lddl_tpu_torch.analysis.project, lddl_tpu_torch.analysis.rules, "
            "lddl_tpu_torch.analysis.dataflow, "
            "lddl_tpu_torch.analysis.flow_rules, "
            "lddl_tpu_torch.analysis.concurrency, "
            "lddl_tpu_torch.analysis.sarif; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'optax', 'orbax', 'lddl_tpu', 'transformers', "
            "'tokenizers')); "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_preprocess_workers_import_no_torch():
    """What a spawned preprocess worker imports (the runner, to unpickle
    its BERT or BART processor and vocab table, the BERT, BART or ingest
    CLI module as its main, and, in an elastic pool, the unit tasks of
    ``steal`` with the ``leases`` they fence on, all reporting into the
    fleet telemetry) loads no torch, no JAX and no HF package: a
    numpy-engine worker pays no torch import. Neither do an ingest
    helper host (the ingest service, the balancers and the world-of-one
    communicator it runs the preprocess on) and the status tools, which
    an operator runs beside the fleet."""
    code = ("import sys, lddl_tpu_torch.preprocess.runner, "
            "lddl_tpu_torch.cli.preprocess_bert_pretrain, pickle, "
            "lddl_tpu_torch.preprocess.bart, "
            "lddl_tpu_torch.cli.preprocess_bart_pretrain, "
            "lddl_tpu_torch.cli.ingest_watch, "
            "lddl_tpu_torch.preprocess.steal, "
            "lddl_tpu_torch.resilience.leases, "
            "lddl_tpu_torch.observability.fleet, "
            "lddl_tpu_torch.observability.series, "
            "lddl_tpu_torch.observability.alerts, "
            "lddl_tpu_torch.observability.autoscale, "
            "lddl_tpu_torch.tools.pipeline_status, "
            "lddl_tpu_torch.tools.trace_summary, lddl_tpu_torch.ingest, "
            "lddl_tpu_torch.balance, lddl_tpu_torch.resilience.integrity; "
            "from lddl_tpu_torch.utils.comm import LocalCommunicator; "
            "LocalCommunicator().allreduce_sum([1]); "
            "from lddl_tpu_torch.preprocess import get_tokenizer; "
            "from lddl_tpu_torch.preprocess.runner import "
            "BertBucketProcessor, BertPretrainConfig; "
            "from lddl_tpu_torch.preprocess.steal import ("
            "_pool_scatter_slice, _pool_gather_group, _pool_block_bucket); "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'lddl_tpu', 'transformers', 'tokenizers')); "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_download_workers_and_analyzer_import_no_torch(tmp_path):
    """The downloaders are CPU stages: a CLI process, and each spawned
    sharding worker (which imports its CLI module and the parse function
    it unpickles), loads no torch, no JAX and no HF package; nor does
    the analyzer, its CLI (a full run over the port's tree, rules and
    all) or the status tool that reads its SARIF. A real pool of 2
    spawned workers reports what it imported."""
    code = ("import sys, concurrent.futures, multiprocessing, "
            "lddl_tpu_torch.download.wikipedia, "
            "lddl_tpu_torch.download.books, "
            "lddl_tpu_torch.download.openwebtext, "
            "lddl_tpu_torch.download.common_crawl, "
            "lddl_tpu_torch.tools.pipeline_status; "
            "from lddl_tpu_torch.download.utils import shard_files_parallel; "
            "from lddl_tpu_torch.download.books import parse_book_file; "
            "from lddl_tpu_torch.tools import lddl_check; "
            "assert lddl_check.main(['--no-cache', '--json']) == 0; "
            "d = sys.argv[1]; "
            "open(d + '/b.txt', 'w').write('a book'); "
            "assert shard_files_parallel([d + '/b.txt'] * 2, d, 2, "
            "parse_book_file, num_processes=2) == 2; "
            "probe = ('__import__(\"lddl_tpu_torch.download.books\") and "
            "sorted(m for m in __import__(\"sys\").modules if "
            "m.split(\".\")[0] in (\"torch\", \"jax\", \"lddl_tpu\", "
            "\"transformers\", \"tokenizers\"))'); "
            "ctx = multiprocessing.get_context('spawn'); "
            "pool = concurrent.futures.ProcessPoolExecutor(2, mp_context=ctx); "
            "workers = [pool.submit(eval, probe).result() for _ in range(2)]; "
            "pool.shutdown(); "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'lddl_tpu', 'transformers', 'tokenizers')); "
            "print(bad, workers); "
            "sys.exit(1 if bad or any(workers) else 0)")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "[] [[], []]" in proc.stdout


def test_loader_worker_modules_import_no_torch():
    """What a spawned process-mode loader worker imports (the loader
    modules, to unpickle its dataset, decode and collate, and run its
    stream; the telemetry and resilience layers they report into) loads
    no torch, no JAX and no HF package."""
    code = ("import sys, pickle, lddl_tpu_torch.loader, "
            "lddl_tpu_torch.loader.datasets, lddl_tpu_torch.loader.bert, "
            "lddl_tpu_torch.loader.bart, lddl_tpu_torch.loader.qserde, "
            "lddl_tpu_torch.loader.shardcache, "
            "lddl_tpu_torch.loader.dataloader, "
            "lddl_tpu_torch.observability, lddl_tpu_torch.resilience.io, "
            "lddl_tpu_torch.resilience.faults, "
            "lddl_tpu_torch.resilience.integrity, "
            "lddl_tpu_torch.utils.logging, lddl_tpu_torch.utils.cpus; "
            "from lddl_tpu_torch.loader.dataloader import "
            "_persistent_worker_main; "
            "lddl_tpu_torch.utils.cpus.loader_io_threads(); "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'lddl_tpu', 'transformers', 'tokenizers')); "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_one_host_clis_import_no_torch(tmp_path):
    """A one-host preprocess CLI run (elastic, fleet-armed) and a balance
    CLI run load no torch, so they never map the CUDA driver: only
    ``--multihost`` needs torch's process group."""
    code = ("import runpy, sys; "
            "sys.argv = [sys.argv[1]] + sys.argv[2:]; "
            "runpy.run_module(sys.argv[0], run_name='__main__'); "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'lddl_tpu')); "
            "print(bad); sys.exit(1 if bad else 0)")
    prep = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from lddl_tpu_torch.testing import make_corpus; "
            "from lddl_tpu_torch.preprocess import build_wordpiece_vocab; "
            "make_corpus(sys.argv[2], 0.02); "
            "build_wordpiece_vocab([l.split(None, 1)[1] for l in "
            "open(sys.argv[2] + '/source/0.txt')], sys.argv[3], "
            "vocab_size=500)")
    env = dict(os.environ, PYTHONPATH=ROOT)
    corpus, vocab = str(tmp_path / "corpus"), str(tmp_path / "vocab.txt")
    subprocess.run([sys.executable, "-c", prep, ROOT, corpus, vocab],
                   check=True, env=env, timeout=120)
    pre, bal = str(tmp_path / "pre"), str(tmp_path / "bal")
    for argv in (["lddl_tpu_torch.cli.preprocess_bert_pretrain",
                  "--wikipedia", corpus, "--sink", pre, "--vocab-file",
                  vocab, "--masking", "--num-blocks",
                  "4", "--local-workers", "1", "--elastic",
                  "--elastic-host-id", "h0", "--fleet-telemetry"],
                 ["lddl_tpu_torch.cli.balance_shards", "--indir", pre,
                  "--outdir", bal, "--num-shards", "2"]):
        proc = subprocess.run([sys.executable, "-c", code] + argv, cwd=ROOT,
                              env=env, capture_output=True, text=True,
                              timeout=300)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert proc.stdout.strip().endswith("[]"), proc.stdout


def test_entry_points_refuse_cpu_fallback(monkeypatch):
    from lddl_tpu_torch import resolve_device
    from lddl_tpu_torch.loader import prefetch_to_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        prefetch_to_device([])
    assert resolve_device("cpu") == torch.device("cpu")
    assert len(prefetch_to_device([], device="cpu")) == 0


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take():
    """The wrappers run the plain version only on CPU tensors; any other
    device must pass the kernels' operand checks (run before any launch)
    or raise. Meta tensors stand in for a device here: they carry a
    device, dtype and shape but no data."""
    from lddl_tpu_torch.ops import flash_attention as fa
    m = torch.ones((2, 256), dtype=torch.int32)
    rows = [torch.zeros((4, 256))] * 2
    cpu = torch.zeros((4, 256, 64), dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="CUDA tensors"):
        fa._check_cuda([cpu] * 3, [m, m], [])
    with pytest.raises(TypeError, match="CUDA tensors"):
        fa.onekv_fwd(*[cpu.to("meta")] * 3, m.to("meta"), m.to("meta"),
                     0.125)
    # The operand checks themselves (device-independent).
    assert fa._check_operands([cpu] * 4, [m, m], rows) == 2
    # fp32 operands have builds of their own; other dtypes and a
    # bf16/fp32 mix raise.
    assert fa._check_operands([cpu.float()] * 3, [m, m], []) == 2
    with pytest.raises(TypeError):
        fa._check_operands([cpu.half()] * 3, [m, m], [])
    with pytest.raises(TypeError):
        fa._check_operands([cpu, cpu.float(), cpu], [m, m], [])
    with pytest.raises(TypeError):
        fa._check_operands([cpu] * 3, [m.long(), m], [])
    with pytest.raises(TypeError):
        fa._check_operands([cpu] * 3, [m, m], [rows[0].double()])
    with pytest.raises(ValueError, match="shape"):
        fa._check_operands([cpu, cpu[:2]], [m, m], [])
    with pytest.raises(ValueError, match="shape"):
        fa._check_operands([cpu] * 3, [m[:, :128], m], [])
    with pytest.raises(ValueError, match="head_dim"):
        fa._check_operands([cpu[:, :, :32].contiguous()] * 3, [m, m], [])
    with pytest.raises(ValueError, match="contiguous"):
        t = torch.zeros((256, 4, 64), dtype=torch.bfloat16).transpose(0, 1)
        fa._check_operands([t] * 3, [m, m], [])
    with pytest.raises(ValueError, match="single-block"):
        big = torch.zeros((4, 1024, 64), dtype=torch.bfloat16)
        fa._check_operands([big] * 3, [torch.ones((2, 1024),
                                                  dtype=torch.int32)] * 2,
                           [])
    with pytest.raises(ValueError, match="multiple"):
        fa._check_operands([cpu] * 3, [torch.ones((3, 256),
                                                  dtype=torch.int32)] * 2,
                           [])


def test_online_wrappers_refuse_what_the_kernels_do_not_take():
    """The online kernels take any L_pad that is a multiple of 128 (the
    single-block bound does not apply to them) and refuse the rest; their
    wrappers, like the single-block ones, run the plain version only on
    CPU tensors."""
    from lddl_tpu_torch.ops import flash_attention as fa
    m = torch.ones((2, 1024), dtype=torch.int32)
    rows = [torch.zeros((4, 1024))] * 2
    big = torch.zeros((4, 1024, 64), dtype=torch.bfloat16)
    assert fa._check_operands([big] * 4, [m, m], rows, online=True) == 2
    short = torch.zeros((4, 256, 128), dtype=torch.bfloat16)
    m256 = torch.ones((2, 256), dtype=torch.int32)
    assert fa._check_operands([short] * 3, [m256] * 2, [], online=True) == 2
    with pytest.raises(ValueError, match="head_dim"):
        fa._check_operands([big[:, :, :32].contiguous()] * 3, [m, m], [],
                           online=True)
    with pytest.raises(ValueError, match="multiple of 128"):
        odd = torch.zeros((4, 1000, 64), dtype=torch.bfloat16)
        fa._check_operands([odd] * 3, [torch.ones((2, 1000),
                                                  dtype=torch.int32)] * 2,
                           [], online=True)
    q, mm = big.to("meta"), m.to("meta")
    r = torch.zeros((4, 1024), device="meta")
    for call in (lambda: fa.online_fwd(q, q, q, mm, mm, 0.125),
                 lambda: fa.online_bwd_dq(q, q, q, mm, mm, q, r, r, 0.125),
                 lambda: fa.online_bwd_dkv(q, q, q, mm, mm, q, r, r, 0.125)):
        with pytest.raises(TypeError, match="CUDA tensors"):
            call()


def test_recipe_runs_the_port_alone():
    """The port's recipe runs only the port: no ``lddl_tpu.`` module (the
    port's own ``lddl_tpu_torch.`` aside), no script of ``benchmarks/``,
    no root ``bench``; its inline Python imports nothing forbidden."""
    path = os.path.join(ROOT, "lddl_tpu_torch", "examples",
                        "local_example.sh")
    with open(path) as f:
        text = f.read()
    assert "python -m lddl_tpu_torch.tools.mock_train" in text
    bad = [ln for ln in text.splitlines()
           if re.search(r"\blddl_tpu\.|\blddl_tpu\b(?!_torch)", ln)
           or "benchmarks/" in ln
           or re.search(r"\bimport\b.*\bbench\b|\bbench\.", ln)]
    assert not bad, bad
    snippets = re.findall(r"<<'PY'\n(.*?)\nPY\n", text, re.S)
    assert len(snippets) == 3
    for code in snippets:
        for node in ast.walk(ast.parse(code)):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            assert not [m for m in mods if _forbidden(m)], mods


def test_model_less_harness_maps_no_cuda_driver(tmp_path):
    """``mock_train`` without ``--with-model`` imports no torch, so it
    never maps the CUDA driver (nor JAX, nor the reference), and
    ``validate_seqlen`` reads its dumps likewise."""
    from lddl_tpu_torch import testing
    tokens = testing.write_vocab(str(tmp_path / "vocab.txt"), 256, seed=1)
    testing.write_balanced_shards(str(tmp_path / "bal"), tokens,
                                  num_bins=2, bin_size=32, shards_per_bin=2,
                                  samples_per_shard=16, seed=1)
    code = ("import runpy, sys; "
            "sys.argv = [sys.argv[1]] + sys.argv[2:]; "
            "runpy.run_module(sys.argv[0], run_name='__main__'); "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'lddl_tpu', 'benchmarks', 'bench')); "
            "maps = open('/proc/self/maps').read(); "
            "bad += [n for n in ('libcuda.so', 'libtorch') if n in maps]; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=ROOT)
    lens = str(tmp_path / "lens")
    for argv in (["lddl_tpu_torch.tools.mock_train", "--path",
                  str(tmp_path / "bal"), "--vocab-file",
                  str(tmp_path / "vocab.txt"), "--batch-size", "4",
                  "--epochs", "1", "--fixed-seq-lengths", "32", "64",
                  "--seq-len-dir", lens],
                 ["lddl_tpu_torch.tools.validate_seqlen", "--seq-len-dir",
                  lens, "--bin-size", "32"]):
        proc = subprocess.run([sys.executable, "-c", code] + argv, cwd=ROOT,
                              env=env, capture_output=True, text=True,
                              timeout=300)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert proc.stdout.strip().endswith("[]"), proc.stdout
