"""The port stands alone: no module of lddl_tpu_torch (nor chip_smoke.py)
imports JAX, flax, optax, orbax or lddl_tpu, importing the package loads
no JAX, and entry points refuse to fall back to the CPU when CUDA is
asked for (explicitly or by default) and absent."""

import ast
import os
import subprocess
import sys

import pytest

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "flax", "optax", "orbax", "lddl_tpu")


def _port_sources():
    paths = [os.path.join(ROOT, "chip_smoke.py")]
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


def test_import_leaves_jax_unloaded():
    code = ("import sys, lddl_tpu_torch, lddl_tpu_torch.loader, "
            "lddl_tpu_torch.models, lddl_tpu_torch.models.convert, "
            "lddl_tpu_torch.models.checkpoint, lddl_tpu_torch.ops.packing, "
            "lddl_tpu_torch.preprocess.packing, lddl_tpu_torch.utils.io, "
            "lddl_tpu_torch.ops.flash_attention, lddl_tpu_torch.testing, "
            "lddl_tpu_torch.parallel, lddl_tpu_torch.parallel.testing, "
            "lddl_tpu_torch.loader.sharding, lddl_tpu_torch.models.sharding, "
            "lddl_tpu_torch.ops.ring_attention, lddl_tpu_torch.entry; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'optax', 'orbax', 'lddl_tpu')); "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


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
    with pytest.raises(TypeError):
        fa._check_operands([cpu.float()] * 3, [m, m], [])
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
