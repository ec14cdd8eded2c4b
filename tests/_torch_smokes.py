"""Shared by the smoke tests: run one of the port's CI smokes
(``python -m lddl_tpu_torch.tools.<name>_smoke``) at a small corpus and
read its one-line JSON report."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Each smoke's corpus at most this many MiB here, through its own variable.
SMOKE_MB = "0.25"


def run_smoke(name, var, **env):
    """(exit code, the report of the last stdout line or None, stderr)."""
    full = dict(os.environ, PYTHONPATH=ROOT, **{var: SMOKE_MB}, **env)
    proc = subprocess.run(
        [sys.executable, "-m", "lddl_tpu_torch.tools.{}_smoke".format(name)],
        cwd=ROOT, env=full, capture_output=True, text=True, timeout=600)
    lines = proc.stdout.strip().splitlines()
    try:
        report = json.loads(lines[-1]) if lines else None
    except ValueError:
        report = None
    return proc.returncode, report, proc.stderr[-4000:]


def flip_byte(path, at=None):
    """Flip one byte of ``path`` in place (the middle one by default)."""
    with open(path, "r+b") as f:
        data = f.read()
        at = len(data) // 2 if at is None else at
        f.seek(at)
        f.write(bytes([data[at] ^ 0xFF]))
