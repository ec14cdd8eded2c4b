"""Sanitizer smoke for the native engine: build it under TSan and UBSan
and run the 1-vs-N thread identity suite
(``tests/test_torch_native_threads.py``) against that build, failing on
any sanitizer report.

Run from the repository root::

    python -m lddl_tpu_torch.tools.sanitize_smoke

``lddl_tpu_torch/tools/ci_check.sh`` runs it under
``LDDL_TPU_CI_SMOKE_SANITIZE=1``. Four steps, each in a subprocess so
the instrumented library never loads into this process:

1. build: ``LDDL_TPU_NATIVE_SANITIZE=tsan,ubsan python -m
   lddl_tpu_torch.native.build`` (its own library, apart from the
   normal one);
2. load: the sanitized engine must load under ``LD_PRELOAD=<libtsan>``
   (found with ``g++ -print-file-name=libtsan.so``), so a runtime
   problem fails here and not as a suite that tested nothing;
3. suite: pytest on the identity suite with ``TSAN_OPTIONS=exitcode=66
   halt_on_error=0 log_path=... suppressions=...`` (every report is
   collected into the logs and forces a nonzero exit) and
   ``UBSAN_OPTIONS=halt_on_error=1`` (UBSan aborts on its first report);
   ``native/tsan_suppressions.txt`` silences only uninstrumented
   third-party noise;
4. verdict: fail on a nonzero exit or on any report in the TSan logs.

It prints one JSON line, ``{"smoke": "native sanitize (tsan+ubsan)",
"passed": true, "sanitizer_reports": 0, ...}``, and exits 0 only when it
passed. Where g++ has no libtsan it prints a ``skipped`` line and exits
0.
"""

import glob
import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
MODES = "tsan,ubsan"
SMOKE = "native sanitize (tsan+ubsan)"
SUPPRESSIONS = os.path.join(ROOT, "lddl_tpu_torch", "native",
                            "tsan_suppressions.txt")
SUITE = "tests/test_torch_native_threads.py"


def find_libtsan():
    """The TSan runtime g++ links, or None."""
    try:
        out = subprocess.run(["g++", "-print-file-name=libtsan.so"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    path = out.stdout.strip()
    # Where gcc has no such file it echoes the bare name back.
    if out.returncode == 0 and os.path.isabs(path) and os.path.exists(path):
        return path
    return None


def _failed(step, proc):
    print(json.dumps({"smoke": SMOKE, "passed": False, "failed_step": step,
                      "stderr_tail": proc.stderr[-2000:]}))
    return 1


def main():
    libtsan = find_libtsan()
    if libtsan is None:
        print(json.dumps({"smoke": SMOKE,
                          "skipped": "g++/libtsan unavailable"}))
        return 0
    log_dir = tempfile.mkdtemp(prefix="lddl_torch_sanitize_smoke_")
    try:
        env = dict(os.environ, LDDL_TPU_NATIVE_SANITIZE=MODES,
                   JAX_PLATFORMS="cpu")
        env.pop("LD_PRELOAD", None)
        # 1. The compiler links the runtimes; only loading needs them.
        build = subprocess.run(
            [sys.executable, "-m", "lddl_tpu_torch.native.build"],
            cwd=ROOT, env=env, capture_output=True, text=True)
        if build.returncode != 0:
            return _failed("build", build)
        library = build.stdout.strip().splitlines()[-1]

        env["LD_PRELOAD"] = libtsan
        env["TSAN_OPTIONS"] = (
            "exitcode=66 halt_on_error=0 log_path={} suppressions={}"
            .format(os.path.join(log_dir, "tsan_report"), SUPPRESSIONS))
        env["UBSAN_OPTIONS"] = "halt_on_error=1 print_stacktrace=1"

        # 2. The sanitized engine must be the one under test.
        load = subprocess.run(
            [sys.executable, "-c",
             "from lddl_tpu_torch import native\n"
             "assert native._load()._name == {!r}\n".format(library)],
            cwd=ROOT, env=env, capture_output=True, text=True)
        if load.returncode != 0:
            return _failed("load (the sanitized engine did not load; the "
                           "suite would test nothing)", load)

        # 3. The identity suite against the instrumented engine.
        suite = subprocess.run(
            [sys.executable, "-m", "pytest", SUITE, "-q",
             "-p", "no:cacheprovider"],
            cwd=ROOT, env=env, capture_output=True, text=True)

        # 4. halt_on_error=0 collects every TSan report in one run.
        logs = sorted(glob.glob(os.path.join(log_dir, "tsan_report.*")))
        text = ""
        for path in logs:
            with open(path, encoding="utf-8", errors="replace") as f:
                text += f.read()
        reports = text.count("WARNING: ThreadSanitizer")
        passed = suite.returncode == 0 and reports == 0
        tail = suite.stdout.strip().splitlines()
        result = {"smoke": SMOKE, "passed": passed,
                  "suite_exit": suite.returncode,
                  "suite": tail[-1] if tail else "",
                  "sanitizer_reports": reports,
                  "library": os.path.relpath(library, ROOT),
                  "libtsan": libtsan}
        if not passed:
            result["stdout_tail"] = suite.stdout[-2000:]
            result["stderr_tail"] = suite.stderr[-2000:]
            result["tsan_report_tail"] = text[-4000:]
        print(json.dumps(result))
        return 0 if passed else 1
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
