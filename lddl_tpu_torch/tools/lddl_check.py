"""lddl-check for the port: the determinism / SPMD-safety analyzer over
``lddl_tpu_torch/``.

Counterpart of ``tools/lddl_check.py``. Usage (from the repo root)::

    python -m lddl_tpu_torch.tools.lddl_check              # lddl_tpu_torch
    python -m lddl_tpu_torch.tools.lddl_check --json       # machine-readable
    python -m lddl_tpu_torch.tools.lddl_check --sarif out.sarif
    python -m lddl_tpu_torch.tools.lddl_check --changed-only
        # report only files changed vs git HEAD (the analysis still spans
        # the whole tree); a full report where git is absent
    python -m lddl_tpu_torch.tools.lddl_check --list-rules
    python -m lddl_tpu_torch.tools.lddl_check --write-baseline
        # regenerate the grandfather file (then fill in the "reason"s!)

The baseline is ``lddl_tpu_torch/tools/lddl_check_baseline.json``. The
interprocedural flow rules need the whole-tree project model; per-file
artifacts (AST findings + dataflow summaries) cache by content hash in
``.lddl_tpu_torch_check_cache.json`` at the repo root so warm runs only
re-analyze edited files (``--no-cache`` disables).

Exit status: 0 when every finding is baselined or inline-suppressed,
1 when new findings (or syntax errors) exist, 2 on usage errors.
"""

import argparse
import json
import os
import subprocess
import sys

from .. import analysis

DEFAULT_PATHS = ("lddl_tpu_torch",)


def changed_python_files(root):
    """Repo-relative .py paths changed vs HEAD (staged, unstaged, and
    untracked), for ``--changed-only``. Returns None when git is
    unavailable (callers fall back to a full report)."""
    try:
        # -uall lists files INSIDE untracked directories (plain
        # --porcelain collapses a new package to "?? newdir/", whose
        # entry would fail the .py filter and hide every file in it).
        out = subprocess.run(
            ["git", "status", "--porcelain", "--no-renames",
             "--untracked-files=all"],
            cwd=root, capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if out.returncode != 0:
        return None
    changed = set()
    for line in out.stdout.splitlines():
        path = line[3:].strip()
        if path.endswith(".py"):
            changed.add(path.replace(os.sep, "/"))
    return changed


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="lddl_check",
        description="AST-based determinism & SPMD-safety analyzer")
    parser.add_argument("paths", nargs="*", default=list(DEFAULT_PATHS),
                        help="files or directories (repo-relative); "
                             "default: %(default)s")
    parser.add_argument("--json", action="store_true",
                        help="emit a JSON report instead of text")
    parser.add_argument("--sarif", default=None, metavar="PATH",
                        help="also write a SARIF 2.1.0 report to PATH "
                             "('-' for stdout)")
    parser.add_argument("--changed-only", action="store_true",
                        help="report findings only for files changed vs "
                             "git HEAD (the analysis itself still spans "
                             "all given paths so cross-file flows stay "
                             "sound)")
    parser.add_argument("--no-cache", action="store_true",
                        help="disable the content-hash AST+summary cache")
    parser.add_argument("--baseline",
                        default=os.path.join(analysis.REPO_ROOT,
                                             analysis.DEFAULT_BASELINE),
                        help="baseline file (empty string disables)")
    parser.add_argument("--write-baseline", action="store_true",
                        help="rewrite the baseline from current findings "
                             "(reasons for pre-existing entries are kept)")
    parser.add_argument("--rules", default=None,
                        help="comma-separated rule ids to run (default all)")
    parser.add_argument("--list-rules", action="store_true")
    args = parser.parse_args(argv)

    if args.list_rules:
        for rule in analysis.all_rules():
            print("{:22s} {}".format(rule.id, rule.doc))
        return 0

    try:
        rules = analysis.get_rules(
            [r.strip() for r in args.rules.split(",")] if args.rules
            else None)
    except ValueError as e:
        parser.error(str(e))

    if args.write_baseline and (args.rules or args.changed_only
                                or sorted(args.paths)
                                != sorted(DEFAULT_PATHS)):
        # A filtered run sees only a subset of findings; rewriting the
        # baseline from it would silently drop every grandfathered entry
        # outside the filter.
        parser.error("--write-baseline requires a full run: drop --rules, "
                     "--changed-only, and explicit paths")

    report_paths = None
    if args.changed_only:
        changed = changed_python_files(analysis.REPO_ROOT)
        if changed is not None:
            report_paths = changed
            if not changed:
                print("lddl-check: no changed .py files vs HEAD")
                return 0
        else:
            print("lddl-check: git unavailable; --changed-only falling "
                  "back to a full report", file=sys.stderr)

    cache_path = None if args.no_cache else os.path.join(
        analysis.REPO_ROOT, analysis.DEFAULT_CACHE)
    try:
        report = analysis.run_check(args.paths, rules=rules,
                                    baseline_path=args.baseline or "",
                                    cache_path=cache_path,
                                    report_paths=report_paths)
    except FileNotFoundError as e:
        parser.error(str(e))

    if args.write_baseline:
        old = {(e.get("rule"), e.get("path"), e.get("match")):
               e.get("reason", "") for e in
               analysis.load_baseline(args.baseline)}
        counts = {}
        for f in report.new + report.baselined:
            counts[f.key()] = counts.get(f.key(), 0) + 1
        entries = [
            analysis.baseline_entry(
                next(f for f in report.new + report.baselined
                     if f.key() == key),
                old.get(key, "TODO: justify or fix"), count=n)
            for key, n in counts.items()
        ]
        entries.sort(key=lambda e: (e["path"], e["rule"], e["match"]))
        with open(args.baseline, "w", encoding="utf-8") as fh:
            json.dump({"entries": entries}, fh, indent=2, sort_keys=True)
            fh.write("\n")
        print("wrote {} baseline entr{} to {}".format(
            len(entries), "y" if len(entries) == 1 else "ies",
            args.baseline))
        return 0

    if args.sarif:
        payload = analysis.to_sarif(report, rules)
        if args.sarif == "-":
            json.dump(payload, sys.stdout, indent=2)
            sys.stdout.write("\n")
        else:
            with open(args.sarif, "w", encoding="utf-8") as fh:
                json.dump(payload, fh, indent=2)
                fh.write("\n")

    if args.json:
        json.dump(report.to_dict(), sys.stdout, indent=2)
        sys.stdout.write("\n")
    else:
        for f in report.new:
            print(f.format())
        for path, msg in report.errors:
            print("{}:1: [parse-error] {}".format(path, msg))
        print("lddl-check: {} file(s) ({} cached), {} new finding(s), "
              "{} baselined, {} suppressed in {:.2f}s".format(
                  report.files, report.files_cached, len(report.new),
                  len(report.baselined), len(report.suppressed),
                  report.elapsed_s))
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
