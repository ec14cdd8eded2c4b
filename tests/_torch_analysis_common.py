"""One fixture, both analyzers: the helpers of the port's analyzer tests.

The port's tests (``tests/test_torch_{analysis,dataflow,
concurrency_rules}.py``) are written in the port's terms: fixture paths
under ``lddl_tpu_torch/`` and module names ``lddl_tpu_torch.*``. Every
fixture also goes to ``lddl_tpu``'s analyzer with each path and name
mapped to its reference counterpart (``ref_path``, ``ref_text``), and
the two results must agree finding for finding (rule, path, line,
message, snippet, with the names mapped) before the port's result is
handed back to the test's own assertions.

``analysis`` below stands in for the port's ``lddl_tpu_torch.analysis``
module in those tests: ``analyze_source`` and ``run_check`` over a
fixture tree run both analyzers and compare; a ``run_check`` without a
``root`` (the real tree) runs the port alone; everything else is the
port's own attribute.
"""

import json
import os
import re
import shutil

from lddl_tpu import analysis as REF
from lddl_tpu_torch import analysis as PORT

_MIRROR = ".ref_tree"   # the reference's copy of a fixture tree


def ref_path(path):
    """The reference's counterpart of a port path: the port's top-level
    ``testing.py`` is ``lddl_tpu/models/testing.py``; its ``tools/`` and
    ``benchmarks/`` sit at the reference's repo root."""
    if path == "lddl_tpu_torch/testing.py":
        return "lddl_tpu/models/testing.py"
    for sub in ("tools/", "benchmarks/"):
        if path.startswith("lddl_tpu_torch/" + sub):
            return path[len("lddl_tpu_torch/"):]
    if path == "lddl_tpu_torch":
        return "lddl_tpu"
    if path.startswith("lddl_tpu_torch/"):
        return "lddl_tpu/" + path[len("lddl_tpu_torch/"):]
    return path


def ref_text(text):
    """Source text or a message with every port path and module name
    replaced by the reference's."""
    text = text.replace("lddl_tpu_torch/testing.py",
                        "lddl_tpu/models/testing.py")
    text = re.sub(r"\blddl_tpu_torch\.testing\b", "lddl_tpu.models.testing",
                  text)
    text = re.sub(r"\blddl_tpu_torch([./])(tools|benchmarks)\1", r"\2\1",
                  text)
    return re.sub(r"\blddl_tpu_torch\b", "lddl_tpu", text)


def _key(f, mapped):
    if not mapped:
        return (f.rule, f.path, f.line, f.message, f.snippet)
    return (f.rule, ref_path(f.path), f.line, ref_text(f.message),
            ref_text(f.snippet))


def assert_same(port_findings, ref_findings):
    """The two analyzers' findings agree, names mapped."""
    got = sorted(_key(f, True) for f in port_findings)
    want = sorted(_key(f, False) for f in ref_findings)
    assert got == want, "port vs reference findings differ:\n{}\n{}".format(
        got, want)


class RuleSel(list):
    """A rule-id filter, resolved in each package by ``get_rules``."""


def _rules_of(pkg, rules):
    if rules is None:
        return None
    if isinstance(rules, RuleSel):
        return pkg.get_rules(list(rules))
    return pkg.get_rules([r.id for r in rules])


def _mirror(root):
    """Write the reference's copy of every file under ``root`` (paths and
    text mapped) to ``root/.ref_tree``, afresh."""
    dst_root = os.path.join(root, _MIRROR)
    shutil.rmtree(dst_root, ignore_errors=True)
    for dirpath, dirnames, names in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames if d != _MIRROR)
        for n in sorted(names):
            if not n.endswith(".py"):
                continue
            src = os.path.join(dirpath, n)
            rel = os.path.relpath(src, root).replace(os.sep, "/")
            dst = os.path.join(dst_root, ref_path(rel))
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            with open(src, encoding="utf-8") as f:
                text = f.read()
            with open(dst, "w", encoding="utf-8") as f:
                f.write(ref_text(text))
    return dst_root


def _ref_baseline(baseline_path, root):
    if not baseline_path or not os.path.isfile(baseline_path):
        return baseline_path
    entries = PORT.load_baseline(baseline_path)
    for e in entries:
        e["path"] = ref_path(e.get("path", ""))
        e["match"] = ref_text(e.get("match", ""))
    out = os.path.join(root, _MIRROR, "baseline.ref.json")
    with open(out, "w", encoding="utf-8") as f:
        json.dump({"entries": entries}, f)
    return out


def _ref_arg(path, root):
    if os.path.isabs(path):
        path = os.path.relpath(path, root).replace(os.sep, "/")
    return ref_path(path)


def ref_cache_path(cache_path):
    """Where the reference's side of a fixture run keeps its cache."""
    return cache_path + ".ref"


class _Both(object):
    """Stands in for ``lddl_tpu_torch.analysis`` in the port's tests."""

    def __getattr__(self, name):
        return getattr(PORT, name)

    @staticmethod
    def get_rules(names=None):
        if names is None:
            return None
        REF.get_rules(names)  # both raise on an unknown id
        PORT.get_rules(names)
        return RuleSel(names)

    @staticmethod
    def analyze_source(source, path, rules=None):
        found, supp = PORT.analyze_source(source, path,
                                          _rules_of(PORT, rules))
        rfound, rsupp = REF.analyze_source(ref_text(source), ref_path(path),
                                           _rules_of(REF, rules))
        assert_same(found, rfound)
        assert_same(supp, rsupp)
        return found, supp

    @staticmethod
    def run_check(paths, rules=None, baseline_path=None, root=None,
                  cache_path=None, report_paths=None):
        report = PORT.run_check(paths, rules=_rules_of(PORT, rules),
                                baseline_path=baseline_path, root=root,
                                cache_path=cache_path,
                                report_paths=report_paths)
        if root is None:
            return report   # the real tree: the port's analyzer alone
        ref_root = _mirror(root)
        ref_paths = [_ref_arg(p, root) for p in paths]
        for sub in ("tools", "benchmarks"):
            # The port's tools/ and benchmarks/ sit at the reference's root.
            if "lddl_tpu_torch" in paths \
                    and os.path.isdir(os.path.join(ref_root, sub)):
                ref_paths.append(sub)
        ref = REF.run_check(
            ref_paths, rules=_rules_of(REF, rules),
            baseline_path=_ref_baseline(baseline_path, root),
            root=ref_root,
            cache_path=ref_cache_path(cache_path) if cache_path else None,
            report_paths=(None if report_paths is None
                          else [ref_path(p) for p in report_paths]))
        for part in ("new", "baselined", "suppressed"):
            assert_same(getattr(report, part), getattr(ref, part))
        assert [(ref_path(p), ref_text(m)) for p, m in report.errors] == \
            [(p, m) for p, m in ref.errors]
        assert (report.files, report.files_cached) == \
            (ref.files, ref.files_cached)
        return report


analysis = _Both()
