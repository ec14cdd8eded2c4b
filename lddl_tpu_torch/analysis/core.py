"""AST-based static-analysis framework for the pipeline's invariants.

Counterpart of ``lddl_tpu/analysis/core.py`` for the port. The
pipeline's load-bearing guarantees (rank-identical bin choice from the
shared seeded RNG streams in ``utils/rng.py``, byte-identical resume,
atomic-only publish into shard directories) are machine-checked rules
that run over ``lddl_tpu_torch/`` on every test run
(``tests/test_torch_analysis.py``) and from the CLI
(``python -m lddl_tpu_torch.tools.lddl_check``).

Framework pieces:

- :class:`Rule` — an AST visitor with an id, a docstring explaining what it
  protects, optional ``allow`` (fnmatch patterns of repo-relative paths the
  rule never fires on) and ``only`` (patterns it is restricted to).
- registry — rules self-register via :func:`register`; :func:`get_rules`
  resolves an optional name filter.
- suppressions — ``# lddl: disable=<rule>[,<rule>...]`` on the flagged
  line, or on a comment-only line directly above it, silences a finding.
  Every suppression should carry a justification in the surrounding
  comment; they are grep-able so reviewers can audit the full set.
- baseline — a checked-in JSON file of grandfathered findings (each with a
  one-line ``reason``). A finding matches a baseline entry on
  ``(rule, path, stripped source line)`` so entries survive unrelated line
  drift. ``lddl_check`` exits nonzero only on NEW findings.
- output — human-readable ``path:line: [rule] message`` lines or ``--json``
  for machine consumption (the CI test parses it).
"""

import ast
import fnmatch
import hashlib
import json
import os
import re
import time

# Repo root = the directory that holds lddl_tpu_torch/, so finding paths
# read ``lddl_tpu_torch/...``.
REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DEFAULT_BASELINE = os.path.join("lddl_tpu_torch", "tools",
                                "lddl_check_baseline.json")

# Repo-relative default location of the AST+summary cache (content-hash
# keyed; see _Cache). Safe to delete at any time. A name of its own: a
# cache shared with lddl_tpu's analyzer, whose scopes differ, would
# replay the wrong findings.
DEFAULT_CACHE = ".lddl_tpu_torch_check_cache.json"

# Repo-relative SARIF artifact of ``lddl_tpu_torch/tools/ci_check.sh
# --full``, read by ``lddl_tpu_torch.tools.pipeline_status``.
DEFAULT_SARIF = "lddl_tpu_torch_check.sarif"

# Bump to invalidate every cache entry when rule/engine semantics change.
ANALYSIS_VERSION = 1

# The directive may sit anywhere inside a comment ("# why ... lddl:
# disable=x"), but must be after a '#' so string literals never suppress.
_SUPPRESS_RE = re.compile(r"#.*?lddl:\s*disable=([A-Za-z0-9_\-, ]+)")


class Finding(object):
    """One rule violation at one source location."""

    __slots__ = ("rule", "path", "line", "col", "message", "snippet")

    def __init__(self, rule, path, line, col, message, snippet=""):
        self.rule = rule
        self.path = path
        self.line = line
        self.col = col
        self.message = message
        self.snippet = snippet

    def key(self):
        """Baseline identity: stable under unrelated line-number drift."""
        return (self.rule, self.path, self.snippet)

    def to_dict(self):
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "col": self.col, "message": self.message,
                "snippet": self.snippet}

    def format(self):
        return "{}:{}: [{}] {}".format(self.path, self.line, self.rule,
                                       self.message)

    def __repr__(self):
        return "Finding({})".format(self.format())


class Context(object):
    """Everything a rule needs about one source file: the parsed tree, a
    parent map (child AST node -> parent), the raw lines, and an
    import-alias resolver so ``np.random.default_rng`` and
    ``numpy.random.default_rng`` normalize to one dotted name."""

    def __init__(self, path, source, tree):
        self.path = path  # repo-relative, posix separators
        self.source = source
        self.lines = source.splitlines()
        self.tree = tree
        self.parents = {}
        for parent in ast.walk(tree):
            for child in ast.iter_child_nodes(parent):
                self.parents[child] = parent
        self.aliases = _import_aliases(tree)

    def snippet_at(self, lineno):
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    def finding(self, rule_id, node, message):
        line = getattr(node, "lineno", 1)
        col = getattr(node, "col_offset", 0)
        return Finding(rule_id, self.path, line, col, message,
                       self.snippet_at(line))

    def resolve_call(self, node):
        """Normalized dotted name of a Call's callee, or None.

        Only pure ``Name(.Attribute)*`` chains resolve; the head segment is
        mapped through the module's import aliases (``import numpy as np``
        makes ``np.random.seed`` -> ``numpy.random.seed``; ``from datetime
        import datetime`` makes ``datetime.now`` -> ``datetime.datetime.now``).
        """
        return self.resolve_name(node.func)

    def resolve_name(self, node):
        parts = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        parts.append(node.id)
        parts.reverse()
        head = self.aliases.get(parts[0], parts[0])
        return ".".join([head] + parts[1:])

    def ancestors(self, node):
        while node in self.parents:
            node = self.parents[node]
            yield node


def _import_aliases(tree):
    """{local name: canonical dotted module/attr} from top-level-ish
    imports anywhere in the tree (function-local imports included —
    this codebase lazy-imports torch deliberately)."""
    aliases = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                local = a.asname or a.name.split(".")[0]
                aliases[local] = a.name if a.asname else a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom):
            # Relative imports keep just the module path ("..resilience.io"
            # -> "resilience.io"): rules match on suffixes of package-local
            # names, absolute prefixes on external ones.
            mod = (node.module or "").lstrip(".")
            for a in node.names:
                if a.name == "*":
                    continue
                local = a.asname or a.name
                aliases[local] = "{}.{}".format(mod, a.name) if mod else a.name
    return aliases


class Rule(object):
    """Base class: subclasses set ``id``, ``doc`` (what the rule protects,
    one line — surfaced by ``lddl_check --list-rules`` and the SARIF
    table) and implement :meth:`run` yielding Findings."""

    id = None
    doc = ""
    # fnmatch patterns (repo-relative posix paths) the rule never fires on.
    allow = ()
    # If set, the rule only runs on files matching one of these patterns.
    only = None
    # "file" rules run per file via :meth:`run`; "project" rules are fed
    # by the whole-tree dataflow engine (see flow_rules.py) and use
    # allow/only purely as finding-path filters.
    scope = "file"

    def applies_to(self, path):
        if self.only is not None and not _match_any(path, self.only):
            return False
        return not _match_any(path, self.allow)

    def run(self, ctx):
        raise NotImplementedError


def _match_any(path, patterns):
    return any(fnmatch.fnmatch(path, pat) for pat in patterns)


_REGISTRY = []


def register(cls):
    """Class decorator: add a Rule subclass to the global registry."""
    assert cls.id, "rule must define an id"
    assert all(r.id != cls.id for r in _REGISTRY), \
        "duplicate rule id {}".format(cls.id)
    _REGISTRY.append(cls())
    return cls


def all_rules():
    return list(_REGISTRY)


def get_rules(names=None):
    """Resolve a rule-name filter (iterable of ids, or None for all)."""
    if names is None:
        return all_rules()
    names = set(names)
    unknown = names - {r.id for r in _REGISTRY}
    if unknown:
        raise ValueError("unknown rule id(s): {}; known: {}".format(
            sorted(unknown), sorted(r.id for r in _REGISTRY)))
    return [r for r in _REGISTRY if r.id in names]


def suppressions(lines):
    """{lineno: set(rule ids)} from ``# lddl: disable=...`` comments. A
    directive on a code line covers that line; a directive on a
    comment-only line covers the next line as well."""
    supp = {}
    for i, text in enumerate(lines, start=1):
        m = _SUPPRESS_RE.search(text)
        if not m:
            continue
        ids = {part.strip() for part in m.group(1).split(",") if part.strip()}
        supp.setdefault(i, set()).update(ids)
        if text.lstrip().startswith("#"):
            supp.setdefault(i + 1, set()).update(ids)
    return supp


def analyze_source(source, path, rules=None):
    """Run ``rules`` over one in-memory source file.

    ``path`` is the repo-relative posix path the rules see (allow/only
    lists match against it). Returns (findings, suppressed) — findings
    survive suppression comments; suppressed did not."""
    rules = all_rules() if rules is None else rules
    tree = ast.parse(source, filename=path)
    ctx = Context(path, source, tree)
    supp = suppressions(ctx.lines)
    findings, suppressed = [], []
    for rule in rules:
        if not rule.applies_to(path):
            continue
        for f in rule.run(ctx):
            if f.rule in supp.get(f.line, ()):
                suppressed.append(f)
            else:
                findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings, suppressed


def iter_python_files(paths, root=None):
    """Yield (abs path, repo-relative posix path) for every .py under
    ``paths`` (files or directories), in sorted order — the walk itself
    must not leak filesystem order."""
    root = root or REPO_ROOT
    for p in paths:
        ap = p if os.path.isabs(p) else os.path.join(root, p)
        if not os.path.exists(ap):
            # A typo'd path must not make the gate silently green.
            raise FileNotFoundError(
                "lddl-check path does not exist: {}".format(ap))
        if os.path.isfile(ap):
            yield ap, _relpath(ap, root)
            continue
        # Deterministic walk: dirnames sorted in place, filenames sorted
        # below — the FS order never escapes this loop.
        for dirpath, dirnames, filenames in os.walk(ap):  # lddl: disable=unsorted-iteration
            dirnames.sort()
            for name in sorted(filenames):
                if name.endswith(".py"):
                    fp = os.path.join(dirpath, name)
                    yield fp, _relpath(fp, root)


def _relpath(path, root):
    rel = os.path.relpath(os.path.abspath(path), root)
    return rel.replace(os.sep, "/")


def load_baseline(path):
    """[{rule, path, match, reason}, ...] from the baseline JSON (absent
    file reads as empty)."""
    try:
        with open(path, "r", encoding="utf-8") as f:
            data = json.load(f)
    except OSError:
        return []
    entries = data.get("entries", []) if isinstance(data, dict) else data
    return [e for e in entries if isinstance(e, dict)]


def baseline_entry(finding, reason="", count=1):
    entry = {"rule": finding.rule, "path": finding.path,
             "match": finding.snippet, "reason": reason}
    if count != 1:
        entry["count"] = count
    return entry


def split_baselined(findings, entries):
    """Partition findings into (new, baselined) against baseline entries.

    Matching is COUNT-aware: an entry absorbs ``count`` findings
    (default 1) with the same (rule, path, stripped-line) identity, so
    pasting a second copy of a baselined line into the same file is a new
    finding, not a free ride on the first copy's grandfathering."""
    remaining = {}
    for e in entries:
        key = (e.get("rule"), e.get("path"), e.get("match"))
        remaining[key] = remaining.get(key, 0) + int(e.get("count", 1))
    new, old = [], []
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.rule)):
        if remaining.get(f.key(), 0) > 0:
            remaining[f.key()] -= 1
            old.append(f)
        else:
            new.append(f)
    return new, old


class Report(object):
    """Result of a tree-wide run: new findings, baselined findings,
    inline-suppressed findings, parse errors, files analyzed, and cache/
    timing stats."""

    def __init__(self):
        self.new = []
        self.baselined = []
        self.suppressed = []
        self.errors = []  # (path, message)
        self.files = 0
        self.files_cached = 0  # served from the content-hash cache
        self.elapsed_s = 0.0

    @property
    def ok(self):
        return not self.new and not self.errors

    def to_dict(self):
        return {
            "ok": self.ok,
            "files": self.files,
            "files_cached": self.files_cached,
            "elapsed_s": round(self.elapsed_s, 3),
            "findings": [f.to_dict() for f in self.new],
            "baselined": [f.to_dict() for f in self.baselined],
            "suppressed": [f.to_dict() for f in self.suppressed],
            "errors": [{"path": p, "message": m} for p, m in self.errors],
        }


class _Cache(object):
    """Content-hash keyed per-file cache of parse + analysis artifacts.

    Each entry stores, for one (file content, ANALYSIS_VERSION, rule-set)
    state: the full-rule-set syntactic findings and suppressions, the
    suppression-comment map, the module's dataflow facts (phase A of
    :mod:`.dataflow`), and a resolution stub (functions + import aliases)
    so the project model can be rebuilt WITHOUT re-parsing cache hits.
    The interprocedural fixpoint (phase B) is always recomputed — it is
    cheap, and it is how an edit in one file updates findings in its
    callers and callees."""

    def __init__(self, path, rule_sig):
        self.path = path
        self.rule_sig = rule_sig
        self.entries = {}
        self.dirty = False
        if path and os.path.isfile(path):
            try:
                with open(path, "r", encoding="utf-8") as f:
                    data = json.load(f)
                if (data.get("version") == ANALYSIS_VERSION
                        and data.get("rules") == rule_sig):
                    self.entries = data.get("files", {})
            except (OSError, ValueError):
                # A corrupt/unreadable cache reads as empty: every file
                # re-analyzes and the next save rewrites it.
                self.entries = {}

    def get(self, relpath, content_hash):
        entry = self.entries.get(relpath)
        if entry is not None and entry.get("hash") == content_hash:
            return entry
        return None

    def put(self, relpath, entry):
        self.entries[relpath] = entry
        self.dirty = True

    def save(self):
        if not self.path or not self.dirty:
            return
        try:
            with open(self.path, "w", encoding="utf-8") as f:
                json.dump({"version": ANALYSIS_VERSION,
                           "rules": self.rule_sig,
                           "files": self.entries}, f)
        # Best-effort accelerator: an unwritable cache (read-only
        # checkout, full disk) must never fail the check itself.
        except OSError:  # lddl: disable=swallowed-error
            pass


def _sha256(text):
    return hashlib.sha256(text.encode("utf-8")).hexdigest()


_SELF_DIGEST = None


def _rule_signature():
    """Cache key component: registered rule ids PLUS a digest of the
    analysis package's own sources, so editing a rule or the engine
    invalidates every cached entry without a manual ANALYSIS_VERSION
    bump. Entries cache the FULL rule set's results (``--rules`` filters
    at report time), so the signature ignores any per-run filter."""
    global _SELF_DIGEST
    if _SELF_DIGEST is None:
        h = hashlib.sha256()
        pkg_dir = os.path.dirname(os.path.abspath(__file__))
        for name in sorted(os.listdir(pkg_dir)):
            if name.endswith(".py"):
                with open(os.path.join(pkg_dir, name), "rb") as f:
                    h.update(name.encode())
                    h.update(f.read())
        _SELF_DIGEST = h.hexdigest()
    return sorted(r.id for r in _REGISTRY) + [_SELF_DIGEST]


def run_check(paths, rules=None, baseline_path=None, root=None,
              cache_path=None, report_paths=None):
    """Analyze every .py under ``paths`` and return a :class:`Report`.

    - ``baseline_path`` defaults to the checked-in
      ``lddl_tpu_torch/tools/lddl_check_baseline.json`` (pass ``""``
      to disable).
    - ``cache_path``: AST+summary cache file. ``None`` disables caching;
      the CLI passes ``<root>/.lddl_tpu_torch_check_cache.json`` by
      default.
    - ``report_paths``: optional iterable of repo-relative paths —
      findings are REPORTED only for these files while the analysis (and
      the interprocedural fixpoint) still covers all of ``paths``. This
      is the ``--changed-only`` fast path.
    """
    from . import concurrency as _conc
    from . import flow_rules as _flow
    from . import dataflow as _dataflow
    from . import project as _project

    t0 = time.monotonic()
    root = root or REPO_ROOT
    rules = all_rules() if rules is None else rules
    selected_ids = {r.id for r in rules}
    file_rules = [r for r in all_rules() if r.scope == "file"]
    flow_rules_by_id = {r.id: r for r in all_rules()
                        if r.scope == "project"}
    want_flow = any(r.scope == "project" for r in rules)
    if baseline_path is None:
        baseline_path = os.path.join(root, DEFAULT_BASELINE)
    entries = load_baseline(baseline_path) if baseline_path else []
    report = Report()
    # The analyzed path set is part of the cache signature: facts
    # extracted under a PARTIAL project model (an explicit-path run)
    # record unresolvable cross-package calls as opaque externals, and
    # reusing them in a full-tree run would silently drop flow findings.
    cache = _Cache(cache_path,
                   _rule_signature() + [sorted(str(p) for p in paths)])

    proj = _project.Project()
    parsed_modules = []  # ModuleInfo needing fact extraction
    module_facts = []  # dataflow._ModuleFacts for every healthy file
    conc_facts = []  # concurrency._CModuleFacts for every healthy file
    per_file = {}  # relpath -> {"supp": {...}, "lines": [...]}
    findings = []  # pre-baseline, post-suppression
    cache_entries_pending = {}  # relpath -> entry missing "facts"

    seen_paths = set()
    for abspath, relpath in iter_python_files(paths, root=root):
        if relpath in seen_paths:
            # Overlapping path arguments (e.g. "lddl_tpu_torch
            # lddl_tpu_torch/preprocess") must not analyze a file twice: the
            # count-aware baseline would see the duplicate findings as
            # NEW.
            continue
        seen_paths.add(relpath)
        report.files += 1
        try:
            with open(abspath, "r", encoding="utf-8") as f:
                source = f.read()
        except OSError as e:
            report.errors.append((relpath, "unreadable: {}".format(e)))
            continue
        content_hash = _sha256(source)
        lines = source.splitlines()
        hit = cache.get(relpath, content_hash)
        if hit is not None:
            report.files_cached += 1
            supp = {int(k): set(v) for k, v in hit["supp"].items()}
            per_file[relpath] = {"supp": supp, "lines": lines}
            for d in hit["findings"]:
                f = Finding(d["rule"], d["path"], d["line"], d["col"],
                            d["message"], d["snippet"])
                if f.rule in selected_ids:
                    findings.append(f)
            for d in hit["suppressed"]:
                f = Finding(d["rule"], d["path"], d["line"], d["col"],
                            d["message"], d["snippet"])
                if f.rule in selected_ids:
                    report.suppressed.append(f)
            module_facts.append(
                _dataflow._ModuleFacts.from_dict(hit["facts"]))
            conc_facts.append(
                _conc._CModuleFacts.from_dict(hit["cfacts"]))
            _add_stub_module(proj, relpath, hit["stub"])
            continue
        try:
            tree = ast.parse(source, filename=relpath)
        except SyntaxError as e:
            report.errors.append((relpath, "syntax error: {}".format(e)))
            continue
        ctx = Context(relpath, source, tree)
        supp = suppressions(ctx.lines)
        per_file[relpath] = {"supp": supp, "lines": lines}
        raw, kept, supped = [], [], []
        for rule in file_rules:
            if not rule.applies_to(relpath):
                continue
            for f in rule.run(ctx):
                raw.append(f)
        for f in raw:
            (supped if f.rule in supp.get(f.line, ()) else kept).append(f)
        findings.extend(f for f in kept if f.rule in selected_ids)
        report.suppressed.extend(f for f in supped
                                 if f.rule in selected_ids)
        mod = proj.add_source(relpath, source, tree=tree)
        parsed_modules.append(mod)
        cache_entries_pending[relpath] = {
            "hash": content_hash,
            "findings": [f.to_dict() for f in kept],
            "suppressed": [f.to_dict() for f in supped],
            "supp": {str(k): sorted(v) for k, v in supp.items()},
            "stub": _stub_of_module(mod),
        }

    # Phase A for newly-parsed files (needs the COMPLETE project model so
    # cross-module calls resolve), then cache them.
    for mod in parsed_modules:
        mf = _dataflow.extract_module_facts(proj, mod)
        module_facts.append(mf)
        cf = _conc.extract_module_facts(proj, mod)
        conc_facts.append(cf)
        entry = cache_entries_pending[mod.path]
        entry["facts"] = mf.to_dict()
        entry["cfacts"] = cf.to_dict()
        cache.put(mod.path, entry)

    # Phase B: the interprocedural fixpoint + flow findings. The
    # concurrency findings chain through the same routing so allow
    # lists, suppressions, ``--rules`` filters, and the baseline apply
    # identically.
    raw_flow = []
    if want_flow and module_facts:
        raw_flow.extend(_flow.run_flow_analysis(module_facts))
    if want_flow and conc_facts:
        raw_flow.extend(_conc.run_concurrency_analysis(conc_facts))
    if raw_flow:
        for rule_id, path, lineno, message in raw_flow:
            rule = flow_rules_by_id.get(rule_id)
            if rule is None or rule_id not in selected_ids:
                continue
            if not rule.applies_to(path):
                continue
            info = per_file.get(path)
            snippet = ""
            if info and 1 <= lineno <= len(info["lines"]):
                snippet = info["lines"][lineno - 1].strip()
            f = Finding(rule_id, path, lineno, 0, message, snippet)
            if info and rule_id in info["supp"].get(lineno, ()):
                report.suppressed.append(f)
            else:
                findings.append(f)

    if report_paths is not None:
        wanted = set(report_paths)
        findings = [f for f in findings if f.path in wanted]
        report.suppressed = [f for f in report.suppressed
                             if f.path in wanted]

    new, old = split_baselined(findings, entries)
    report.new.extend(new)
    report.baselined.extend(old)
    report.new.sort(key=lambda f: (f.path, f.line, f.rule))
    report.baselined.sort(key=lambda f: (f.path, f.line, f.rule))
    cache.save()
    report.elapsed_s = time.monotonic() - t0
    return report


def _stub_of_module(mod):
    """Resolution-only snapshot of a parsed module for the cache: enough
    for OTHER files' call sites to resolve into it without re-parsing."""
    return {
        "modname": mod.modname,
        "aliases": mod.aliases,
        "functions": [
            {"local": local, "name": fi.name, "cls": fi.cls,
             "params": fi.params, "lineno": fi.lineno}
            for local, fi in sorted(mod.functions.items())
        ],
    }


def _add_stub_module(proj, relpath, stub):
    from .project import FunctionInfo, ModuleInfo

    mod = ModuleInfo.__new__(ModuleInfo)
    mod.path = relpath
    mod.source = ""
    mod.lines = []
    mod.tree = None
    mod.modname = stub["modname"]
    mod.aliases = dict(stub["aliases"])
    mod.functions = {}
    mod.global_assigns = {}
    for fd in stub["functions"]:
        qual = "{}.{}".format(mod.modname, fd["local"])
        fi = FunctionInfo.__new__(FunctionInfo)
        fi.qualname = qual
        fi.name = fd["name"]
        fi.cls = fd["cls"]
        fi.module = mod
        fi.path = relpath
        fi.node = None
        fi.lineno = fd["lineno"]
        fi.params = list(fd["params"])
        mod.functions[fd["local"]] = fi
    proj.modules_by_path[relpath] = mod
    proj.modules_by_name[mod.modname] = mod
    for fi in mod.functions.values():
        proj.functions[fi.qualname] = fi
    return mod
