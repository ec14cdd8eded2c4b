"""Whole-program project model for the flow rules.

The syntactic rules in :mod:`.rules` see one file at a time, which means a
one-line helper (``def now(): return time.time()``) launders any guarded
pattern past them. The flow rules instead consult this model: every
analyzed file parsed once, import/name bindings resolved to
fully-qualified dotted names, functions and methods indexed, and
re-export chains (``from .tracing import span`` in a package
``__init__``) followed — so a call site anywhere in the tree resolves to
the :class:`FunctionInfo` that actually runs.

Scope and precision (deliberate):

- Name resolution is purely static: ``Name(.Attribute)*`` chains through
  import aliases, module-local definitions, and ``self.method`` within a
  class. Values passed around as first-class functions, dynamic
  attributes, and subclass dispatch do not resolve (the taint engine
  treats those calls as opaque and over-approximates their data flow).
- A module's top-level simple assignments are recorded so module-global
  state (``_jitter_rng = random.Random()``) participates in the taint
  analysis.
"""

import ast


def module_name_of(relpath):
    """Dotted module name for a repo-relative posix path.

    ``lddl_tpu_torch/preprocess/runner.py ->
    lddl_tpu_torch.preprocess.runner``;
    package ``__init__.py`` maps to the package itself.
    """
    parts = relpath[:-3].split("/") if relpath.endswith(".py") \
        else relpath.split("/")
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


class FunctionInfo(object):
    """One function or method definition in the project."""

    __slots__ = ("qualname", "name", "cls", "module", "path", "node",
                 "params", "lineno")

    def __init__(self, qualname, name, cls, module, path, node):
        self.qualname = qualname  # e.g. lddl_tpu_torch.utils.fs.mkdir
        self.name = name
        self.cls = cls  # enclosing class name or None
        self.module = module  # ModuleInfo
        self.path = path
        self.node = node
        self.lineno = node.lineno
        self.params = [a.arg for a in (node.args.posonlyargs
                                       + node.args.args)]

    def __repr__(self):
        return "FunctionInfo({})".format(self.qualname)


class ModuleInfo(object):
    """One parsed source file: tree, aliases, functions, globals."""

    def __init__(self, path, source, tree):
        self.path = path  # repo-relative posix
        self.source = source
        self.lines = source.splitlines()
        self.tree = tree
        self.modname = module_name_of(path)
        self.aliases = _resolve_aliases(tree, self.modname,
                                        path.endswith("__init__.py"))
        self.functions = {}  # "f" or "Cls.m" -> FunctionInfo
        self.global_assigns = {}  # name -> ast expr (last simple assign)
        self._index()

    def _index(self):
        for node in self.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._add_function(node, cls=None)
            elif isinstance(node, ast.ClassDef):
                for item in node.body:
                    if isinstance(item, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                        self._add_function(item, cls=node.name)
            elif isinstance(node, ast.Assign):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        self.global_assigns[tgt.id] = node.value
            elif isinstance(node, ast.AnnAssign) and node.value is not None \
                    and isinstance(node.target, ast.Name):
                self.global_assigns[node.target.id] = node.value

    def _add_function(self, node, cls):
        local = "{}.{}".format(cls, node.name) if cls else node.name
        qual = "{}.{}".format(self.modname, local)
        self.functions[local] = FunctionInfo(qual, node.name, cls, self,
                                             self.path, node)


def _resolve_aliases(tree, modname, is_package):
    """Like :func:`core._import_aliases` but with relative imports made
    absolute against the importing module's package, so
    ``from ..resilience import io`` inside
    ``lddl_tpu_torch.preprocess.runner`` binds
    ``io -> lddl_tpu_torch.resilience.io`` (not the bare ``resilience.io``
    the per-file rules match on suffixes of)."""
    pkg_parts = modname.split(".") if is_package \
        else modname.split(".")[:-1]
    aliases = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    aliases[a.asname] = a.name
                else:
                    head = a.name.split(".")[0]
                    aliases[head] = head
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                anchor = pkg_parts[:len(pkg_parts) - (node.level - 1)]
                base = anchor + (node.module.split(".") if node.module
                                 else [])
            else:
                base = (node.module or "").split(".") if node.module else []
            for a in node.names:
                if a.name == "*":
                    continue
                local = a.asname or a.name
                aliases[local] = ".".join(base + [a.name]) if base \
                    else a.name
    return aliases


class Project(object):
    """All analyzed modules plus cross-module name resolution."""

    def __init__(self):
        self.modules_by_path = {}
        self.modules_by_name = {}
        self.functions = {}  # fully-qualified qualname -> FunctionInfo

    def add_source(self, path, source, tree=None):
        tree = tree if tree is not None else ast.parse(source,
                                                       filename=path)
        mod = ModuleInfo(path, source, tree)
        self.modules_by_path[path] = mod
        self.modules_by_name[mod.modname] = mod
        for fi in mod.functions.values():
            self.functions[fi.qualname] = fi
        return mod

    # ------------------------------------------------------- resolution

    def resolve_dotted(self, module, dotted_node):
        """Absolute dotted name of a ``Name(.Attribute)*`` chain seen in
        ``module``, or None for anything dynamic. Head segment maps
        through the module's import aliases."""
        parts = []
        node = dotted_node
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        parts.append(node.id)
        parts.reverse()
        head = module.aliases.get(parts[0], parts[0])
        return ".".join(head.split(".") + parts[1:])

    def resolve_function(self, module, absolute, cls=None, _seen=None):
        """:class:`FunctionInfo` for an absolute dotted name, following
        re-export chains; None when the name is not a project function.

        ``cls`` names the class whose method body the lookup happens in,
        so ``self.helper`` resolves to ``module.Cls.helper``.
        """
        if absolute is None:
            return None
        _seen = _seen if _seen is not None else set()
        if absolute in _seen:
            return None
        _seen.add(absolute)

        parts = absolute.split(".")
        # self.method() inside a class body.
        if parts[0] == "self" and cls is not None and len(parts) == 2:
            return module.functions.get("{}.{}".format(cls, parts[1]))
        # Module-local: bare f() / Cls.m reference.
        if len(parts) <= 2:
            local = ".".join(parts)
            if local in module.functions:
                return module.functions[local]

        fi = self.functions.get(absolute)
        if fi is not None:
            return fi
        # <module>.<attr> where <module> is a project module: the attr may
        # itself be a re-export alias there (package __init__ pattern).
        for cut in range(len(parts) - 1, 0, -1):
            modname = ".".join(parts[:cut])
            owner = self.modules_by_name.get(modname)
            if owner is None:
                continue
            rest = parts[cut:]
            local = ".".join(rest)
            if local in owner.functions:
                return owner.functions[local]
            if rest[0] in owner.aliases:
                target = ".".join(owner.aliases[rest[0]].split(".")
                                  + rest[1:])
                return self.resolve_function(owner, target, _seen=_seen)
            return None
        return None


def build_project(file_sources):
    """Project from ``{repo-relative posix path: source}``. Files that do
    not parse are skipped (their syntax errors are reported by the
    per-file pass)."""
    project = Project()
    for path in sorted(file_sources):
        try:
            project.add_source(path, file_sources[path])
        except SyntaxError:
            continue
    return project


def project_from_paths(paths, root):
    """Convenience: build a Project straight from disk paths (used by the
    fixture tests; run_check goes through the cache instead)."""
    from .core import iter_python_files
    sources = {}
    for abspath, relpath in iter_python_files(paths, root=root):
        with open(abspath, "r", encoding="utf-8") as f:
            sources[relpath] = f.read()
    return build_project(sources)
