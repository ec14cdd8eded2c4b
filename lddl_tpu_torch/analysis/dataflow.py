"""Interprocedural taint engine behind the flow rules.

Counterpart of ``lddl_tpu/analysis/dataflow.py``; the lease module it
names is the port's ``resilience/leases.py``. Four taint *kinds* track
values whose presence in pipeline output breaks the determinism contract
(byte-stable manifests, rank-identical RNG, FS-order-independent
enumeration):

``wallclock``
    wall time, pids, uuids, hostnames — anything that differs across runs
    or ranks. Sinks: manifest/ledger builder content, publish arguments.
``rng``
    draws from *unkeyed* random state (``random.random``,
    ``np.random.default_rng()`` with no key, an unseeded
    ``random.Random()``). Sinks: draw methods on a tainted generator in
    pipeline code, publish arguments.
``fsorder``
    the *ordering* of ``os.listdir``/``glob``/``os.walk`` results. Clears
    through ``sorted()`` / order-insensitive reductions; sinks are
    order-observing uses (iteration, indexing, string interpolation,
    error text, publish arguments).
``lease``
    scheduling state from :mod:`lddl_tpu_torch.resilience.leases` (holder ids,
    epochs, wall-clock deadlines). Sources are synthesized in phase B:
    the return value of ANY call into the lease module is lease-tainted
    (and counts as boundary-crossing by construction). Sinks: publish
    arguments and manifest/ledger builder content — leases decide WHO
    runs a unit, and nothing about the winner may reach shard bytes or
    ``.manifest.json``. The lease module's own file writes are exempt
    (lease files ARE lease state; they live in ``_leases/``, never a
    shard directory).

A fourth analysis is an *effect* propagation, not value taint:
``publish-path`` marks every function that transitively performs a raw
(non-atomic) file write, so a shard-package call into a helper that
bypasses ``resilience.io`` is caught no matter where the helper lives.

How it works
------------

Phase A (per file, cacheable): each function body is abstract-interpreted
once into a serializable *fact* record. Expressions evaluate to taint
**terms** — unions of atoms::

    ["src", kind, name, path, lineno]   taint introduced here
    ["param", i]                        the function's i-th parameter
    ["call", qualname, [args...], ln]   result of a resolved project call
    ["ext", name, [args...]]            result of an unresolved call
    ["san", [kinds...], term]           sanitizer applied (clears kinds)
    ["elem", term]                      element-of (clears fsorder: an
                                        element carries no ordering)
    ["global", modname, name]           module-global read

Sink sites record the term that reached them; resolved calls record their
argument terms; raw writes record their location. Nothing here depends on
other files, so facts cache by content hash.

Phase B (global, cheap): per-function summaries — which kinds the return
value carries, which params pass through to the return, which params
reach a sink — are iterated to a fixpoint across the call graph, then
every sink term is evaluated under the final summaries. A finding is
emitted only when the taint **crossed a function or module-global
boundary**: same-function flows are the syntactic rules' territory and
stay out of the flow rules' output.
"""

import ast

# ------------------------------------------------------------ vocabulary

KINDS = ("wallclock", "rng", "fsorder", "lease")

RULE_ID_OF_KIND = {
    "wallclock": "wall-clock-flow",
    "rng": "rng-flow",
    "fsorder": "fs-order-flow",
    "lease": "lease-isolation",
}
PUBLISH_PATH_RULE = "publish-path-flow"

# The lease protocol module: calls into it yield lease-tainted values
# (phase B synthesizes the source), and its OWN publish calls are not
# shard publishes (lease files live under _leases/, deliberately written
# with the atomic primitives but never part of the dataset).
LEASE_MODULE = "lddl_tpu_torch/resilience/leases.py"

# Writer-thread boundary modules (the async shard sink): a callable
# passed INTO any function of these modules is deferred execution — the
# sink's writer thread will call it later. Phase A synthesizes a call
# edge at the enqueue site for every function-valued argument (named
# function references AND lambda bodies), so the publish-path effect
# analysis sees "enqueue -> deferred publish" as a call chain and a raw
# ``pq.write_table``/write-mode ``open`` laundered through
# ``ShardWriter.submit`` is caught exactly like a direct call
# (fixture-pinned in tests/test_torch_dataflow.py). Matched by suffix so test
# fixtures can exercise the boundary with their own sink module copies.
DEFERRED_CALL_MODULE_SUFFIXES = ("preprocess/sink.py",)

# Method names that enqueue a callable for deferred execution. The async
# sink's entry point is ``ShardWriter.submit`` — a method on a LOCAL
# value, which dotted resolution cannot bind to the sink module, so the
# method NAME is the trigger. concurrent.futures ``pool.submit`` matches
# too, which is sound for the effect analysis (pool workers really do
# run the submitted function) and precision-neutral in practice (only
# function-REFERENCE arguments synthesize edges; call-result arguments
# are already modeled).
DEFERRED_METHOD_NAMES = frozenset({"submit"})


def _is_deferred_call_module(path):
    p = (path or "").replace("\\", "/")
    return any(p.endswith(s) for s in DEFERRED_CALL_MODULE_SUFFIXES)

_WALLCLOCK_SOURCES = frozenset({
    "time.time", "time.time_ns", "time.localtime", "time.gmtime",
    "time.ctime", "time.strftime", "datetime.datetime.now",
    "datetime.datetime.utcnow", "datetime.datetime.today",
    "datetime.date.today", "os.getpid", "os.getppid", "uuid.uuid1",
    "uuid.uuid4", "socket.gethostname", "platform.node",
    "threading.get_ident",
})

# CPython random-module functions drawing from hidden global state.
_PY_RANDOM_FUNCS = frozenset({
    "seed", "random", "randint", "randrange", "uniform", "shuffle",
    "choice", "choices", "sample", "gauss", "normalvariate", "betavariate",
    "expovariate", "getrandbits", "randbytes", "triangular",
    "lognormvariate", "vonmisesvariate", "paretovariate", "weibullvariate",
})

_FS_SOURCES = frozenset({
    "os.listdir", "os.scandir", "os.walk", "glob.glob", "glob.iglob",
})

# Order-insensitive consumers / order-erasing constructions: clear fsorder.
_FS_SANITIZERS = frozenset({
    "sorted", "set", "frozenset", "len", "sum", "min", "max", "any", "all",
    "collections.Counter",
})

# Externals whose result preserves input iteration order (everything else
# unknown drops fsorder taint to keep the rule's precision high; wallclock
# and rng taint flow through ALL externals).
_ORDER_PRESERVING = frozenset({
    "list", "tuple", "reversed", "iter", "enumerate", "zip", "filter",
    "map", "itertools.chain", "itertools.islice",
})

# Draw methods: calling one of these on an rng-tainted receiver uses the
# unkeyed stream to shape data.
_DRAW_METHODS = frozenset({
    "random", "randint", "integers", "choice", "choices", "shuffle",
    "permutation", "permuted", "uniform", "normal", "standard_normal",
    "sample", "bytes", "gauss", "randrange", "getrandbits",
})

# Publish functions: (name suffix) -> indices of arguments whose content
# or name lands in a shard directory. atomic_publish's arg 0 is the
# pre-publish temp name (pid-tagged scratch) and deliberately not a sink.
_PUBLISH_SINKS = {
    "atomic_write": (0, 1),
    "write_table_atomic": (0, 1),
    "atomic_publish": (1,),
    "json.dump": (0,),
}

# Raw-write operations for the publish-path effect analysis.
_MOVE_FUNCS = frozenset({"os.replace", "os.rename", "os.renames",
                         "shutil.move"})


def _open_write_mode(node):
    """Mode string of a write-mode open() call, or None when read-only or
    not a literal-mode open."""
    mode = None
    if len(node.args) >= 2:
        mode = node.args[1]
    for kw in node.keywords:
        if kw.arg == "mode":
            mode = kw.value
    if mode is None:
        return None  # default "r"
    if isinstance(mode, ast.Constant) and isinstance(mode.value, str):
        return mode.value if any(c in mode.value for c in "wax") else None
    return "?"  # dynamic mode: treat as a potential write


# ----------------------------------------------------------- term algebra
#
# Terms are plain nested lists so they JSON-serialize into the cache.


def _union(*terms):
    out = []
    for t in terms:
        for atom in t:
            if atom not in out:
                out.append(atom)
    return out


def _src(kind, name, path, lineno):
    return ["src", kind, name, path, lineno]


# --------------------------------------------------------- fact extraction


class _FunctionFacts(object):
    """Serializable phase-A record for one function."""

    def __init__(self, qualname, name, cls, path, lineno, params):
        self.qualname = qualname
        self.name = name
        self.cls = cls
        self.path = path
        self.lineno = lineno
        self.params = params
        self.returns = []  # term
        # [{"kinds": [...], "what": str, "lineno": int, "term": term}]
        self.sinks = []
        # [{"callee": qualname, "args": [term-or-None per param],
        #   "lineno": int}]
        self.calls = []
        self.raw_writes = []  # [{"op": str, "lineno": int}]

    def to_dict(self):
        return {"qualname": self.qualname, "name": self.name,
                "cls": self.cls, "path": self.path, "lineno": self.lineno,
                "params": self.params, "returns": self.returns,
                "sinks": self.sinks, "calls": self.calls,
                "raw_writes": self.raw_writes}

    @classmethod
    def from_dict(cls, d):
        ff = cls(d["qualname"], d["name"], d["cls"], d["path"], d["lineno"],
                 d["params"])
        ff.returns = d["returns"]
        ff.sinks = d["sinks"]
        ff.calls = d["calls"]
        ff.raw_writes = d["raw_writes"]
        return ff


class _ModuleFacts(object):
    def __init__(self, path, modname):
        self.path = path
        self.modname = modname
        self.functions = []  # [_FunctionFacts]
        self.globals = {}  # name -> term

    def to_dict(self):
        return {"path": self.path, "modname": self.modname,
                "functions": [f.to_dict() for f in self.functions],
                "globals": self.globals}

    @classmethod
    def from_dict(cls, d):
        mf = cls(d["path"], d["modname"])
        mf.functions = [_FunctionFacts.from_dict(f) for f in d["functions"]]
        mf.globals = d["globals"]
        return mf


def extract_module_facts(project, module):
    """Phase A for one module: facts for every function plus module-global
    assignment terms."""
    mf = _ModuleFacts(module.path, module.modname)
    top = _Extractor(project, module, facts=None, cls=None)
    for name, value in sorted(module.global_assigns.items()):
        mf.globals[name] = top.eval_expr(value)
    for local in sorted(module.functions):
        fi = module.functions[local]
        ff = _FunctionFacts(fi.qualname, fi.name, fi.cls, module.path,
                            fi.lineno, fi.params)
        ex = _Extractor(project, module, facts=ff, cls=fi.cls)
        env = {}
        for i, p in enumerate(fi.params):
            env[p] = [["param", i]]
        ex.run_body(fi.node.body, env)
        mf.functions.append(ff)
    return mf


class _Extractor(object):
    """One pass over a function body collecting terms, sinks and calls.

    Loops are processed twice so loop-carried taint propagates; branches
    are processed sequentially on one environment (flow-lite union)."""

    def __init__(self, project, module, facts, cls):
        self.project = project
        self.module = module
        self.facts = facts  # None at module top level
        self.cls = cls
        # Builder contexts whose content is resume-compared byte-for-byte:
        # manifest/ledger plus the ingest record builders (journal
        # segments, intake records, generation meta) — keep in sync with
        # rules.ManifestDeterminismRule.NAME_TOKENS.
        self._manifest_ctx = bool(
            facts is not None
            and any(tok in facts.name.lower()
                    for tok in ("manifest", "ledger", "journal", "intake",
                                "generation")))

    # ------------------------------------------------------- statements

    def run_body(self, stmts, env):
        for stmt in stmts:
            self.run_stmt(stmt, env)

    def run_stmt(self, stmt, env):
        if isinstance(stmt, ast.Assign):
            t = self.eval_expr(stmt.value, env)
            for tgt in stmt.targets:
                self._bind_target(tgt, t, env)
        elif isinstance(stmt, ast.AnnAssign):
            if stmt.value is not None:
                self._bind_target(stmt.target,
                                  self.eval_expr(stmt.value, env), env)
        elif isinstance(stmt, ast.AugAssign):
            t = self.eval_expr(stmt.value, env)
            if isinstance(stmt.target, ast.Name):
                env[stmt.target.id] = _union(
                    env.get(stmt.target.id, []), t)
        elif isinstance(stmt, (ast.For, ast.AsyncFor)):
            it = self.eval_expr(stmt.iter, env)
            self._sink(["fsorder"], "iterated in a for-loop", stmt.iter, it)
            self._bind_target(stmt.target, [["elem", it]] if it else [],
                              env)
            for _ in range(2):
                self.run_body(stmt.body, env)
            self.run_body(stmt.orelse, env)
        elif isinstance(stmt, ast.While):
            self.eval_expr(stmt.test, env)
            for _ in range(2):
                self.run_body(stmt.body, env)
            self.run_body(stmt.orelse, env)
        elif isinstance(stmt, ast.If):
            self.eval_expr(stmt.test, env)
            self.run_body(stmt.body, env)
            self.run_body(stmt.orelse, env)
        elif isinstance(stmt, ast.Try):
            self.run_body(stmt.body, env)
            for h in stmt.handlers:
                self.run_body(h.body, env)
            self.run_body(stmt.orelse, env)
            self.run_body(stmt.finalbody, env)
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                t = self.eval_expr(item.context_expr, env)
                if item.optional_vars is not None:
                    self._bind_target(item.optional_vars, t, env)
            self.run_body(stmt.body, env)
        elif isinstance(stmt, ast.Return):
            if stmt.value is not None and self.facts is not None:
                t = self.eval_expr(stmt.value, env)
                self.facts.returns = _union(self.facts.returns, t)
                if self._manifest_ctx:
                    self._sink(["wallclock", "rng", "lease"],
                               "returned from manifest/ledger builder "
                               "{}()".format(self.facts.name),
                               stmt, t)
        elif isinstance(stmt, ast.Raise):
            if stmt.exc is not None:
                t = self.eval_expr(stmt.exc, env)
                self._sink(["fsorder"], "rendered into error text",
                           stmt, t)
        elif isinstance(stmt, ast.Expr):
            # In-place sort sanitizes the sorted name.
            v = stmt.value
            if isinstance(v, ast.Call) and isinstance(v.func, ast.Attribute) \
                    and v.func.attr == "sort" \
                    and isinstance(v.func.value, ast.Name):
                name = v.func.value.id
                if env.get(name):
                    env[name] = [["san", ["fsorder"], env[name]]]
                for a in v.args:
                    self.eval_expr(a, env)
            else:
                self.eval_expr(v, env)
        elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # Nested function: its effects belong to the enclosing
            # function; params are unknown (empty terms).
            inner = dict(env)
            for a in stmt.args.posonlyargs + stmt.args.args:
                inner[a.arg] = []
            self.run_body(stmt.body, inner)
        elif isinstance(stmt, ast.ClassDef):
            pass
        elif isinstance(stmt, (ast.Delete, ast.Import, ast.ImportFrom,
                               ast.Global, ast.Nonlocal, ast.Pass,
                               ast.Break, ast.Continue)):
            pass
        elif isinstance(stmt, ast.Assert):
            self.eval_expr(stmt.test, env)

    def _bind_target(self, tgt, term, env):
        if isinstance(tgt, ast.Name):
            env[tgt.id] = term
        elif isinstance(tgt, (ast.Tuple, ast.List)):
            for el in tgt.elts:
                self._bind_target(el, [["elem", term]] if term else [],
                                  env)
        elif isinstance(tgt, ast.Starred):
            self._bind_target(tgt.value, term, env)
        elif isinstance(tgt, ast.Subscript):
            # d[k] = v: taint the container; in manifest builders the
            # stored value is manifest content.
            if self._manifest_ctx:
                self._sink(["wallclock", "rng", "lease"],
                           "stored into manifest/ledger content in "
                           "{}()".format(self.facts.name), tgt, term)
            base = tgt.value
            if isinstance(base, ast.Name):
                env[base.id] = _union(env.get(base.id, []), term)
        elif isinstance(tgt, ast.Attribute):
            path = self._attr_path(tgt)
            if path is not None:
                env[path] = term

    @staticmethod
    def _attr_path(node):
        parts = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        parts.append(node.id)
        return ".".join(reversed(parts))

    # ------------------------------------------------------ expressions

    def eval_expr(self, node, env=None):
        env = env if env is not None else {}
        if node is None or isinstance(node, ast.Constant):
            return []
        if isinstance(node, ast.Name):
            if node.id in env:
                return env[node.id]
            if node.id in self.module.global_assigns:
                return [["global", self.module.modname, node.id]]
            return []
        if isinstance(node, ast.Attribute):
            path = self._attr_path(node)
            if path is not None and path in env:
                return env[path]
            return self.eval_expr(node.value, env)
        if isinstance(node, ast.Call):
            return self._eval_call(node, env)
        if isinstance(node, ast.BinOp):
            return _union(self.eval_expr(node.left, env),
                          self.eval_expr(node.right, env))
        if isinstance(node, ast.BoolOp):
            return _union(*[self.eval_expr(v, env) for v in node.values])
        if isinstance(node, ast.UnaryOp):
            return self.eval_expr(node.operand, env)
        if isinstance(node, ast.Compare):
            return _union(self.eval_expr(node.left, env),
                          *[self.eval_expr(c, env)
                            for c in node.comparators])
        if isinstance(node, ast.IfExp):
            self.eval_expr(node.test, env)
            return _union(self.eval_expr(node.body, env),
                          self.eval_expr(node.orelse, env))
        if isinstance(node, ast.Subscript):
            v = self.eval_expr(node.value, env)
            self._sink(["fsorder"], "indexed by position", node, v)
            s = self.eval_expr(node.slice, env)
            return _union([["elem", v]] if v else [], s)
        if isinstance(node, (ast.List, ast.Tuple)):
            return _union(*[self.eval_expr(e, env) for e in node.elts])
        if isinstance(node, ast.Set):
            inner = _union(*[self.eval_expr(e, env) for e in node.elts])
            return [["san", ["fsorder"], inner]] if inner else []
        if isinstance(node, ast.Dict):
            parts = [self.eval_expr(k, env) for k in node.keys
                     if k is not None]
            parts += [self.eval_expr(v, env) for v in node.values]
            t = _union(*parts)
            if self._manifest_ctx and t:
                self._sink(["wallclock", "rng", "lease"],
                           "placed in manifest/ledger content in "
                           "{}()".format(self.facts.name), node, t)
            return t
        if isinstance(node, (ast.ListComp, ast.GeneratorExp, ast.SetComp,
                             ast.DictComp)):
            return self._eval_comp(node, env)
        if isinstance(node, ast.JoinedStr):
            t = _union(*[self.eval_expr(v, env) for v in node.values])
            self._sink(["fsorder"], "interpolated into a string", node, t)
            return t
        if isinstance(node, ast.FormattedValue):
            return self.eval_expr(node.value, env)
        if isinstance(node, ast.Starred):
            return self.eval_expr(node.value, env)
        if isinstance(node, ast.Await):
            return self.eval_expr(node.value, env)
        if isinstance(node, ast.NamedExpr):
            t = self.eval_expr(node.value, env)
            self._bind_target(node.target, t, env)
            return t
        if isinstance(node, ast.Lambda):
            return []
        return []

    def _eval_comp(self, node, env):
        inner = dict(env)
        iter_terms = []
        for gen in node.generators:
            it = self.eval_expr(gen.iter, inner)
            iter_terms.append(it)
            self._bind_target(gen.target, [["elem", it]] if it else [],
                              inner)
            for cond in gen.ifs:
                self.eval_expr(cond, inner)
        if isinstance(node, ast.DictComp):
            elt = _union(self.eval_expr(node.key, inner),
                         self.eval_expr(node.value, inner))
        else:
            elt = self.eval_expr(node.elt, inner)
        result = _union(elt, *iter_terms)
        if isinstance(node, ast.SetComp) and result:
            return [["san", ["fsorder"], result]]
        return result

    # ------------------------------------------------------------ calls

    def _eval_call(self, node, env):
        arg_terms = [self.eval_expr(a, env) for a in node.args]
        kw_terms = {kw.arg: self.eval_expr(kw.value, env)
                    for kw in node.keywords}
        all_args = _union(*(arg_terms + list(kw_terms.values())))
        lineno = node.lineno

        dotted = self.project.resolve_dotted(self.module, node.func)

        # A dotted chain rooted at a LOCAL value (``g.shuffle(...)``,
        # ``self._rng.uniform(...)``, a module-global generator) is a
        # method call on data, not a reference to an importable name —
        # resolve_dotted can't know that, so detect it here.
        base = node.func
        while isinstance(base, ast.Attribute):
            base = base.value
        local_receiver = (
            isinstance(node.func, ast.Attribute)
            and isinstance(base, ast.Name)
            and (base.id in env or base.id in self.module.global_assigns)
            and base.id not in self.module.aliases)
        fi = None
        if dotted is not None and not local_receiver:
            fi = self.project.resolve_function(self.module, dotted,
                                               cls=self.cls)
        if fi is None and dotted is not None and base is not node.func \
                and isinstance(base, ast.Name) and base.id == "self":
            # self.method() binds through the class even though ``self``
            # is also a local value.
            fi = self.project.resolve_function(self.module, dotted,
                                               cls=self.cls)
            local_receiver = fi is None

        # Publish sinks fire regardless of whether the publisher resolves
        # into the project (resilience.io) or not (fixtures, stubs). The
        # lease module is exempt: its "publishes" are the lease files
        # themselves (scheduling state under _leases/, not shard data),
        # and flagging them would make every legitimate lease operation a
        # caller-side finding.
        if dotted is not None and not local_receiver \
                and self.module.path != LEASE_MODULE:
            for suffix, positions in _PUBLISH_SINKS.items():
                if dotted == suffix or dotted.endswith("." + suffix):
                    for pos in positions:
                        t = arg_terms[pos] if pos < len(arg_terms) \
                            else None
                        if t:
                            self._sink(
                                KINDS,
                                "passed to {}() argument {} (published "
                                "into a shard directory)".format(suffix,
                                                                 pos),
                                node, t)
                    break

        # Raw-write effect sites (publish-path analysis).
        if self.facts is not None and dotted is not None \
                and not local_receiver:
            if dotted in _MOVE_FUNCS:
                self.facts.raw_writes.append(
                    {"op": "{}()".format(dotted), "lineno": lineno})
            elif dotted == "pyarrow.parquet.write_table":
                self.facts.raw_writes.append(
                    {"op": "pq.write_table()", "lineno": lineno})
            elif dotted == "open":
                mode = _open_write_mode(node)
                if mode is not None:
                    self.facts.raw_writes.append(
                        {"op": "open(mode={!r})".format(mode),
                         "lineno": lineno})

        # Project-resolved call: record the edge with per-param arg terms
        # (fi.node is None for cache-stub modules; the callee's facts come
        # from the cache, so the edge still resolves).
        if fi is not None:
            mapped = self._map_args(fi, node, arg_terms, kw_terms)
            if self.facts is not None:
                self.facts.calls.append({"callee": fi.qualname,
                                         "args": mapped, "lineno": lineno})
                if _is_deferred_call_module(fi.path):
                    # Writer-thread boundary: callables handed to the
                    # async sink run later on its thread — synthesize the
                    # deferred call edges here (see the module constant).
                    self._record_deferred_callables(node, env)
            return [["call", fi.qualname, mapped, lineno]]

        # Method call on a local/global value or unresolvable receiver.
        if isinstance(node.func, ast.Attribute) \
                and (local_receiver or dotted is None):
            recv = self.eval_expr(node.func.value, env)
            attr = node.func.attr
            if attr in DEFERRED_METHOD_NAMES and self.facts is not None:
                # Writer-thread/executor boundary: the enqueued callable
                # runs later — synthesize its call edge at the enqueue
                # site so deferred effects stay on the call graph.
                self._record_deferred_callables(node, env)
            if attr in _DRAW_METHODS:
                self._sink(["rng"],
                           "drawn from via .{}() — data shaped by an "
                           "unkeyed stream".format(attr), node, recv)
            if attr == "join":
                self._sink(["fsorder"], "joined into a string", node,
                           all_args)
            if attr == "format":
                self._sink(["fsorder"], "formatted into a string", node,
                           all_args)
            return [["ext", "." + attr, [_union(recv, all_args)]]] \
                if (recv or all_args) else []

        if dotted is None:
            # Dynamic callee (local variable holding a function, etc.).
            return [["ext", "<dynamic>", [all_args]]] if all_args else []

        # Taint sources.
        src = self._source_kind(dotted, node)
        if src is not None:
            return _union([_src(src, dotted, self.module.path, lineno)],
                          all_args)

        # Sanitizers (fsorder).
        if dotted in _FS_SANITIZERS:
            return [["san", ["fsorder"], all_args]] if all_args else []

        # Unresolved external call.
        return [["ext", dotted, [all_args]]] if all_args else []

    @staticmethod
    def _source_kind(dotted, node):
        if dotted in _WALLCLOCK_SOURCES:
            return "wallclock"
        if dotted in _FS_SOURCES:
            return "fsorder"
        if dotted.startswith("random."):
            attr = dotted.split(".", 1)[1]
            if attr in _PY_RANDOM_FUNCS or attr == "SystemRandom":
                return "rng"
            if attr == "Random" and not node.args and not node.keywords:
                return "rng"  # unseeded instance
        if dotted == "os.urandom":
            return "rng"
        if dotted.startswith("numpy.random."):
            attr = dotted.split(".", 2)[2]
            if attr in ("Generator", "Philox", "PCG64", "SeedSequence"):
                return None  # explicit keying building blocks
            if attr == "default_rng":
                if not node.args and not node.keywords:
                    return "rng"  # unkeyed
                return None  # keyed: determinism auditable at the site
            return "rng"  # module-level global-state draws
        return None

    def _record_deferred_callables(self, node, env):
        """Synthesize call edges for function-valued arguments at a
        deferred-execution boundary (the async sink's enqueue): a named
        project function reference becomes a zero-arg call edge, and a
        lambda argument's body is walked in place so ITS calls and raw
        writes attribute to the enclosing (enqueuing) function — either
        way the publish-path fixpoint sees through the queue."""
        for arg in list(node.args) + [kw.value for kw in node.keywords]:
            if isinstance(arg, ast.Lambda):
                inner = dict(env)
                a = arg.args
                for p in (a.posonlyargs + a.args + a.kwonlyargs):
                    inner[p.arg] = []
                self.eval_expr(arg.body, inner)
                continue
            if not isinstance(arg, (ast.Name, ast.Attribute)):
                continue
            dotted = self.project.resolve_dotted(self.module, arg)
            if dotted is None:
                continue
            fi = self.project.resolve_function(self.module, dotted,
                                               cls=self.cls)
            if fi is None:
                continue
            self.facts.calls.append({
                "callee": fi.qualname,
                "args": [None] * len(fi.params),
                "lineno": getattr(arg, "lineno", node.lineno)})

    def _map_args(self, fi, node, arg_terms, kw_terms):
        """Positional+keyword argument terms mapped onto the callee's
        parameter indices (None for params not passed). Bound-method calls
        (self.m(...) / obj.m(...)) shift past the self param."""
        mapped = [None] * len(fi.params)
        offset = 0
        if fi.cls is not None and fi.params[:1] == ["self"] \
                and isinstance(node.func, ast.Attribute):
            offset = 1
        for i, t in enumerate(arg_terms):
            j = i + offset
            if j < len(mapped):
                mapped[j] = t
        for name, t in kw_terms.items():
            if name in fi.params:
                mapped[fi.params.index(name)] = t
        return mapped

    # ------------------------------------------------------------- sinks

    def _sink(self, kinds, what, node, term):
        if self.facts is None or not term:
            return
        self.facts.sinks.append({"kinds": list(kinds), "what": what,
                                 "lineno": getattr(node, "lineno",
                                                   self.facts.lineno),
                                 "term": term})


# ------------------------------------------------------------- evaluation


class Summary(object):
    """Per-function, per-kind fixpoint state."""

    __slots__ = ("ret_srcs", "ret_params", "sink_params")

    def __init__(self):
        # kind -> frozenset of (name, path, lineno) source descriptors
        self.ret_srcs = {k: frozenset() for k in KINDS}
        # kind -> frozenset of param indices passed through to the return
        self.ret_params = {k: frozenset() for k in KINDS}
        # kind -> {param index: "what" description}
        self.sink_params = {k: {} for k in KINDS}

    def state(self):
        return (tuple(sorted((k, tuple(sorted(v)))
                             for k, v in self.ret_srcs.items())),
                tuple(sorted((k, tuple(sorted(v)))
                             for k, v in self.ret_params.items())),
                tuple(sorted((k, tuple(sorted(v.items())))
                             for k, v in self.sink_params.items())))


class _Taint(object):
    """One concrete taint reaching a point: a source descriptor plus
    whether it crossed a function/global boundary and through what."""

    __slots__ = ("name", "path", "lineno", "crossed", "via")

    def __init__(self, name, path, lineno, crossed, via):
        self.name = name
        self.path = path
        self.lineno = lineno
        self.crossed = crossed
        self.via = via  # qualname of the immediate boundary, or None

    def key(self):
        return (self.name, self.path, self.lineno)


class FlowResult(object):
    """Engine output: findings per rule id plus summaries for tests."""

    def __init__(self):
        self.findings = []  # [(rule_id, path, lineno, message)]
        self.summaries = {}


class Engine(object):
    """Phase B: fixpoint over function summaries, then finding emission."""

    def __init__(self, module_facts, max_iters=50):
        self.modules = {mf.modname: mf for mf in module_facts}
        self.functions = {}
        for mf in module_facts:
            for ff in mf.functions:
                self.functions[ff.qualname] = ff
        self.summaries = {q: Summary() for q in self.functions}
        self.max_iters = max_iters
        # publish-path effect: qualname -> (desc, path, lineno, via) | None
        self.raw_write_of = {}

    # -------------------------------------------------------- term eval

    def eval_term(self, term, kind, owner, _globals_seen=None):
        """Concrete taints (set of _Taint) and pass-through param indices
        carried by ``term`` for ``kind``, evaluated inside function facts
        ``owner`` under the current summaries."""
        out = {}
        params = set()

        def merge(sub, sp):
            out.update({t.key() + (t.crossed,): t for t in sub})
            params.update(sp)

        for atom in term:
            tag = atom[0]
            if tag == "src":
                if atom[1] == kind:
                    t = _Taint(atom[2], atom[3], atom[4], False, None)
                    out[t.key() + (t.crossed,)] = t
            elif tag == "param":
                params.add(atom[1])
            elif tag == "san":
                if kind not in atom[1]:
                    merge(*self.eval_term(atom[2], kind, owner,
                                          _globals_seen))
            elif tag == "elem":
                if kind != "fsorder":
                    merge(*self.eval_term(atom[1], kind, owner,
                                          _globals_seen))
            elif tag == "ext":
                if kind == "fsorder" and atom[1] not in _ORDER_PRESERVING \
                        and not atom[1].startswith("."):
                    continue
                for sub_term in atom[2]:
                    merge(*self.eval_term(sub_term, kind, owner,
                                          _globals_seen))
            elif tag == "global":
                mf = self.modules.get(atom[1])
                if mf is None:
                    continue
                seen = _globals_seen or set()
                gkey = (atom[1], atom[2])
                if gkey in seen:
                    continue
                gterm = mf.globals.get(atom[2])
                if gterm:
                    sub, sp = self.eval_term(gterm, kind, owner,
                                             seen | {gkey})
                    for t in sub:
                        # Module-global state crosses a scope boundary.
                        ct = _Taint(t.name, t.path, t.lineno, True,
                                    "module global {}".format(atom[2]))
                        out[ct.key() + (True,)] = ct
                    params |= sp
            elif tag == "call":
                callee, args = atom[1], atom[2]
                if kind == "lease":
                    callee_ff = self.functions.get(callee)
                    if callee_ff is not None \
                            and callee_ff.path == LEASE_MODULE:
                        # Synthesized source: anything returned by the
                        # lease module IS lease state. Crossing is true by
                        # construction (the value came out of leases.py).
                        t = _Taint(callee.split(".")[-1], callee_ff.path,
                                   atom[3], True, callee)
                        out[t.key() + (True,)] = t
                summ = self.summaries.get(callee)
                if summ is None:
                    for sub_term in args:
                        if sub_term is not None:
                            merge(*self.eval_term(sub_term, kind, owner,
                                                  _globals_seen))
                    continue
                for (name, path, ln) in summ.ret_srcs[kind]:
                    t = _Taint(name, path, ln, True, callee)
                    out[t.key() + (True,)] = t
                for j in summ.ret_params[kind]:
                    if j < len(args) and args[j] is not None:
                        sub, sp = self.eval_term(args[j], kind, owner,
                                                 _globals_seen)
                        for t in sub:
                            ct = _Taint(t.name, t.path, t.lineno, True,
                                        callee)
                            out[ct.key() + (True,)] = ct
                        params |= sp
        return set(out.values()), params

    def _emit_sink_param_findings(self, callee, args, lineno, kind, owner,
                                  emit):
        summ = self.summaries.get(callee)
        if summ is None:
            return
        for j, what in sorted(summ.sink_params[kind].items()):
            if j >= len(args) or args[j] is None:
                continue
            taints, _ = self.eval_term(args[j], kind, owner)
            for t in sorted(taints, key=lambda t: t.key()):
                emit(kind, owner.path, lineno,
                     "{src} ({spath}:{sline}) is passed into {callee}(), "
                     "where it is {what}".format(
                         src=t.name, spath=t.path, sline=t.lineno,
                         callee=callee.split(".")[-1], what=what))

    # ---------------------------------------------------------- fixpoint

    def solve(self):
        for _ in range(self.max_iters):
            changed = False
            for qual in sorted(self.functions):
                ff = self.functions[qual]
                summ = self.summaries[qual]
                before = summ.state()
                self._update_summary(ff, summ)
                if summ.state() != before:
                    changed = True
            if not changed:
                break

    def _update_summary(self, ff, summ):
        for kind in KINDS:
            taints, params = self.eval_term(ff.returns, kind, ff)
            summ.ret_srcs[kind] = summ.ret_srcs[kind] | {
                (t.name, t.path, t.lineno) for t in taints}
            summ.ret_params[kind] = summ.ret_params[kind] | params
            for sink in ff.sinks:
                if kind not in sink["kinds"]:
                    continue
                _, sp = self.eval_term(sink["term"], kind, ff)
                for j in sp:
                    summ.sink_params[kind].setdefault(j, sink["what"])
            # Transitive: an arg forwarded into a callee's sink param.
            for call in ff.calls:
                callee = self.summaries.get(call["callee"])
                if callee is None:
                    continue
                for j, what in callee.sink_params[kind].items():
                    if j >= len(call["args"]) or call["args"][j] is None:
                        continue
                    _, sp = self.eval_term(call["args"][j], kind, ff)
                    for i in sp:
                        summ.sink_params[kind].setdefault(
                            i, "{} (via {}())".format(
                                what, call["callee"].split(".")[-1]))

    # -------------------------------------------------- publish-path pass

    def solve_publish(self, source_ok, sanctioned):
        """Effect fixpoint: ``raw_write_of[qualname]`` = (op, path,
        lineno, via-or-None) for every function that transitively performs
        a raw write. ``source_ok(path)`` gates which files' local writes
        count (shard-package writes are the syntactic rule's job);
        ``sanctioned(path)`` names the atomic-publisher module(s) that
        never propagate the effect."""
        raw = {}
        for qual, ff in self.functions.items():
            if ff.raw_writes and source_ok(ff.path) \
                    and not sanctioned(ff.path):
                w = min(ff.raw_writes, key=lambda w: w["lineno"])
                raw[qual] = (w["op"], ff.path, w["lineno"], None)
        for _ in range(self.max_iters):
            changed = False
            for qual in sorted(self.functions):
                if qual in raw:
                    continue
                ff = self.functions[qual]
                if sanctioned(ff.path):
                    continue
                for call in ff.calls:
                    hit = raw.get(call["callee"])
                    if hit is None:
                        continue
                    callee_ff = self.functions.get(call["callee"])
                    if callee_ff is not None \
                            and sanctioned(callee_ff.path):
                        continue
                    raw[qual] = (hit[0], hit[1], hit[2], call["callee"])
                    changed = True
                    break
            if not changed:
                break
        self.raw_write_of = raw

    # ---------------------------------------------------------- findings

    def emit_findings(self, shard_pkg, sanctioned):
        """All flow findings: [(rule_id, path, lineno, message)].

        Value-taint findings fire at sinks whose taint crossed a
        boundary; publish-path findings fire at shard-package call sites
        whose callee (defined OUTSIDE the shard packages, where the
        syntactic atomic-publish rule cannot see) transitively raw-writes.
        """
        findings = []

        def emit(kind, path, lineno, message):
            findings.append((RULE_ID_OF_KIND[kind], path, lineno, message))

        for qual in sorted(self.functions):
            ff = self.functions[qual]
            for kind in KINDS:
                for sink in ff.sinks:
                    if kind not in sink["kinds"]:
                        continue
                    taints, _ = self.eval_term(sink["term"], kind, ff)
                    for t in sorted(taints, key=lambda t: t.key()):
                        if not t.crossed:
                            continue  # same-function: syntactic territory
                        if not t.via:
                            via = ""
                        elif "." in t.via:
                            via = " via {}()".format(t.via.split(".")[-1])
                        else:
                            via = " via {}".format(t.via)
                        emit(kind, ff.path, sink["lineno"],
                             "{src} ({spath}:{sline}){via} is {what}; "
                             "this value must not shape pipeline output"
                             .format(src=t.name, spath=t.path,
                                     sline=t.lineno, via=via,
                                     what=sink["what"]))
                # Call-site findings: tainted args into callee sink params.
                for call in ff.calls:
                    self._emit_sink_param_findings(
                        call["callee"], call["args"], call["lineno"],
                        kind, ff, emit)

            # publish-path-flow
            if shard_pkg(ff.path):
                for call in ff.calls:
                    hit = self.raw_write_of.get(call["callee"])
                    if hit is None:
                        continue
                    callee_ff = self.functions.get(call["callee"])
                    if callee_ff is None or shard_pkg(callee_ff.path):
                        continue  # syntactic atomic-publish territory
                    op, wpath, wline, via = hit
                    chain = "" if via is None else \
                        " (via {}())".format(via.split(".")[-1])
                    findings.append((
                        PUBLISH_PATH_RULE, ff.path, call["lineno"],
                        "call into {callee}(){chain} reaches a raw "
                        "{op} at {wpath}:{wline} without passing through "
                        "resilience.io; a crash there can publish a torn "
                        "file into a shard directory".format(
                            callee=call["callee"].split(".")[-1],
                            chain=chain, op=op, wpath=wpath,
                            wline=wline)))
        # Deterministic order + dedup (the same flow can be reached
        # through several call chains).
        seen = set()
        unique = []
        for f in sorted(findings, key=lambda f: (f[1], f[2], f[0], f[3])):
            key = (f[0], f[1], f[2])
            if key not in seen:
                seen.add(key)
                unique.append(f)
        return unique


def analyze_modules(module_facts, shard_pkg, publish_source_ok,
                    sanctioned):
    """Run phase B over extracted module facts. Returns a FlowResult."""
    engine = Engine(module_facts)
    engine.solve()
    engine.solve_publish(publish_source_ok, sanctioned)
    result = FlowResult()
    result.findings = engine.emit_findings(shard_pkg, sanctioned)
    result.summaries = engine.summaries
    return result
