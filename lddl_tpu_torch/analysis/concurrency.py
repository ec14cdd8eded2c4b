"""Concurrency invariant analysis: thread escape, lock discipline,
signal safety, and env-read-after-spawn.

Counterpart of ``lddl_tpu/analysis/concurrency.py`` with its path
scopes on ``lddl_tpu_torch/``. The pipeline's byte-identity contract
(identical shards regardless of worker/thread count) rests on a small
set of concurrency invariants: shared mutable state
crossing a thread boundary is lock-guarded, signal handlers only touch
reentrant locks and never block, and worker configuration is pinned
BEFORE the pool spawns. This module machine-checks them, reusing the
:mod:`.project` model and the phase-A/phase-B split of :mod:`.dataflow`:

- **Phase A** (:func:`extract_module_facts`) walks each parsed module
  once and records serializable per-function facts — module-global
  writes with the lexically-held locks, lock acquisitions and their
  nesting, resolved calls, thread-boundary hand-offs
  (``threading.Thread(target=...)``, ``.submit(fn)``), signal-handler
  registrations, pool/thread spawn points, and ``LDDL_TPU_*`` env reads.
  Nested functions and lambdas become pseudo-functions
  (``outer.<locals>.inner``) so a handler or thread target defined
  inline is its own call-graph node. Facts ride the content-hash cache
  exactly like dataflow facts.
- **Phase B** (:func:`run_concurrency_analysis`) builds the whole-tree
  call graph from the facts and emits findings for the four rules
  below. Findings route through ``core.run_check`` so ``allow`` lists,
  inline suppressions, ``--rules`` filters, and the baseline all apply.

Rules:

- ``thread-escape`` — a mutable module global written on both sides of
  a thread boundary with at least one write not under a recognized
  lock. "Recognized" is lexical ``with <lock>:`` plus a must-hold
  entry-lock analysis (a helper only ever called under the lock counts
  as guarded), and mutation THROUGH a parameter is tracked (passing the
  global to a helper that mutates its argument unlocked is a write).
- ``lock-order`` — two locks acquired in both orders on some pair of
  call paths (the classic AB/BA deadlock), or a non-reentrant
  ``threading.Lock`` re-acquired while already held.
- ``signal-safety`` — from every ``signal.signal(...)``-registered
  handler: acquiring a non-reentrant ``threading.Lock`` (a handler
  that interrupts its own holder deadlocks; the telemetry registries
  use RLock for this reason), or a
  blocking call (write-mode ``open``, ``queue.put`` without timeout,
  zero-arg ``.join()``, ``time.sleep``) on the handler path. The
  observability package's flush-on-TERM file writes are sanctioned at
  the engine level (flushing IS the handler's purpose; every frame is
  wrapped in best-effort try/except) — the non-reentrant-lock class is
  never sanctioned.
- ``env-read-after-spawn`` — an ``LDDL_TPU_*`` env read that happens
  after a process-pool spawn point on the same call path (workers
  snapshot the env at spawn, so late reads silently desynchronize
  parent and worker configuration; the preprocess runner sizes its
  pools before spawning for this reason). Plain-thread spawns only arm the
  same-function window: threads share the live environ, so only the
  tight spawn-then-read pattern is suspicious there. Reads inside
  observability/faults are exempt sources (telemetry gating reads env
  by design, once per hook).
"""

import ast

from .core import Rule, register

# Modules whose env reads are NOT env-read-after-spawn sources: the
# telemetry/faults gates read their own env switches on every hook by
# design (one lookup when disabled — the inertness contract), and none
# of those switches configure spawned workers.
ENV_SOURCE_EXEMPT_PREFIXES = ("lddl_tpu_torch/observability/",
                              "lddl_tpu_torch/resilience/faults.py")

# Blocking-call findings (signal-safety) are sanctioned on the
# flush-on-SIGTERM write machinery: the observability package (flushing
# IS the handler path's purpose and every frame is best-effort
# try/except), resilience/io.py (the atomic_write/open_append layer
# those flushes go through — its fsync/replace/retry-sleep ARE the
# sanctioned write), and resilience/faults.py (the test-only injection
# layer whose injected sleeps/write-errors trace the same hooks). Lock
# findings are never sanctioned — a non-reentrant lock deadlocks no
# matter how careful the I/O around it is.
SIGNAL_BLOCKING_SANCTIONED_PREFIXES = ("lddl_tpu_torch/observability/",
                                       "lddl_tpu_torch/resilience/io.py",
                                       "lddl_tpu_torch/resilience/faults.py")

_LOCK_CTORS = {
    "threading.Lock": "Lock",
    "threading.RLock": "RLock",
    "threading.Condition": "Condition",
    "threading.Semaphore": "Semaphore",
    "threading.BoundedSemaphore": "Semaphore",
    "multiprocessing.Lock": "Lock",
    "multiprocessing.RLock": "RLock",
}

_MUTABLE_CTORS = frozenset({
    "dict", "list", "set", "bytearray",
    "collections.defaultdict", "collections.deque",
    "collections.OrderedDict", "collections.Counter",
})

# Container methods that mutate their receiver in place.
_MUTATING_METHODS = frozenset({
    "append", "extend", "insert", "remove", "pop", "clear", "update",
    "setdefault", "add", "discard", "popitem", "appendleft", "extendleft",
    "rotate", "sort", "reverse",
})

_THREAD_CTORS = frozenset({"threading.Thread", "threading.Timer"})

_POOL_CTORS = frozenset({
    "concurrent.futures.ProcessPoolExecutor",
    "concurrent.futures.process.ProcessPoolExecutor",
    "multiprocessing.Pool",
    "multiprocessing.pool.Pool",
})

# Thread-pool executors spawn threads, not processes: they arm the
# boundary for thread-escape (via .submit) but not the env-snapshot
# hazard.
_THREAD_POOL_CTORS = frozenset({
    "concurrent.futures.ThreadPoolExecutor",
    "concurrent.futures.thread.ThreadPoolExecutor",
})

# Callable-handoff method names that cross a thread boundary: the
# stdlib executors' and the async sink's submit (dataflow treats sink
# submits the same way — DEFERRED_METHOD_NAMES).
_SUBMIT_METHODS = frozenset({"submit"})

_ENV_READ_FUNCS = frozenset({"os.environ.get", "os.getenv",
                             "os.environ.setdefault"})

_BLOCKING_FUNCS = frozenset({"time.sleep", "os.replace", "os.rename",
                             "os.fsync", "shutil.move"})


# --------------------------------------------------------------- facts


class _CFuncFacts(object):
    """Serializable phase-A concurrency record for one function (or one
    nested pseudo-function)."""

    __slots__ = ("qualname", "name", "cls", "path", "lineno",
                 "writes", "param_writes", "acquires", "calls",
                 "spawns", "env_reads", "thread_targets",
                 "signal_handlers", "blocking")

    def __init__(self, qualname, name, cls, path, lineno):
        self.qualname = qualname
        self.name = name
        self.cls = cls
        self.path = path
        self.lineno = lineno
        # [{"g": global id, "lineno": int, "held": [lock ids]}]
        self.writes = []
        # [{"i": param index, "lineno": int, "held": [lock ids]}]
        self.param_writes = []
        # [{"lock": lock id, "lineno": int, "held": [outer lock ids]}]
        self.acquires = []
        # [{"callee": qualname or None, "dotted": str or None,
        #   "lineno": int, "held": [...], "args_globals": {str(i): gid}}]
        self.calls = []
        # [{"kind": "pool"|"thread", "lineno": int}]
        self.spawns = []
        # [{"name": env var, "lineno": int}]
        self.env_reads = []
        self.thread_targets = []  # [{"target": qualname, "lineno": int}]
        self.signal_handlers = []  # [{"target": qualname, "lineno": int}]
        # [{"what": str, "lineno": int}]
        self.blocking = []

    def to_dict(self):
        return {k: getattr(self, k) for k in self.__slots__}

    @classmethod
    def from_dict(cls, d):
        ff = cls(d["qualname"], d["name"], d["cls"], d["path"],
                 d["lineno"])
        for k in ("writes", "param_writes", "acquires", "calls", "spawns",
                  "env_reads", "thread_targets", "signal_handlers",
                  "blocking"):
            setattr(ff, k, d[k])
        return ff


class _CModuleFacts(object):
    """Phase-A concurrency facts for one module."""

    def __init__(self, path, modname):
        self.path = path
        self.modname = modname
        self.functions = []  # [_CFuncFacts]
        # global name -> {"lineno": int, "mutable": bool}
        self.globals = {}
        # lock id ("mod.name" or "mod.Cls.attr") -> kind ("Lock"/"RLock"/..)
        self.locks = {}

    def to_dict(self):
        return {"path": self.path, "modname": self.modname,
                "functions": [f.to_dict() for f in self.functions],
                "globals": self.globals, "locks": self.locks}

    @classmethod
    def from_dict(cls, d):
        mf = cls(d["path"], d["modname"])
        mf.functions = [_CFuncFacts.from_dict(f) for f in d["functions"]]
        mf.globals = d["globals"]
        mf.locks = d["locks"]
        return mf


# ---------------------------------------------------------- extraction


def _is_mutable_init(module, project, value):
    if isinstance(value, (ast.Dict, ast.List, ast.Set, ast.DictComp,
                          ast.ListComp, ast.SetComp)):
        return True
    if isinstance(value, ast.Call):
        dotted = project.resolve_dotted(module, value.func)
        return dotted in _MUTABLE_CTORS
    return False


def extract_module_facts(project, module):
    """Phase A for one module: concurrency facts for every function
    (methods and nested defs included) plus the module's mutable-global
    and lock registries."""
    mf = _CModuleFacts(module.path, module.modname)

    for name, value in sorted(module.global_assigns.items()):
        dotted = None
        if isinstance(value, ast.Call):
            dotted = project.resolve_dotted(module, value.func)
        if dotted in _LOCK_CTORS:
            mf.locks["{}.{}".format(module.modname, name)] = \
                _LOCK_CTORS[dotted]
            continue
        mf.globals[name] = {
            "lineno": value.lineno,
            "mutable": _is_mutable_init(module, project, value),
        }

    # Instance locks: ``self.attr = threading.Lock()`` anywhere in a
    # class's methods registers "mod.Cls.attr" so ``with self.attr:``
    # resolves in every method of the class.
    for local in sorted(module.functions):
        fi = module.functions[local]
        if fi.cls is None or fi.node is None:
            continue
        for node in ast.walk(fi.node):
            if not (isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Call)):
                continue
            dotted = project.resolve_dotted(module, node.value.func)
            if dotted not in _LOCK_CTORS:
                continue
            for tgt in node.targets:
                if (isinstance(tgt, ast.Attribute)
                        and isinstance(tgt.value, ast.Name)
                        and tgt.value.id == "self"):
                    lock_id = "{}.{}.{}".format(module.modname, fi.cls,
                                                tgt.attr)
                    mf.locks[lock_id] = _LOCK_CTORS[dotted]

    for local in sorted(module.functions):
        fi = module.functions[local]
        _extract_function(project, module, mf, fi.node, fi.qualname,
                          fi.name, fi.cls,
                          [a.arg for a in (fi.node.args.posonlyargs
                                           + fi.node.args.args)])
    return mf


def _extract_function(project, module, mf, node, qualname, name, cls,
                      params):
    ff = _CFuncFacts(qualname, name, cls, module.path, node.lineno)
    mf.functions.append(ff)
    ex = _CExtractor(project, module, mf, ff, cls, params)
    body = node.body if isinstance(node, (ast.FunctionDef,
                                          ast.AsyncFunctionDef)) \
        else [ast.Expr(value=node.body)]  # lambda
    ex.run_body(body, held=())
    # Nested defs/lambdas become their own pseudo-functions AFTER the
    # parent walk (the walk recorded the call/hand-off edges to them).
    for child, child_name, child_params in ex.nested:
        _extract_function(project, module, mf, child,
                          "{}.<locals>.{}".format(qualname, child_name),
                          child_name, cls, child_params)


class _CExtractor(object):
    """One pass over a function body collecting concurrency events.

    Tracks the lexically-held lock set through ``with`` statements and a
    local-shadow set so a plain local named like a module global is not
    miscounted as a global write."""

    def __init__(self, project, module, mf, facts, cls, params):
        self.project = project
        self.module = module
        self.mf = mf
        self.facts = facts
        self.cls = cls
        self.params = list(params)
        self.globals_decl = set()
        self.local_shadow = set(params)
        self.nested = []  # [(ast node, pseudo name, params)]
        self._nested_names = {}  # local name -> pseudo qualname
        self._lambda_n = 0

    # ----------------------------------------------------- resolution

    def _pseudo_qual(self, child_name):
        return "{}.<locals>.{}".format(self.facts.qualname, child_name)

    def resolve_dotted(self, expr):
        return self.project.resolve_dotted(self.module, expr)

    def global_id_of(self, expr):
        """Absolute id of the module-global an expression names, or
        None. Bare names resolve against THIS module (minus local
        shadows); dotted names resolve through import aliases so
        ``fleet._hb`` from another module and ``_hb`` inside fleet.py
        produce the same id."""
        if isinstance(expr, ast.Name):
            n = expr.id
            if n in self.local_shadow and n not in self.globals_decl:
                return None
            if n in self.mf.globals or n in self.globals_decl:
                return "{}.{}".format(self.module.modname, n)
            return None
        if isinstance(expr, ast.Attribute):
            if isinstance(expr.value, ast.Name) \
                    and expr.value.id in self.local_shadow:
                return None
            return self.resolve_dotted(expr)
        return None

    def lock_id_of(self, expr):
        """Lock id a ``with``-subject names, or None: a module-global
        lock (here or in an imported module) or ``self.<attr>`` matching
        a registered instance lock of the enclosing class."""
        if isinstance(expr, ast.Attribute) \
                and isinstance(expr.value, ast.Name) \
                and expr.value.id == "self" and self.cls is not None:
            return "{}.{}.{}".format(self.module.modname, self.cls,
                                     expr.attr)
        dotted = self.resolve_dotted(expr)
        if dotted is None:
            return None
        if isinstance(expr, ast.Name):
            if expr.id in self.local_shadow:
                return None
            return "{}.{}".format(self.module.modname, expr.id)
        return dotted

    def callable_qual_of(self, expr):
        """Project-function qualname for a callable reference: a nested
        def/lambda in this function, a module function, ``self.method``,
        or a cross-module dotted name."""
        if isinstance(expr, ast.Lambda):
            self._lambda_n += 1
            child_name = "<lambda:{}>".format(expr.lineno)
            self.nested.append(
                (expr, child_name,
                 [a.arg for a in (expr.args.posonlyargs
                                  + expr.args.args)]))
            return self._pseudo_qual(child_name)
        if isinstance(expr, ast.Name) and expr.id in self._nested_names:
            return self._nested_names[expr.id]
        dotted = self.resolve_dotted(expr)
        fi = self.project.resolve_function(self.module, dotted,
                                           cls=self.cls)
        if fi is not None:
            return fi.qualname
        return None

    # ------------------------------------------------------ statements

    def run_body(self, stmts, held):
        for stmt in stmts:
            self.run_stmt(stmt, held)

    def run_stmt(self, stmt, held):
        if isinstance(stmt, ast.Global):
            self.globals_decl.update(stmt.names)
        elif isinstance(stmt, ast.Assign):
            self.visit_expr(stmt.value, held)
            for tgt in stmt.targets:
                self._bind_target(tgt, held)
        elif isinstance(stmt, ast.AnnAssign):
            if stmt.value is not None:
                self.visit_expr(stmt.value, held)
            self._bind_target(stmt.target, held)
        elif isinstance(stmt, ast.AugAssign):
            self.visit_expr(stmt.value, held)
            self._write_target(stmt.target, held)
        elif isinstance(stmt, ast.Delete):
            for tgt in stmt.targets:
                if isinstance(tgt, ast.Subscript):
                    self._write_target(tgt, held)
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            inner = list(held)
            for item in stmt.items:
                lock = self.lock_id_of(item.context_expr)
                if lock is not None and self._is_known_lockish(lock,
                                                              item):
                    self.facts.acquires.append(
                        {"lock": lock, "lineno": item.context_expr.lineno,
                         "held": list(inner)})
                    inner.append(lock)
                else:
                    self.visit_expr(item.context_expr, held)
            self.run_body(stmt.body, tuple(inner))
        elif isinstance(stmt, (ast.For, ast.AsyncFor)):
            self.visit_expr(stmt.iter, held)
            self._bind_target(stmt.target, held)
            self.run_body(stmt.body, held)
            self.run_body(stmt.orelse, held)
        elif isinstance(stmt, ast.While):
            self.visit_expr(stmt.test, held)
            self.run_body(stmt.body, held)
            self.run_body(stmt.orelse, held)
        elif isinstance(stmt, ast.If):
            self.visit_expr(stmt.test, held)
            self.run_body(stmt.body, held)
            self.run_body(stmt.orelse, held)
        elif isinstance(stmt, ast.Try):
            self.run_body(stmt.body, held)
            for h in stmt.handlers:
                self.run_body(h.body, held)
            self.run_body(stmt.orelse, held)
            self.run_body(stmt.finalbody, held)
        elif isinstance(stmt, (ast.Return, ast.Expr, ast.Assert,
                               ast.Raise)):
            for child in ast.iter_child_nodes(stmt):
                if isinstance(child, ast.expr):
                    self.visit_expr(child, held)
        elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            child_name = stmt.name
            self._nested_names[child_name] = self._pseudo_qual(child_name)
            self.local_shadow.add(child_name)
            self.nested.append(
                (stmt, child_name,
                 [a.arg for a in (stmt.args.posonlyargs
                                  + stmt.args.args)]))
        # ClassDef / imports / pass / break / continue: nothing to do.

    def _is_known_lockish(self, lock_id, item):
        """Accept a with-subject as a lock acquisition when it matches a
        registered lock OR looks like one by name ('lock'/'mutex' in the
        last segment) — cross-module instance locks are invisible to the
        registry, and treating a non-lock context manager as a lock only
        ever SUPPRESSES findings for code that is in fact serialized."""
        if lock_id in self.mf.locks:
            return True
        last = lock_id.rsplit(".", 1)[-1].lower()
        return "lock" in last or "mutex" in last

    def _bind_target(self, tgt, held):
        """Assignment target: plain names become local shadows; writes
        through subscripts/attributes on globals are global writes."""
        if isinstance(tgt, ast.Name):
            if tgt.id in self.globals_decl:
                self._record_write("{}.{}".format(self.module.modname,
                                                  tgt.id),
                                   tgt.lineno, held)
            else:
                self.local_shadow.add(tgt.id)
        elif isinstance(tgt, (ast.Tuple, ast.List)):
            for el in tgt.elts:
                self._bind_target(el, held)
        elif isinstance(tgt, ast.Starred):
            self._bind_target(tgt.value, held)
        elif isinstance(tgt, (ast.Subscript, ast.Attribute)):
            self._write_target(tgt, held)

    def _write_target(self, tgt, held):
        """A mutation through ``X[...] =`` / ``X.attr = `` / ``X += ``:
        a global write when the mutated container X resolves to a
        module global (bare or dotted, e.g. ``state.CACHE["x"]``), a
        param write when its base names a parameter."""
        if isinstance(tgt, ast.Name):
            gid = self.global_id_of(tgt)
            if gid is not None:
                self._record_write(gid, tgt.lineno, held)
            return
        # Peel subscripts: ``state.CACHE["x"]["y"]`` mutates the
        # container ``state.CACHE``; a top-level attribute assignment
        # ``obj.attr = v`` mutates ``obj``.
        container = tgt
        while isinstance(container, ast.Subscript):
            self.visit_expr(container.slice, held)
            container = container.value
        if container is tgt and isinstance(container, ast.Attribute):
            container = container.value
        base = container
        while isinstance(base, ast.Attribute):
            base = base.value
        if isinstance(base, ast.Name) and base.id in self.params \
                and base.id not in self.globals_decl:
            self.facts.param_writes.append(
                {"i": self.params.index(base.id), "lineno": tgt.lineno,
                 "held": list(held)})
            return
        gid = self.global_id_of(container)
        if gid is not None:
            self._record_write(gid, tgt.lineno, held)

    def _record_write(self, gid, lineno, held):
        self.facts.writes.append({"g": gid, "lineno": lineno,
                                  "held": list(held)})

    # ----------------------------------------------------- expressions

    def visit_expr(self, node, held):
        if node is None or isinstance(node, ast.Constant):
            return
        if isinstance(node, ast.Call):
            self.visit_call(node, held)
            return
        if isinstance(node, ast.Lambda):
            # A lambda not handed anywhere recognizable: still extract
            # it so its effects exist if a later pass learns the edge.
            self.callable_qual_of(node)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.expr, ast.comprehension)):
                self.visit_expr(child, held)
            elif isinstance(child, ast.expr_context):
                continue
        if isinstance(node, ast.comprehension):
            return
        # Subscript READS of os.environ["LDDL_TPU_X"].
        if isinstance(node, ast.Subscript) \
                and isinstance(node.ctx, ast.Load):
            dotted = self.resolve_dotted(node.value)
            if dotted == "os.environ":
                self._env_read(node.slice, node.lineno)

    def _env_read(self, key_node, lineno):
        key = key_node
        if isinstance(key, ast.Constant) and isinstance(key.value, str) \
                and key.value.startswith("LDDL_TPU_"):
            self.facts.env_reads.append({"name": key.value,
                                         "lineno": lineno})

    def visit_call(self, node, held):
        dotted = self.resolve_dotted(node.func)

        # Env reads: os.environ.get/setdefault, os.getenv.
        if dotted in _ENV_READ_FUNCS and node.args:
            self._env_read(node.args[0], node.lineno)

        # Spawn points.
        if dotted in _POOL_CTORS:
            self.facts.spawns.append({"kind": "pool",
                                      "lineno": node.lineno})
        elif dotted in _THREAD_CTORS or dotted in _THREAD_POOL_CTORS:
            self.facts.spawns.append({"kind": "thread",
                                      "lineno": node.lineno})

        # Thread boundary hand-offs: Thread(target=f) and .submit(f).
        if dotted in _THREAD_CTORS:
            for kw in node.keywords:
                if kw.arg == "target":
                    qual = self.callable_qual_of(kw.value)
                    if qual is not None:
                        self.facts.thread_targets.append(
                            {"target": qual, "lineno": node.lineno})
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr in _SUBMIT_METHODS and node.args:
            qual = self.callable_qual_of(node.args[0])
            if qual is not None:
                self.facts.thread_targets.append(
                    {"target": qual, "lineno": node.lineno})

        # Signal-handler registration.
        if dotted == "signal.signal" and len(node.args) >= 2:
            qual = self.callable_qual_of(node.args[1])
            if qual is not None:
                self.facts.signal_handlers.append(
                    {"target": qual, "lineno": node.lineno})

        # Blocking operations (consumed by signal-safety).
        if dotted in _BLOCKING_FUNCS:
            self.facts.blocking.append({"what": dotted + "()",
                                        "lineno": node.lineno})
        elif dotted == "open":
            mode = None
            if len(node.args) >= 2:
                mode = node.args[1]
            for kw in node.keywords:
                if kw.arg == "mode":
                    mode = kw.value
            if isinstance(mode, ast.Constant) \
                    and isinstance(mode.value, str) \
                    and any(c in mode.value for c in "wax+"):
                self.facts.blocking.append(
                    {"what": "write-mode open()", "lineno": node.lineno})
        elif isinstance(node.func, ast.Attribute):
            attr = node.func.attr
            if attr == "put" \
                    and not any(kw.arg == "timeout"
                                for kw in node.keywords) \
                    and not (len(node.args) >= 3):
                self.facts.blocking.append(
                    {"what": ".put() without timeout",
                     "lineno": node.lineno})
            elif attr == "join" and not node.args and not node.keywords:
                self.facts.blocking.append(
                    {"what": "zero-arg .join()", "lineno": node.lineno})

        # In-place mutation through a container method on a global.
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr in _MUTATING_METHODS:
            gid = self.global_id_of(node.func.value)
            if gid is not None:
                self._record_write(gid, node.lineno, held)

        # The call edge itself, with globals-as-arguments recorded so
        # phase B can see mutation through parameters.
        callee = None
        if isinstance(node.func, ast.Name) \
                and node.func.id in self._nested_names:
            callee = self._nested_names[node.func.id]
        else:
            fi = self.project.resolve_function(self.module, dotted,
                                               cls=self.cls)
            if fi is not None:
                callee = fi.qualname
        args_globals = {}
        for i, arg in enumerate(node.args):
            if isinstance(arg, (ast.Name, ast.Attribute)):
                gid = self.global_id_of(arg)
                if gid is not None:
                    args_globals[str(i)] = gid
        if callee is not None or args_globals:
            self.facts.calls.append(
                {"callee": callee, "dotted": dotted,
                 "lineno": node.lineno, "held": list(held),
                 "args_globals": args_globals})

        # Recurse into arguments (skip the callable we already routed
        # to a pseudo-function, so a lambda body is not double-counted
        # in the parent).
        routed = set()
        if dotted in _THREAD_CTORS:
            routed.update(id(kw.value) for kw in node.keywords
                          if kw.arg == "target")
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr in _SUBMIT_METHODS and node.args:
            routed.add(id(node.args[0]))
        if dotted == "signal.signal" and len(node.args) >= 2:
            routed.add(id(node.args[1]))
        if isinstance(node.func, ast.Attribute):
            # The receiver itself can hold calls — e.g. the chained
            # ``threading.Thread(target=f).start()`` idiom, where the
            # spawn lives in the receiver expression.
            if not isinstance(node.func.value, (ast.Name, ast.Attribute)):
                self.visit_expr(node.func.value, held)
        elif not isinstance(node.func, ast.Name):
            self.visit_expr(node.func, held)
        for arg in node.args:
            if id(arg) not in routed:
                self.visit_expr(arg, held)
        for kw in node.keywords:
            if id(kw.value) not in routed:
                self.visit_expr(kw.value, held)


# ------------------------------------------------------------- phase B


class _Engine(object):
    """Whole-tree concurrency fixpoint over per-module facts."""

    def __init__(self, module_facts):
        self.funcs = {}  # qualname -> _CFuncFacts
        self.locks = {}  # lock id -> kind
        self.mutable_globals = {}  # gid -> (path, lineno)
        for mf in module_facts:
            for ff in mf.functions:
                self.funcs[ff.qualname] = ff
            self.locks.update(mf.locks)
            for name, info in mf.globals.items():
                if info["mutable"]:
                    gid = "{}.{}".format(mf.modname, name)
                    self.mutable_globals[gid] = (mf.path, info["lineno"])
        self.findings = []  # [(rule_id, path, lineno, message)]
        self._callers = {}  # qualname -> [(caller ff, call dict)]
        for ff in self.funcs.values():
            for call in ff.calls:
                callee = call.get("callee")
                if callee in self.funcs:
                    self._callers.setdefault(callee, []).append(
                        (ff, call))

    def emit(self, rule_id, path, lineno, message):
        self.findings.append((rule_id, path, lineno, message))

    # -------------------------------------------------- reachability

    def _closure(self, roots):
        seen = set()
        stack = [q for q in roots if q in self.funcs]
        while stack:
            q = stack.pop()
            if q in seen:
                continue
            seen.add(q)
            ff = self.funcs[q]
            for call in ff.calls:
                callee = call.get("callee")
                if callee in self.funcs and callee not in seen:
                    stack.append(callee)
        return seen

    def thread_entries(self):
        """{entry qualname: (handoff path, lineno)} for every callable
        handed to a thread boundary anywhere in the tree."""
        entries = {}
        for ff in self.funcs.values():
            for t in ff.thread_targets:
                entries.setdefault(t["target"], (ff.path, t["lineno"]))
        return entries

    # ----------------------------------------------- entry-lock (must)

    def entry_locks(self, forced_empty):
        """Must-hold lock set at entry of each function: intersection
        over call sites of (locks held at the site + the caller's own
        entry set). Thread entries and signal handlers start with
        nothing held. TOP (None) for functions never called."""
        TOP = None
        entry = {}
        for q in self.funcs:
            if q in forced_empty or q not in self._callers:
                entry[q] = frozenset()
            else:
                entry[q] = TOP
        for _ in range(len(self.funcs) + 1):
            changed = False
            for q, sites in self._callers.items():
                if q in forced_empty:
                    continue
                acc = TOP
                for caller, call in sites:
                    ce = entry.get(caller.qualname)
                    if ce is TOP:
                        continue
                    site = frozenset(call["held"]) | ce
                    acc = site if acc is TOP else (acc & site)
                if acc is not TOP and acc != entry.get(q):
                    entry[q] = acc
                    changed = True
            if not changed:
                break
        return {q: (v if v is not None else frozenset())
                for q, v in entry.items()}

    # -------------------------------------------------- thread-escape

    def run_thread_escape(self):
        entries = self.thread_entries()
        reachable = self._closure(entries)
        forced = set(entries)
        for ff in self.funcs.values():
            forced.update(h["target"] for h in ff.signal_handlers)
        entry = self.entry_locks(forced)

        # Gather every write per global id: direct writes plus mutation
        # through a parameter one call level deep (global passed to a
        # helper that mutates that parameter, directly or transitively).
        deep_mut = self._deep_param_mut()
        writes = {}  # gid -> [(ff, lineno, effective held, thread side)]
        for q, ff in self.funcs.items():
            side = q in reachable
            base = entry.get(q, frozenset())
            for w in ff.writes:
                gid = w["g"]
                if gid not in self.mutable_globals:
                    continue
                eff = frozenset(w["held"]) | base
                writes.setdefault(gid, []).append(
                    (ff, w["lineno"], eff, side))
            for call in ff.calls:
                callee = call.get("callee")
                if callee not in self.funcs:
                    continue
                for i_str, gid in call["args_globals"].items():
                    if gid not in self.mutable_globals:
                        continue
                    if int(i_str) in deep_mut.get(callee, ()):
                        eff = frozenset(call["held"]) | base
                        writes.setdefault(gid, []).append(
                            (ff, call["lineno"], eff, side))

        for gid in sorted(writes):
            sites = writes[gid]
            thread_side = [s for s in sites if s[3]]
            main_side = [s for s in sites if not s[3]]
            if not thread_side or not main_side:
                continue
            def_path, def_line = self.mutable_globals[gid]
            entry_names = sorted(
                q for q in entries
                if any(s[0].qualname in self._closure([q])
                       for s in thread_side))
            via = entry_names[0] if entry_names else "?"
            for ff, lineno, eff, side in sorted(
                    sites, key=lambda s: (s[0].path, s[1])):
                if eff:
                    continue
                other = "the {} thread".format(via) if not side \
                    else "the main thread"
                self.emit(
                    "thread-escape", ff.path, lineno,
                    "mutable module global '{}' (defined {}:{}) is "
                    "written here without a recognized lock while also "
                    "written from {} (thread entry {}()); guard every "
                    "write with one shared lock or confine the state "
                    "to a single thread".format(
                        gid, def_path, def_line, other, via))

    def _deep_param_mut(self):
        """{qualname: set(param indices mutated unlocked, directly or by
        passing the param onward)} — small fixpoint."""
        mut = {}
        for q, ff in self.funcs.items():
            mut[q] = {pw["i"] for pw in ff.param_writes
                      if not pw["held"]}
        # Propagate param-to-param forwarding: ff passes its param i as
        # positional j of callee; callee mutates j => ff mutates i.
        # (args_globals only records globals, so re-scan calls is not
        # possible here without param refs — handled at extraction via
        # params being locals: a param passed on appears as a plain Name
        # arg that is NOT a global, so this stays one level deep. One
        # level catches the real tree's patterns (fleet.rotating_path,
        # series -> fleet.rotating_path) and fixtures pin it.)
        return mut

    # ----------------------------------------------------- lock-order

    def run_lock_order(self):
        # Transitive lock-acquisition closure per function.
        acq = {q: {(a["lock"], a["lineno"])
                   for a in ff.acquires}
               for q, ff in self.funcs.items()}
        for _ in range(len(self.funcs) + 1):
            changed = False
            for q, ff in self.funcs.items():
                for call in ff.calls:
                    callee = call.get("callee")
                    if callee not in self.funcs:
                        continue
                    add = {(lk, call["lineno"]) for lk, _ in acq[callee]}
                    if not add <= acq[q]:
                        acq[q] |= add
                        changed = True
            if not changed:
                break

        pairs = {}  # (outer, inner) -> (path, lineno)
        for q, ff in self.funcs.items():
            for a in ff.acquires:
                for outer in a["held"]:
                    pairs.setdefault((outer, a["lock"]),
                                     (ff.path, a["lineno"]))
            for call in ff.calls:
                callee = call.get("callee")
                if callee not in self.funcs or not call["held"]:
                    continue
                for inner, _ in acq[callee]:
                    for outer in call["held"]:
                        pairs.setdefault((outer, inner),
                                         (ff.path, call["lineno"]))

        reported = set()
        for (a, b), (path, lineno) in sorted(pairs.items(),
                                             key=lambda kv: kv[1]):
            if a == b:
                if self.locks.get(a) == "Lock":
                    self.emit(
                        "lock-order", path, lineno,
                        "non-reentrant lock '{}' acquired while already "
                        "held on this path — this deadlocks; use "
                        "threading.RLock or restructure so the lock is "
                        "taken once".format(a))
                continue
            if (b, a) in pairs and frozenset((a, b)) not in reported:
                reported.add(frozenset((a, b)))
                other_path, other_line = pairs[(b, a)]
                self.emit(
                    "lock-order", path, lineno,
                    "locks '{}' and '{}' are acquired in both orders "
                    "({} -> {} here; {} -> {} at {}:{}) — two threads "
                    "taking them concurrently deadlock; pick one global "
                    "order".format(a, b, a, b, b, a, other_path,
                                   other_line))

    # -------------------------------------------------- signal-safety

    def run_signal_safety(self):
        handlers = {}
        for ff in self.funcs.values():
            for h in ff.signal_handlers:
                handlers.setdefault(h["target"], (ff.path, h["lineno"]))
        if not handlers:
            return
        for handler in sorted(handlers):
            reg_path, reg_line = handlers[handler]
            for q in sorted(self._closure([handler])):
                ff = self.funcs[q]
                for a in ff.acquires:
                    if self.locks.get(a["lock"]) == "Lock":
                        self.emit(
                            "signal-safety", ff.path, a["lineno"],
                            "non-reentrant threading.Lock '{}' on the "
                            "signal-handler path of {}() (registered "
                            "{}:{}): a signal interrupting a frame that "
                            "holds it deadlocks the handler — use "
                            "threading.RLock".format(
                                a["lock"], handler.rsplit(".", 1)[-1],
                                reg_path, reg_line))
                if any(ff.path.startswith(p)
                       for p in SIGNAL_BLOCKING_SANCTIONED_PREFIXES):
                    continue
                for b in ff.blocking:
                    self.emit(
                        "signal-safety", ff.path, b["lineno"],
                        "blocking {} on the signal-handler path of {}() "
                        "(registered {}:{}); handlers must not block — "
                        "set a flag and do the work on the main "
                        "path".format(b["what"],
                                      handler.rsplit(".", 1)[-1],
                                      reg_path, reg_line))

    # ------------------------------------------- env-read-after-spawn

    def run_env_after_spawn(self):
        exempt = {q for q, ff in self.funcs.items()
                  if any(ff.path.startswith(p)
                         for p in ENV_SOURCE_EXEMPT_PREFIXES)}

        # Transitive summaries: does f (or anything it calls) spawn a
        # pool; does f (or anything it calls) read LDDL_TPU_* env.
        spawns = {q: any(s["kind"] == "pool" for s in ff.spawns)
                  for q, ff in self.funcs.items()}
        reads = {}
        for q, ff in self.funcs.items():
            reads[q] = set() if q in exempt else \
                {r["name"] for r in ff.env_reads}
        for _ in range(len(self.funcs) + 1):
            changed = False
            for q, ff in self.funcs.items():
                for call in ff.calls:
                    callee = call.get("callee")
                    if callee not in self.funcs:
                        continue
                    if spawns[callee] and not spawns[q]:
                        spawns[q] = True
                        changed = True
                    if q not in exempt and not reads[callee] <= reads[q]:
                        reads[q] |= reads[callee]
                        changed = True
            if not changed:
                break

        for q in sorted(self.funcs):
            ff = self.funcs[q]
            if q in exempt:
                continue
            # Spawn events visible inside this function, by line: a
            # direct pool/thread spawn, or a call into a pool-spawning
            # callee.
            spawn_events = [(s["lineno"],
                             "pool" if s["kind"] == "pool" else "thread")
                            for s in ff.spawns]
            for call in ff.calls:
                callee = call.get("callee")
                if callee in self.funcs and spawns[callee]:
                    spawn_events.append((call["lineno"], "pool"))
            if not spawn_events:
                continue
            pool_spawns = [ln for ln, kind in spawn_events
                           if kind == "pool"]
            thread_spawns = [ln for ln, kind in spawn_events
                             if kind == "thread"]

            read_events = [(r["lineno"], r["name"], None)
                           for r in ff.env_reads]
            for call in ff.calls:
                callee = call.get("callee")
                if callee in self.funcs and reads[callee]:
                    read_events.append(
                        (call["lineno"], sorted(reads[callee])[0],
                         callee))
            emitted = set()
            for lineno, name, via in sorted(read_events):
                first_pool = min((ln for ln in pool_spawns
                                  if ln < lineno), default=None)
                # Threads share the live environ: only the
                # same-function spawn-then-read window fires for them,
                # and only for DIRECT reads.
                first_thread = min((ln for ln in thread_spawns
                                    if ln < lineno), default=None) \
                    if via is None else None
                first = first_pool if first_pool is not None \
                    else first_thread
                if first is None or lineno in emitted:
                    continue
                emitted.add(lineno)
                how = "read here" if via is None else \
                    "read inside {}() called here".format(
                        via.rsplit(".", 1)[-1])
                self.emit(
                    "env-read-after-spawn", ff.path, lineno,
                    "{} {} after a worker spawn point (line {}) on the "
                    "same call path; spawned workers snapshot the "
                    "environment at spawn time, so a late read silently "
                    "desynchronizes parent and worker configuration — "
                    "read and pin it before spawning".format(
                        name, how, first))


def run_concurrency_analysis(module_facts):
    """Phase B over cached/extracted per-module concurrency facts.
    Returns ``[(rule_id, path, lineno, message)]`` BEFORE allow-list,
    suppression, and baseline filtering (core.run_check applies those,
    exactly as for the dataflow findings)."""
    eng = _Engine(module_facts)
    eng.run_thread_escape()
    eng.run_lock_order()
    eng.run_signal_safety()
    eng.run_env_after_spawn()
    # Deterministic output order; dedupe (a loop-free guarantee the
    # emitters do not individually make).
    return sorted(set(eng.findings))


# --------------------------------------------------------------- rules


class ConcurrencyRule(Rule):
    """Base for the concurrency project-scope rules: run via
    :func:`run_concurrency_analysis`, not per file."""

    scope = "project"

    def run(self, ctx):  # pragma: no cover - project rules don't run here
        return ()


@register
class ThreadEscapeRule(ConcurrencyRule):
    id = "thread-escape"
    doc = ("mutable module globals written on both sides of a thread "
           "boundary (Thread(target=), .submit() hand-offs, sink "
           "writer, LeaseKeeper, heartbeat/exporter threads) must hold "
           "a recognized lock at every write; mutation through helper "
           "parameters counts")
    # The metrics registry is the sanctioned shared-state surface: its
    # internals ARE the lock-guarded registry the rest of the tree must
    # use instead of ad-hoc module dicts.
    allow = ("lddl_tpu_torch/observability/registry.py",)


@register
class LockOrderRule(ConcurrencyRule):
    id = "lock-order"
    doc = ("no two locks acquired in both orders across any pair of "
           "call paths (AB/BA deadlock), and no non-reentrant lock "
           "re-acquired while already held")
    allow = ()


@register
class SignalSafetyRule(ConcurrencyRule):
    id = "signal-safety"
    doc = ("signal-handler call paths must not acquire non-reentrant "
           "threading.Lock (use RLock) nor make "
           "blocking calls (write-mode open, queue.put without "
           "timeout, zero-arg .join(), time.sleep); observability's "
           "flush-on-TERM writes are sanctioned at the engine level")
    allow = ()


@register
class EnvReadAfterSpawnRule(ConcurrencyRule):
    id = "env-read-after-spawn"
    doc = ("no LDDL_TPU_* env reads after a process-pool spawn point "
           "on the same call path — workers snapshot the env at spawn, "
           "so late reads desynchronize parent/worker config; "
           "observability/faults gating reads are exempt sources")
    allow = ()


CONCURRENCY_RULE_IDS = ("thread-escape", "lock-order", "signal-safety",
                        "env-read-after-spawn")
