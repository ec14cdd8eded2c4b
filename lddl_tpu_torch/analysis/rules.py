"""Concrete determinism / SPMD-safety rules.

Counterpart of ``lddl_tpu/analysis/rules.py``: the same rules, with each
``allow``/``only`` scope naming the port's counterpart module
(``lddl_tpu/models/testing.py`` is the port's top-level ``testing.py``).
Each rule encodes one pipeline invariant (the ``utils/rng.py``
contract); ``lddl_check --list-rules`` prints the ``id`` + ``doc``
attributes here — keep both one-line accurate.
"""

import ast

from .core import Finding, Rule, register, _match_any

# --------------------------------------------------------------- global-rng

# Module-level functions of CPython's ``random`` that draw from the hidden
# global Mersenne state. ``random.Random(seed)`` instances are allowed: the
# seed is explicit, so determinism is auditable at the call site.
_PY_RANDOM_FUNCS = frozenset({
    "seed", "random", "randint", "randrange", "uniform", "shuffle",
    "choice", "choices", "sample", "gauss", "normalvariate", "betavariate",
    "expovariate", "getrandbits", "randbytes", "triangular",
    "lognormvariate", "vonmisesvariate", "paretovariate", "weibullvariate",
})


@register
class GlobalRngRule(Rule):
    id = "global-rng"
    doc = ("no global-state RNG (random.*, np.random.* module functions, "
           "np.random.default_rng) in pipeline code — use the keyed "
           "utils.rng streams (world_rng/worker_rng/sample_rng)")
    allow = ("lddl_tpu_torch/utils/rng.py", "lddl_tpu_torch/testing.py")

    def run(self, ctx):
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = ctx.resolve_call(node)
            if not name:
                continue
            if name.startswith("numpy.random."):
                attr = name.split(".", 2)[2]
                if attr == "Generator" or attr == "Philox":
                    # Explicitly-keyed constructions (what utils.rng itself
                    # builds on) are the sanctioned escape hatch.
                    continue
                yield ctx.finding(
                    self.id, node,
                    "{}() is process-global or ad-hoc-seeded RNG; derive a "
                    "stream from utils.rng (world_rng/worker_rng/"
                    "sample_rng) so every rank draws identically".format(
                        name))
            elif name.startswith("random."):
                attr = name.split(".", 1)[1]
                if attr in _PY_RANDOM_FUNCS:
                    yield ctx.finding(
                        self.id, node,
                        "random.{}() draws from CPython's hidden global "
                        "state; use a keyed utils.rng stream".format(attr))


# --------------------------------------------------------------- wall-clock

_WALL_CLOCK = frozenset({
    "time.time", "time.time_ns", "time.localtime", "time.gmtime",
    "time.ctime", "datetime.datetime.now", "datetime.datetime.utcnow",
    "datetime.datetime.today", "datetime.date.today",
})


@register
class WallClockRule(Rule):
    id = "wall-clock"
    doc = ("no wall-clock (time.time, datetime.now) feeding data-shaping "
           "decisions; observability timestamps and benchmarks are "
           "allowlisted, log-only uses carry inline suppressions")
    # Trace timestamps are the one legitimate wall-clock consumer;
    # benchmarks measure wall time by definition; lease deadlines are
    # wall-clock by design (lease-isolation guards what matters there).
    # Observability files are allowlisted INDIVIDUALLY — autoscale.py is
    # deliberately absent: scaling decisions must derive from the fleet
    # aggregate, never from a clock read of its own.
    allow = ("lddl_tpu_torch/observability/registry.py",
             "lddl_tpu_torch/observability/tracing.py",
             "lddl_tpu_torch/observability/exporters.py",
             "lddl_tpu_torch/observability/fleet.py",
             "lddl_tpu_torch/observability/series.py",
             "lddl_tpu_torch/observability/alerts.py",
             "lddl_tpu_torch/observability/__init__.py",
             "lddl_tpu_torch/benchmarks/*",
             "lddl_tpu_torch/resilience/leases.py")

    def run(self, ctx):
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call):
                name = ctx.resolve_call(node)
                if name in _WALL_CLOCK:
                    yield ctx.finding(
                        self.id, node,
                        "{}() is wall-clock; if this value can reach shard "
                        "bytes, names, or iteration order it diverges "
                        "ranks — use a seeded stream or a monotonic timer, "
                        "or suppress with a justification if log-only"
                        .format(name))


# ----------------------------------------------------------- atomic-publish

_MOVE_FUNCS = frozenset({"os.replace", "os.rename", "os.renames",
                         "shutil.move"})
# Packages that publish into shard directories: a raw write-mode open()
# there can leave a torn file that a resume or a reader will trust.
_SHARD_PKGS = ("lddl_tpu_torch/preprocess/*", "lddl_tpu_torch/balance/*",
               "lddl_tpu_torch/loader/*", "lddl_tpu_torch/resilience/*",
               "lddl_tpu_torch/ingest/*", "lddl_tpu_torch/utils/fs.py")


def _open_mode(node):
    """The mode string of an open() call, or None when not a literal."""
    mode = None
    if len(node.args) >= 2:
        mode = node.args[1]
    for kw in node.keywords:
        if kw.arg == "mode":
            mode = kw.value
    if mode is None:
        return "r"
    if isinstance(mode, ast.Constant) and isinstance(mode.value, str):
        return mode.value
    return None


@register
class AtomicPublishRule(Rule):
    id = "atomic-publish"
    doc = ("all publishes into shard dirs go through resilience.io "
           "(atomic_write/atomic_publish/write_table_atomic): flags "
           "os.replace/os.rename/shutil.move anywhere, raw "
           "pq.write_table and write-mode open() in pipeline packages")
    # backend.py is the object-store half of the sanctioned publisher:
    # its raw opens/links/replaces ARE the multipart-upload-then-commit
    # machinery the rest of the tree must route through.
    allow = ("lddl_tpu_torch/resilience/io.py",
             "lddl_tpu_torch/resilience/backend.py")

    def run(self, ctx):
        in_shard_pkg = _match_any(ctx.path, _SHARD_PKGS)
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = ctx.resolve_call(node)
            if name in _MOVE_FUNCS:
                yield ctx.finding(
                    self.id, node,
                    "raw {}() re-opens the torn-publish window; route "
                    "through resilience.io.atomic_write/atomic_publish "
                    "(tmp + fsync + replace + dir fsync)".format(name))
            elif (name == "pyarrow.parquet.write_table"
                  and ctx.path.startswith("lddl_tpu_torch/")):
                yield ctx.finding(
                    self.id, node,
                    "raw pq.write_table() publishes a shard without "
                    "tmp+fsync+replace; use "
                    "resilience.io.write_table_atomic")
            elif name == "open" and in_shard_pkg:
                mode = _open_mode(node)
                if mode is None or any(c in mode for c in "wax"):
                    yield ctx.finding(
                        self.id, node,
                        "write-mode open({!r}) in a shard-publishing "
                        "package; a crash mid-write leaves a torn file — "
                        "use resilience.io.atomic_write".format(mode))


# ------------------------------------------------------- unsorted-iteration

_LIST_FUNCS = frozenset({"os.listdir", "os.scandir", "os.walk",
                         "glob.glob", "glob.iglob"})
# Consumers whose result cannot depend on the input order.
_ORDER_INSENSITIVE = frozenset({"sorted", "len", "set", "frozenset", "sum",
                                "min", "max", "any", "all"})


@register
class UnsortedIterationRule(Rule):
    id = "unsorted-iteration"
    doc = ("os.listdir/glob.glob/os.walk results are filesystem-ordered; "
           "they must pass through sorted() (or an order-insensitive "
           "reduction) before anything downstream can observe the order")

    def run(self, ctx):
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = ctx.resolve_call(node)
            if name not in _LIST_FUNCS:
                continue
            if self._order_insensitive(ctx, node):
                continue
            yield ctx.finding(
                self.id, node,
                "{}() returns entries in filesystem order, which differs "
                "across hosts and filesystems; wrap the result in "
                "sorted() so shard enumeration order is a pure function "
                "of the names".format(name))

    @staticmethod
    def _order_insensitive(ctx, node):
        for anc in ctx.ancestors(node):
            if isinstance(anc, ast.Call):
                name = ctx.resolve_call(anc)
                if name in _ORDER_INSENSITIVE:
                    return True
            if isinstance(anc, ast.SetComp):
                # A set comprehension erases input order by construction.
                return True
            if isinstance(anc, ast.stmt):
                # Stop at the enclosing statement: a later sorted() on the
                # stored variable is invisible to this (deliberately
                # syntactic) check — sort at the producer instead.
                return False
        return False


# --------------------------------------------------------- swallowed-error

_OS_ERRORS = frozenset({"OSError", "IOError", "EnvironmentError",
                        "os.error"})


@register
class SwallowedErrorRule(Rule):
    id = "swallowed-error"
    doc = ("no bare `except:` and no `except OSError: pass` — transient "
           "I/O errors must route through resilience.with_retries (or be "
           "suppressed with a why-comment when best-effort is the intent)")
    # resilience/io.py IS the error-routing layer; its internal best-effort
    # cleanups (tmp unlink in finally, dir-fsync on FAT/FUSE) are the
    # audited exception — backend.py's staging/GC cleanups likewise.
    allow = ("lddl_tpu_torch/resilience/io.py",
             "lddl_tpu_torch/resilience/backend.py")

    def run(self, ctx):
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if node.type is None:
                yield ctx.finding(
                    self.id, node,
                    "bare `except:` swallows SystemExit/KeyboardInterrupt "
                    "and every bug; name the exceptions (transient I/O "
                    "belongs in resilience.with_retries)")
                continue
            if not self._catches_oserror(ctx, node.type):
                continue
            if len(node.body) == 1 and isinstance(node.body[0], ast.Pass):
                yield ctx.finding(
                    self.id, node,
                    "`except OSError: pass` silently swallows I/O "
                    "failure; retry via resilience.with_retries, surface "
                    "it, or suppress with a justification if best-effort")

    @staticmethod
    def _catches_oserror(ctx, type_node):
        nodes = type_node.elts if isinstance(type_node, ast.Tuple) \
            else [type_node]
        for n in nodes:
            if ctx.resolve_name(n) in _OS_ERRORS:
                return True
        return False


# -------------------------------------------------------------- stage-span

# Stage entry points that must open their top-level span(s) so every
# trace carries the stage skeleton (span names are stable API; the
# merged fleet trace lines up hosts by them): the static runner, the
# elastic claim loop, the balancer, the loader and the ingest service.
STAGE_SPANS = {
    "lddl_tpu_torch/preprocess/runner.py": ("preprocess.run",),
    "lddl_tpu_torch/preprocess/steal.py": ("preprocess.gather",
                                           "preprocess.finalize"),
    "lddl_tpu_torch/balance/balancer.py": ("balance.run",),
    "lddl_tpu_torch/loader/dataloader.py": ("loader.epoch",),
    "lddl_tpu_torch/ingest/incremental.py": ("ingest.run",),
}


@register
class StageSpanRule(Rule):
    id = "stage-span"
    doc = ("each pipeline stage entry file must open its top-level "
           "obs.span (preprocess.run / preprocess.gather+finalize / "
           "balance.run / loader.epoch / ingest.run) so traces always "
           "carry the stage skeleton")
    only = tuple(STAGE_SPANS)

    def run(self, ctx):
        wanted = STAGE_SPANS.get(ctx.path)
        if not wanted:
            return
        found = set()
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = ctx.resolve_call(node)
            if not name or not (name == "span" or name.endswith(".span")):
                continue
            if (node.args and isinstance(node.args[0], ast.Constant)
                    and node.args[0].value in wanted):
                found.add(node.args[0].value)
        for want in wanted:
            if want in found:
                continue
            # Required-pattern rule: no single node is "the" violation, so
            # the finding anchors to line 1 of the file.
            yield Finding(self.id, ctx.path, 1, 0,
                          "stage entry point lacks its top-level "
                          "span(\"{}\") — traces from this stage lose "
                          "their skeleton".format(want), ctx.snippet_at(1))


# --------------------------------------------------------- jit-host-effect

_HOST_CLOCKS = frozenset({"time.time", "time.time_ns", "time.perf_counter",
                          "time.monotonic", "time.process_time"})


@register
class JitHostEffectRule(Rule):
    id = "jit-host-effect"
    doc = ("no host side-effects (print, observability hooks, "
           "float(tracer), host clocks) inside jax.jit-compiled function "
           "bodies — they fire at trace time only, or crash")
    # The port compiles nothing today (no jax.jit, no CUDA-graph
    # capture), so on its own tree this rule finds nothing. It keeps the
    # reference's recognition of jax.jit so the reference's fixtures give
    # the same findings in both analyzers; CUDA-graph capture bodies
    # (torch.cuda.graph) join the recognized set when the port captures
    # graphs.
    only = ("lddl_tpu_torch/ops/*", "lddl_tpu_torch/models/*")

    def run(self, ctx):
        jitted = self._jitted_function_names(ctx)
        if not jitted:
            return
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.FunctionDef) \
                    or node.name not in jitted:
                continue
            for f in self._scan_body(ctx, node):
                yield f

    def _scan_body(self, ctx, func):
        for node in ast.walk(func):
            if not isinstance(node, ast.Call):
                continue
            name = ctx.resolve_call(node)
            if not name:
                continue
            if name == "print":
                yield ctx.finding(
                    self.id, node,
                    "print() inside a jit-compiled function runs once at "
                    "trace time, never per step; use jax.debug.print or "
                    "hoist it out")
            elif name.split(".")[0] == "observability" \
                    or name.startswith("observability."):
                yield ctx.finding(
                    self.id, node,
                    "metrics/tracing hook {}() inside a jit-compiled "
                    "function fires at trace time only; record outside "
                    "the jitted region".format(name))
            elif name in _HOST_CLOCKS:
                yield ctx.finding(
                    self.id, node,
                    "host clock {}() inside a jit-compiled function reads "
                    "once at trace time; time outside the jitted region"
                    .format(name))
            elif name == "float" and len(node.args) == 1 \
                    and not isinstance(node.args[0], ast.Constant):
                yield ctx.finding(
                    self.id, node,
                    "float(...) on a traced value forces a host sync (or "
                    "crashes under jit); keep values as jax arrays inside "
                    "the compiled region")

    @staticmethod
    def _jitted_function_names(ctx):
        """Names of functions compiled by jax.jit in this module: directly
        decorated, passed to a jax.jit(...) call, or reached through one
        ``functools.partial(f, ...)`` hop (the idiom ops/masking.py uses)."""
        partial_targets = {}  # local name -> set of function names
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Assign) and isinstance(node.value,
                                                           ast.Call):
                callee = ctx.resolve_call(node.value)
                if callee in ("functools.partial", "partial") \
                        and node.value.args \
                        and isinstance(node.value.args[0], ast.Name):
                    for tgt in node.targets:
                        if isinstance(tgt, ast.Name):
                            partial_targets.setdefault(tgt.id, set()).add(
                                node.value.args[0].id)
        jitted = set()

        def note_jit_arg(arg):
            if isinstance(arg, ast.Name):
                jitted.add(arg.id)
                jitted.update(partial_targets.get(arg.id, ()))
            elif isinstance(arg, ast.Call):
                callee = ctx.resolve_call(arg)
                if callee in ("functools.partial", "partial") and arg.args \
                        and isinstance(arg.args[0], ast.Name):
                    jitted.add(arg.args[0].id)

        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call) \
                    and ctx.resolve_call(node) == "jax.jit" and node.args:
                note_jit_arg(node.args[0])
            elif isinstance(node, ast.FunctionDef):
                for dec in node.decorator_list:
                    if isinstance(dec, ast.Call):
                        callee = ctx.resolve_call(dec)
                        if callee == "jax.jit":
                            jitted.add(node.name)
                        elif callee in ("functools.partial", "partial") \
                                and dec.args \
                                and ctx.resolve_name(dec.args[0]) \
                                == "jax.jit":
                            jitted.add(node.name)
                    elif ctx.resolve_name(dec) == "jax.jit":
                        jitted.add(node.name)
        return jitted


# --------------------------------------------------- manifest-determinism

_NONDET_IN_MANIFEST = frozenset(
    {"os.getpid", "uuid.uuid1", "uuid.uuid4", "time.monotonic",
     "time.perf_counter"} | _WALL_CLOCK)


@register
class ManifestDeterminismRule(Rule):
    id = "manifest-determinism"
    doc = ("functions that build .manifest.json / ledger / ingest-journal "
           "content must not draw wall-clock, pids, uuids, or RNG — "
           "resume compares these bytes across runs and ranks, and the "
           "ingest journal additionally promises content-hash-only "
           "document identity")
    # Lease records legitimately carry wall-clock deadlines and per-host
    # ids; they are scheduling state under _leases/, never resume-compared
    # content (the lease-isolation flow rule guards the real boundary).
    allow = ("lddl_tpu_torch/resilience/leases.py",)

    # Builder-name tokens this rule guards: manifest/ledger plus
    # the streaming-ingestion record builders (journal segments, intake
    # records, generation meta) and the offline packer's manifest-meta
    # fragment (pack_meta_of — packed row shapes are resume-compared
    # manifest content too).
    NAME_TOKENS = ("manifest", "ledger", "journal", "intake", "generation",
                   "pack_meta")

    def run(self, ctx):
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.FunctionDef):
                continue
            lowered = node.name.lower()
            if not any(tok in lowered for tok in self.NAME_TOKENS):
                continue
            for call in ast.walk(node):
                if not isinstance(call, ast.Call):
                    continue
                name = ctx.resolve_call(call)
                if not name:
                    continue
                if name in _NONDET_IN_MANIFEST \
                        or name.startswith("numpy.random.") \
                        or (name.startswith("random.")
                            and name.split(".", 1)[1] in _PY_RANDOM_FUNCS):
                    yield ctx.finding(
                        self.id, call,
                        "{}() inside manifest/ledger builder {}(): this "
                        "content is compared byte-for-byte across runs "
                        "and ranks on resume; nondeterministic fields "
                        "poison it".format(name, node.name))


# ------------------------------------------------------------ python-hot-loop

# Methods that materialize per-element Python objects out of Arrow/numpy
# containers. On the loader's per-sample path each call site multiplies by
# tokens-per-epoch; the schema-v2 columnar decode exists precisely so none
# of these run per token.
_PY_MATERIALIZERS = frozenset({"as_py", "to_pylist", "to_pydict", "tolist"})


@register
class PythonHotLoopRule(Rule):
    id = "python-hot-loop"
    doc = ("no per-token Python iteration on the loader, preprocess, or "
           "balance hot paths (.as_py()/.to_pylist()/.to_pydict()/"
           ".tolist(), nested-generator np.fromiter over token streams) "
           "— stay columnar; justified fallbacks carry suppressions")
    # Loader per-sample work multiplies by epochs; preprocess/balance
    # per-token work multiplies by corpus bytes.
    only = ("lddl_tpu_torch/loader/*", "lddl_tpu_torch/preprocess/*",
            "lddl_tpu_torch/balance/*")

    def run(self, ctx):
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            if isinstance(func, ast.Attribute) \
                    and func.attr in _PY_MATERIALIZERS:
                yield ctx.finding(
                    self.id, node,
                    ".{}() materializes one Python object per element; on "
                    "a pipeline hot path that is per-token work per epoch "
                    "(loader) or per corpus byte (preprocess/balance) — "
                    "decode Arrow list<int32> columns to numpy views "
                    "(loader.bert._list_views), keep numpy arrays "
                    "columnar, or move the work offline; suppress with a "
                    "justification for once-per-process tables, debug "
                    "sinks, or v1 fallbacks".format(func.attr))
                continue
            name = ctx.resolve_call(node)
            if name == "numpy.fromiter" and node.args:
                gen = node.args[0]
                if isinstance(gen, ast.GeneratorExp) \
                        and len(gen.generators) > 1:
                    yield ctx.finding(
                        self.id, node,
                        "np.fromiter over a nested generator iterates per "
                        "TOKEN in Python (outer per-sample, inner per-"
                        "element); consume schema-v2 id columns or batch "
                        "the conversion — baseline only the schema-v1 "
                        "text fallback")
