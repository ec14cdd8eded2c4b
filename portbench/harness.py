"""One run of one cell: set-up, the measured window, the traced steps and
the output check.

A cell is found by name: ``BENCHMARK.json`` names its configuration and
traffic, whose files (``configs/<name>.json``, ``traffic/<name>.json``)
hold every size; the configuration's ``family`` names the module under
``families/`` that builds the program's loader and model for it, and its
plain reference under ``reference/``; ``cells/<workload>.json`` holds the
limits of the output check; each per-layer metric is read by
``metrics/<metric>.py``. Adding a cell or a metric adds files.

The window drives the path a user trains on: the port's loader over the
cell's shards, ``prefetch_to_device(loader, device, depth=2)`` and
``make_train_step(model, make_optimizer(...))``, calling
``step(next(it))`` with no host sync between steps. A CUDA event is
recorded on the current stream at each step's start; one synchronize
ends the window.
"""

import importlib
import importlib.util
import json
import math
import os
import shutil
import statistics
import tempfile
import time
import traceback

from . import flops

ROOT = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(ROOT)
# The port's attention wrappers, whose launch counters the traced steps
# read (``<wrapper>.launches``).
KERNEL_WRAPPERS = ("onekv_fwd", "onekv_bwd", "online_fwd", "online_bwd_dq",
                   "online_bwd_dkv")


def _json(path):
    with open(path) as f:
        return json.load(f)


class Cell:
    """A workload of ``BENCHMARK.json`` with its configuration, traffic,
    family module, limits and metrics."""

    def __init__(self, name, cfg, traffic, limits, end_to_end, per_layer,
                 chips=1):
        self.name = name
        self.chips = chips
        self.cfg = cfg
        self.traffic = traffic
        self.limits = limits
        self.end_to_end = end_to_end
        self.per_layer = per_layer
        self.family = importlib.import_module(
            "portbench.families." + cfg["family"])


def find_cell(name, bench_path=None, base=ROOT):
    """The cell named ``name`` in ``bench_path`` (default: the repo's
    ``BENCHMARK.json``), its files under ``base``."""
    bench = _json(bench_path or os.path.join(REPO, "BENCHMARK.json"))
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError("no workload {!r} in BENCHMARK.json (have {})".format(
            name, ", ".join(sorted(work))))
    w = work[name]

    def reports(metric):
        return name in metric.get("workloads", [name])

    return Cell(
        name,
        _json(os.path.join(base, "configs", w["config"] + ".json")),
        _json(os.path.join(base, "traffic", w["traffic"] + ".json")),
        _json(os.path.join(base, "cells", name + ".json"))["limits"],
        [m for m in bench["end_to_end"] if reports(m)],
        [m for m in bench["per_layer"] if reports(m)], w["chips"])


def read_metric(name, ctx, base=ROOT):
    """The value ``metrics/<name>.py`` reads from ``ctx``, or None."""
    path = os.path.join(base, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(ctx)


def per_layer_metrics(cell, ctx):
    """Each per-layer metric of the cell as its reader takes it from a
    traced run's ``ctx``. A metric that ``BENCHMARK.json`` lists for the
    cell and whose reader finds nothing fails the run."""
    values = {m["name"]: read_metric(m["name"], ctx) for m in cell.per_layer}
    silent = sorted(k for k, v in values.items() if v is None)
    if silent:
        trace = ctx.get("trace") or {}
        raise RuntimeError(
            "the traced run found nothing to read for {} ({} device events, "
            "marker {})".format(", ".join(silent),
                                trace.get("device_events"),
                                trace.get("marker")))
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in cell.per_layer}


class Recorder:
    """The loader's batches as it serves them (host numpy dicts, kept for
    the output check and the step counts), passed on unchanged."""

    def __init__(self, loader):
        self.loader = loader
        self.batches = []

    def __iter__(self):
        it = iter(self.loader)
        try:
            for batch in it:
                self.batches.append(batch)
                yield batch
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()


class _HostMark:
    """A step-start mark on the host clock, for runs without a card."""

    def __init__(self):
        self.t = time.perf_counter()

    def elapsed_time(self, later):
        return (later.t - self.t) * 1e3


def _mark(device):
    import torch
    if device.type != "cuda":
        return _HostMark()
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def window_metrics(marks, end, step_stats, seconds_of):
    """End-to-end numbers of a window from its step-start marks, the mark
    after the last step and each counted step's stats: the rate over the
    whole window, the 95th percentile of the step intervals, the model
    FLOPs over the window at the bf16 peak. ``seconds_of(a, b)`` is the
    time between two marks."""
    intervals = [seconds_of(a, b) for a, b in zip(marks, marks[1:] + [end])]
    wall = seconds_of(marks[0], end)
    q = max(1, len(intervals) // 4)
    return {
        "by_quarter": [1e3 * statistics.median(intervals[i:i + q])
                       for i in range(0, q * 4, q) if intervals[i:i + q]],
        "train_tokens_per_s": sum(s["tokens"] for s in step_stats) / wall,
        "step_ms_p95": flops.p95(intervals) * 1e3,
        "mfu": 100.0 * sum(s["flops"] for s in step_stats)
        / (wall * flops.PEAK_BF16_FLOPS),
        "window_s": wall,
        "steps": len(intervals),
    }


def _leaf_norms(tensors):
    import torch
    return torch.stack(torch._foreach_norm(tensors)).tolist()


# Most check steps a run takes to cover every shape its traffic asks for.
MAX_CHECK_STEPS = 16


class Program:
    """The system under test for one seed: the cell's data, the port's
    loader behind ``prefetch_to_device``, the port's model with the
    benchmark's weights, and its train step, driven through the check
    steps: at least the traffic's ``check_steps``, and on until a step of
    each shape the family names (``check_shapes``) has run. ``readings``
    holds what the output check compares: each check step's loss, each
    step's clipped gradient's norm a leaf (from AdamW's first moment:
    ``(m_n - b1 m_{n-1}) / (1 - b1)``) and each leaf's change over the
    check steps; ``shapes`` the shape and padded length of each."""

    def __init__(self, cell, seed, device, workdir):
        import torch
        from lddl_tpu_torch.loader import prefetch_to_device
        from lddl_tpu_torch.models import make_optimizer, make_train_step
        from .reference.common import make_weights
        fam, cfg, traffic = cell.family, cell.cfg, cell.traffic
        self.seed, self.device = seed, device
        shards, vocab, self.index = fam.make_data(workdir, cfg, traffic, seed)
        self.recorder = Recorder(fam.make_loader(shards, vocab, traffic,
                                                 seed))
        self.it = iter(prefetch_to_device(self.recorder, device, depth=2))
        self.model, batch_loss = fam.make_model(cfg, device)
        specs = fam.REFERENCE.param_specs(cfg)
        self.model.load_state_dict(make_weights(specs, seed, device),
                                   strict=True)
        self.opt = make_optimizer(
            self.model.parameters(),
            **{k: v for k, v in cfg["optimizer"].items() if k != "eps"})
        self.step_fn = make_train_step(self.model, self.opt,
                                       batch_loss=batch_loss)
        self.consumed = 0
        params = list(self.model.parameters())
        names = [n for n, _ in self.model.named_parameters()]
        b1 = cfg["optimizer"]["b1"]
        want, seen = fam.check_shapes(traffic), set()
        losses, grads, shapes, prev = [], [], [], None
        while len(losses) < traffic["check_steps"] or not want <= seen:
            if len(losses) == MAX_CHECK_STEPS:
                raise RuntimeError(
                    "{} check steps cover shapes {} of {}: the traffic's "
                    "loader_seed orders the bins too late".format(
                        MAX_CHECK_STEPS, sorted(seen), sorted(want)))
            losses.append(self.step()["loss"])
            batch = self.recorder.batches[self.consumed - 1]
            key = fam.shape_of(traffic, batch)
            seen.add(key)
            shapes.append([key, int(batch["input_ids"].shape[1])])
            state = self.opt.optimizer.state
            m = [state[p]["exp_avg"] if p in state else torch.zeros_like(p)
                 for p in params]
            g = (torch._foreach_div(m, 1 - b1) if prev is None else
                 torch._foreach_div(torch._foreach_sub(
                     m, torch._foreach_mul(prev, b1)), 1 - b1))
            grads.append(dict(zip(names, _leaf_norms(g))))
            del g
            prev = [x.clone() for x in m]
        del prev
        w0 = make_weights(specs, seed, device)
        change = _leaf_norms([p.detach() - w0[n] for n, p in
                              self.model.named_parameters()])
        del w0
        self.readings = {"loss": [float(x) for x in losses],
                         "grad": grads,
                         "change": dict(zip(names, change))}
        self.shapes = shapes
        for batch in fam.warmup_batches(cfg, traffic, device, seed):
            self.step_fn(batch, seed=seed)
        _sync(device)

    def step(self):
        """One step on the loader's next batch, as the window takes it."""
        out = self.step_fn(next(self.it), seed=self.seed)
        self.consumed += 1
        return out

    def close(self):
        """Stop the loader's threads and free the model and its state."""
        import torch
        self.it.close()
        del self.it, self.model, self.opt, self.step_fn
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()


def measure(prog, seconds, device):
    """The window: steps on the loader's batches for ``seconds`` of host
    time, each start marked on the device's stream, no sync until the end.
    Returns (marks, end mark, losses, host spans, steps that raised)."""
    marks, losses = [], []
    waits, dispatch = [], []
    pc = time.perf_counter
    load0, cpu0 = os.getloadavg()[0], time.process_time()
    t_stop = pc() + seconds
    raised = 0
    while pc() < t_stop:
        marks.append(_mark(device))
        t0 = pc()
        try:
            batch = next(prog.it)
            t1 = pc()
            out = prog.step_fn(batch, seed=prog.seed)
        except StopIteration:
            raise RuntimeError("the cell's data ran out inside the window: "
                               "its traffic file needs more samples")
        except Exception:   # noqa: BLE001 - a failed step is counted
            traceback.print_exc()
            raised += 1
            marks.pop()
            break
        prog.consumed += 1
        t2 = pc()
        waits.append(t1 - t0)
        dispatch.append(t2 - t1)
        losses.append(out["loss"])
    end = _mark(device)
    _sync(device)
    wall = pc() - (t_stop - seconds)
    return marks, end, losses, {
        "loader_wait": waits, "step": dispatch, "wall": wall,
        "host": {"load1_before": load0, "load1_after": os.getloadavg()[0],
                 "cpu_share": (time.process_time() - cpu0) / wall}}, raised


def trace_steps(prog, n, device):
    """``n`` steps under ``torch.profiler`` (the card's activity only: CPU
    op records would slow the host-paced steps they measure), after a
    warm-up step whose records are dropped. The host's loader waits and
    dispatches are timed on its clock, and a marker kernel launched on the
    idle card at a known host time ties that clock to the trace's. Returns
    the trace summary the per-layer readers take."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    from lddl_tpu_torch.ops import flash_attention as fa
    from .trace import summarize
    cuda = device.type == "cuda"
    pc = time.perf_counter
    spans = {"loader wait": [], "step dispatch": []}
    launches, indices = [], []
    with profile(activities=[ProfilerActivity.CUDA if cuda
                             else ProfilerActivity.CPU],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        prog.step()
        _sync(device)
        prof.step()
        t_mark = pc()
        if cuda:
            torch.cuda._sleep(1000)
        for _ in range(n):
            before = {w: getattr(fa, w).launches for w in KERNEL_WRAPPERS}
            t0 = pc()
            batch = next(prog.it)
            t1 = pc()
            prog.step_fn(batch, seed=prog.seed)
            spans["loader wait"].append((t0, t1))
            spans["step dispatch"].append((t1, pc()))
            prog.consumed += 1
            launches.append({w: getattr(fa, w).launches - before[w]
                             for w in KERNEL_WRAPPERS})
            indices.append(prog.consumed - 1)
        _sync(device)
        window = pc() - t_mark
        prof.step()
    return summarize(prof, t_mark, window, spans, launches, indices)


def check_readings(prog_r, ref_r):
    """The numbers the output check compares: the largest relative gap of a
    check step's loss, and by the worst leaf the gap between the program's
    and the reference's norms of each check step's gradient and of the
    change over the check steps, each over the reference's norm of that
    leaf or of the median leaf, whichever is larger. Leaves whose
    reference gradient is below a thousandth of the median leaf's (nought
    but rounding, as a key's bias under softmax) are left out: of a step's
    gradient by that step's, of the change by the first step's."""
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog_r["loss"],
                                                   ref_r["loss"]))

    def counted(grad):
        med = statistics.median(grad.values())
        return [k for k, g in grad.items() if g >= 1e-3 * med], med

    def worst(prog, ref, leaves, med):
        return max(abs(prog[k] - ref[k]) / max(ref[k], med) for k in leaves)

    grad = max(worst(p, r, *counted(r)) for p, r in zip(prog_r["grad"],
                                                         ref_r["grad"]))
    leaves, _ = counted(ref_r["grad"][0])
    change = ref_r["change"]
    return {"loss_gap": loss, "grad_gap": grad,
            "update_gap": worst(prog_r["change"], change, leaves,
                                statistics.median(change[k]
                                                  for k in leaves))}


def reference_readings(cell, seed, batches, device, precision="fp32",
                       rows=None):
    """The plain reference (``precision`` fp32) or the control (fp8) over
    the check batches, from the same weights: each step's loss and clipped
    gradient's norm a leaf, each leaf's change. ``rows`` keeps only that
    many rows of each batch (a planted fault)."""
    import torch
    from .reference import common
    ref, cfg = cell.family.REFERENCE, cell.cfg
    common.exact_matmuls()
    prec = common.Precision(precision)
    p = ref.hidden_dropout(cfg)
    W = {k: v.clone().requires_grad_(True) for k, v in
         common.make_weights(ref.param_specs(cfg), seed, device).items()}
    w0 = {k: v.detach().clone() for k, v in W.items()}
    opt = common.ClippedAdamW(cell.cfg["optimizer"])
    losses, norms = [], []
    for n, batch in enumerate(batches):
        t = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        if rows is not None:
            t = {k: v[:rows] for k, v in t.items()}
        keep = common.dropout_masks(seed, n, ref.dropout_shapes(cfg, t), p,
                                    device)
        for w in W.values():
            w.grad = None
        losses.append(ref.loss_and_grads(cfg, W, t, keep, p, prec,
                                         cell.family.REFERENCE_BLOCK))
        grads = opt.clip({k: w.grad for k, w in W.items()})
        norms.append({k: float(torch.linalg.vector_norm(g))
                      for k, g in grads.items()})
        opt.update({k: w.data for k, w in W.items()}, grads)
    change = {k: float(torch.linalg.vector_norm(W[k].detach() - w0[k]))
              for k in W}
    del W, w0, opt
    return {"loss": losses, "grad": norms, "change": change}


def run(cell, seed, seconds, trace, device, t_start):
    """One run of ``cell`` on ``device``, ``t_start`` the process's start
    (``time.time()``). Returns the result (``correct``, ``attempted``,
    ``failed``, ``metrics``, ``memory_peak_bytes`` and with ``trace``
    ``busy_s``, ``window_s`` and ``breakdown``) and the numbers compared,
    each with its limit."""
    import torch
    workdir = tempfile.mkdtemp(prefix="portbench-")
    try:
        if trace:
            # The program's registry: the loader's stage counters.
            os.environ["LDDL_TPU_METRICS_DIR"] = os.path.join(workdir,
                                                              "metrics")
        prog = Program(cell, seed, device, workdir)
        setup_s = time.time() - t_start
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        before = _program_counters() if trace else None
        first = prog.consumed
        marks, end, losses, spans, raised = measure(prog, seconds, device)
        after = _program_counters() if trace else None
        stats = [cell.family.batch_stats(cell.cfg, b) for b in
                 prog.recorder.batches[first:first + len(marks)]]
        e2e = (window_metrics(marks, end, stats,
                              lambda a, b: a.elapsed_time(b) / 1e3)
               if marks else {"window_s": 0.0, "by_quarter": []})
        e2e["setup_s"] = setup_s
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
        loss_values = torch.stack(losses).float().tolist() if losses else []
        failed = raised + sum(1 for x in loss_values if not math.isfinite(x))
        summary = None
        if trace:
            summary = trace_steps(prog, cell.traffic["trace_steps"], device)
            summary["step_stats"] = [
                cell.family.batch_stats(cell.cfg, prog.recorder.batches[i])
                for i in summary["batch_indices"]]
        served = prog.recorder.batches[:prog.consumed]
        index, prog_readings = prog.index, prog.readings
        shapes = prog.shapes
        prog.close()
        del prog
        mismatches, rows, faults = cell.family.check_batches(
            index, cell.traffic, served)
        ref_readings = reference_readings(cell, seed, served[:len(shapes)],
                                          device)
    finally:
        os.environ.pop("LDDL_TPU_METRICS_DIR", None)
        shutil.rmtree(workdir, ignore_errors=True)
    numbers = dict(data_mismatches=mismatches,
                   **check_readings(prog_readings, ref_readings))
    compared = {k: (numbers[k], cell.limits[k]) for k in cell.limits}
    correct = (failed == 0 and len(marks) > 0
               and all(v <= lim for v, lim in compared.values()))
    if trace:
        ctx = {"spans": spans, "counters": (before, after),
               "trace": summary}
        metrics = per_layer_metrics(cell, ctx)
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] in e2e}
    result = {"correct": correct, "attempted": len(marks) + raised,
              "failed": failed, "metrics": metrics,
              "memory_peak_bytes": peak,
              "notes": {"steps": len(marks), "window_s": e2e["window_s"],
                        "step_ms_by_quarter": e2e["by_quarter"],
                        "host": spans["host"],
                        "rows_checked": rows, "data_faults": faults,
                        "check_steps": shapes,
                        "program": prog_readings["loss"],
                        "reference": ref_readings["loss"]}}
    if trace:
        result.update(busy_s=summary["busy_s"], window_s=summary["window_s"],
                      breakdown=summary["breakdown"])
        result["notes"].update(device_events=summary["device_events"],
                               marker=summary["marker"])
    return result, compared


def _program_counters():
    """The program's loader counters so far: stage seconds and batches."""
    from lddl_tpu_torch import observability as obs
    from lddl_tpu_torch.observability import attribution
    reg = obs.registry()

    def total(name):
        m = reg.get(name)
        return m.total() if m is not None else 0.0

    return {"stage_s": attribution.stage_seconds(),
            "loader_batches": total("loader_batches_total"),
            "prefetch_batches": total("loader_prefetch_batches_total")}
