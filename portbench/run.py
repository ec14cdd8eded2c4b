"""Run one cell of the benchmark once and print its result line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout on a machine with the cards the cell asks
for. The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` and, with ``--trace
1``, ``breakdown``; ``checks`` last: each number of the output check with
its limit); the same numbers end standard error. Exits non-zero, printing
no result, without a CUDA card, or if the process has loaded JAX or the
JAX package once the window has closed.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

# Whole top-level module names the run must never hold.
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "lddl_tpu")


def forbidden_modules(modules=None):
    """Top-level names in ``modules`` (default ``sys.modules``) that are
    JAX or the JAX package, compared whole: ``lddl_tpu_torch`` is not
    ``lddl_tpu``."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None
                                          else modules)}
    return sorted(names & set(FORBIDDEN))


def result_line(result, compared, device_info):
    """The printed object: the result's keys, ``checks`` last."""
    out = {"correct": result["correct"], "attempted": result["attempted"],
           "failed": result["failed"], "metrics": result["metrics"],
           "device": device_info}
    if "breakdown" in result:
        out["breakdown"] = result["breakdown"]
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in compared.items()}
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from .harness import find_cell, run
    cell = find_cell(args.workload)
    import torch
    chips = cell.chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print("portbench: the cell needs {} CUDA card(s); this machine has "
              "{}".format(chips, torch.cuda.device_count()
                          if torch.cuda.is_available() else 0),
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result, compared = run(cell, args.seed, args.seconds, bool(args.trace),
                           device, T_START)
    found = forbidden_modules()
    if found:
        print("portbench: the run loaded {}".format(", ".join(found)),
              file=sys.stderr)
        return 3
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips, "memory_peak_bytes": result["memory_peak_bytes"]}
    if args.trace:
        info.update(busy_s=result["busy_s"], window_s=result["window_s"])
    print("portbench: {}".format(json.dumps(result["notes"])),
          file=sys.stderr)
    for name, (value, limit) in compared.items():
        print("check {} {} limit {}".format(name, value, limit),
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result_line(result, compared, info)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
