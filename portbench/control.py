"""Readings that set a cell's limits: the program against the plain
reference over many seeds, and what the control and the planted faults
read against it.

    python3 -m portbench.control --workload <name> --seeds 1,2,3 \
        [--control-seeds 1,2,3] [--out readings.jsonl]

For each seed: the run's set-up and check steps at the cell's own sizes
(the window is not needed: the check compares the check steps), the data
check, then the reference in float32, and for the control seeds the
control (the reference with its activations and products rounded to fp8
e4m3, gradients e5m2, each scaled per tensor: the step below the
configuration's bf16), the reference over half of each batch (a step that
leaves half the batch out and takes the mean over the rest) and the data
check over batches with one token altered where the loader produced it.
A step that returns its state unchanged reads 1 on ``grad_gap`` and
``update_gap`` by their definition and needs no run. One JSON line a
seed, then one with each number's lower reading (the largest of the
program's) and its upper readings (the smallest of the control's and of
each fault's).
"""

import argparse
import json
import shutil
import sys
import tempfile

from .data import FIRST_ID
from .harness import (Program, check_readings, find_cell,
                      reference_readings)


def seed_readings(cell, seed, device, control):
    """{source: {number: value}} of one seed: ``program`` and, with
    ``control``, ``control``, ``half_batch`` and ``token``."""
    import copy
    workdir = tempfile.mkdtemp(prefix="portbench-control-")
    try:
        prog = Program(cell, seed, device, workdir)
        served = prog.recorder.batches[:prog.consumed]
        index, prog_r = prog.index, prog.readings
        prog.close()
        del prog
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    check = cell.family.check_batches
    ref = reference_readings(cell, seed, served, device)
    out = {"program": dict(check_readings(prog_r, ref),
                           data_mismatches=check(index, cell.traffic,
                                                 served)[0])}
    if control:
        out["control"] = check_readings(
            reference_readings(cell, seed, served, device, "fp8"), ref)
        rows = served[0]["input_ids"].shape[0] // 2
        out["half_batch"] = check_readings(
            reference_readings(cell, seed, served, device, rows=rows), ref)
        altered = copy.deepcopy(served)
        for b in altered:
            b["labels"][0, 1] = FIRST_ID + (b["labels"][0, 1] == FIRST_ID)
        out["token"] = {"data_mismatches": check(index, cell.traffic,
                                                 altered)[0]}
    return out


def summarize(per_seed):
    """Each number's lower reading (the largest the program gives) and
    upper readings (the smallest the control and each fault give)."""
    summary = {}
    for source in ("program", "control", "half_batch", "token"):
        rows = [r[source] for r in per_seed if source in r]
        if not rows:
            continue
        pick = max if source == "program" else min
        summary[source] = {k: pick(r[k] for r in rows) for k in rows[0]}
    return summary


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--out")
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("portbench.control: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = find_cell(args.workload)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    per_seed = []
    for s in (int(x) for x in args.seeds.split(",")):
        r = dict(seed=s, **seed_readings(cell, s, device, s in controls))
        per_seed.append(r)
        print(json.dumps(r), flush=True)
    summary = summarize(per_seed)
    print(json.dumps({"summary": summary}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            for r in per_seed + [{"summary": summary}]:
                f.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
