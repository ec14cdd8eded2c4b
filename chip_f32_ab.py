#!/usr/bin/env python3
"""The fp32 attention kernels of two checkouts on one card, in turns.

Run from the repository root on a machine with an NVIDIA GPU::

    python3 chip_f32_ab.py OTHER_CHECKOUT

where OTHER_CHECKOUT holds another commit's ``lddl_tpu_torch`` (for
example ``git archive <commit> lddl_tpu_torch | tar -x -C DIR``). Each
measurement runs in a process of its own, OTHER first, in the order
other, this, this, other:

- the fp32 kernels' device time at the main paths' shapes, as
  ``chip_smoke.time_f32_kernels`` takes it (padding masks, seed 7):
  ``onekv_fwd`` and ``onekv_bwd`` at B=16, H=16, L=512 and
  ``online_fwd``, ``online_bwd_dq`` and ``online_bwd_dkv`` at B=8, H=12,
  L=1024, all D=64, the same five at D=128 (B=16, H=8, L=512 and B=8,
  H=6, L=1024, keyed with a ``_d128`` suffix), and the online trio at
  phase 16's D=256 shape (B=8, H=3, L=1024, ``_d256``); and a sha256 of
  each kernel's outputs there, so that the script says which kernels
  give bit-identical outputs in both checkouts;
- then, once each (other, this), chip_smoke's phases 17-19 (bert_large
  and bart_base at fp32, and bart_base at three heads, D=256, in fp32)
  with their profiled step, which prints the fp32 attention kernels'
  share of a step's device time.

This script's ``chip_smoke.py`` drives both checkouts; only the kernels
and the modules under them come from the checkout measured. Prints one
``AB <checkout> {...}`` line per timing turn, an ``outputs`` line per
turn with its sha256s, and one ``identical`` line ({kernel: whether this
checkout's outputs are the other's, bit for bit}). Exits non-zero
without a CUDA device or when a child fails.
"""

import hashlib
import json
import math
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def child(tree, what):
    """In a child process: import ``lddl_tpu_torch`` from ``tree`` and
    this directory's ``chip_smoke``, then measure ``what``."""
    import importlib.util
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = cs
    spec.loader.exec_module(cs)
    cs.torch = torch
    from lddl_tpu_torch.ops import flash_attention as fa

    if what == "profile":
        card, shared = cs.card_line(), {}
        cs.bert_path(fa, card, shared, torch.float32)
        cs.bart_path(fa, card, shared, dtype=torch.float32)
        cs.bart_path(fa, card, shared, cs.BART_D256_HEADS,
                     dtype=torch.float32)
        return
    out, sums = {}, {}
    for (b, l, h, d), names in (((16, 512, 16, 64), ("onekv_fwd",
                                                     "onekv_bwd")),
                                ((8, 1024, 12, 64), ("online_fwd",
                                                     "online_bwd_dq",
                                                     "online_bwd_dkv")),
                                ((16, 512, 8, 128), ("onekv_fwd",
                                                     "onekv_bwd")),
                                ((8, 1024, 6, 128), ("online_fwd",
                                                     "online_bwd_dq",
                                                     "online_bwd_dkv")),
                                ((8, 1024, 3, 256), ("online_fwd",
                                                     "online_bwd_dq",
                                                     "online_bwd_dkv"))):
        q, k, v, do, mask = cs.attention_inputs(b, l, h, d, seed=7,
                                                dtype=torch.float32)
        qb, kb, vb, maskb, qmaskb, _ = fa._prep(q, k, v, mask, None)
        scale = 1.0 / math.sqrt(d)
        plain = fa.onekv_fwd_plain if fa._use_onekv(l, d) \
            else fa.online_fwd_plain
        o, lse = plain(qb, kb, vb, maskb, qmaskb, scale)
        dob = fa._prep_one(do, l)
        delta = (dob * o).sum(-1)
        fwd_in = (qb, kb, vb, maskb, qmaskb, scale)
        bwd_in = (qb, kb, vb, maskb, qmaskb, dob, lse, delta, scale)
        for name in names:
            fn = getattr(fa, name)
            args = fwd_in if name.endswith("_fwd") else bwd_in
            key = name + ("" if d == 64 else "_d{}".format(d))
            out[key] = cs.cuda_time_ms(lambda: fn(*args))
            got = fn(*args)
            digest = hashlib.sha256()
            for t in got if isinstance(got, tuple) else (got,):
                digest.update(t.cpu().numpy().tobytes())
            sums[key] = digest.hexdigest()
    print("AB {} {} ({})".format(tree, json.dumps(out), cs.card_line()),
          flush=True)
    print("outputs {} {}".format(tree, json.dumps(sums)), flush=True)


def main():
    if len(sys.argv) == 4 and sys.argv[1] == "--child":
        child(sys.argv[2], sys.argv[3])
        return 0
    if len(sys.argv) != 2:
        print("usage: chip_f32_ab.py OTHER_CHECKOUT", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_f32_ab: no CUDA device is available", file=sys.stderr)
        return 1
    other = sys.argv[1]
    runs = [(t, "time") for t in (other, HERE, HERE, other)]
    runs += [(other, "profile"), (HERE, "profile")]
    sums = {}
    for tree, what in runs:
        print("== {} {}".format(what, tree), flush=True)
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--child", tree, what], timeout=900,
                              stdout=subprocess.PIPE, text=True)
        print(proc.stdout, end="", flush=True)
        if proc.returncode != 0:
            print("chip_f32_ab: {} of {} exited {}".format(
                what, tree, proc.returncode), file=sys.stderr)
            return 1
        for line in proc.stdout.splitlines():
            if line.startswith("outputs "):
                sums.setdefault(tree, []).append(
                    json.loads(line.split(" ", 2)[2]))
    for tree, turns in sums.items():
        if any(t != turns[0] for t in turns):
            print("chip_f32_ab: outputs of {} differ between its turns: "
                  "{}".format(tree, turns), file=sys.stderr)
            return 1
    print("identical {}".format(json.dumps(
        {k: v == sums[other][0].get(k) for k, v in sums[HERE][0].items()})),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
