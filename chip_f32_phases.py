#!/usr/bin/env python3
"""Where the fp32 online kernels' time goes at D=256, by phase removal,
on one NVIDIA GPU.

Run from the repository root on a machine with an NVIDIA GPU and nvcc::

    python3 chip_f32_phases.py [VARIANT ...]

Each variant is a copy of ``lddl_tpu_torch/ops/csrc`` with text
substitutions in its source (``attention_f32_bwd.cu``, the online
backward pair, or ``attention_f32_fwd.cu``, the online forward: the
``fwd_`` variants) or a header (the table ``VARIANTS`` below; ``base``
and ``fwd_base`` are the sources as they stand). All copies are built at
once, one nvcc each, into a temporary directory; then each build's
D=256 kernels (``online_bwd_dq`` and ``online_bwd_dkv``, or
``online_fwd``) are timed at phase 16's shape (B=8, H=3, L=1024, D=256,
padding masks, seed 7) in turns (the variants in order, then in
reverse), through the port's wrappers with the library swapped in. A
variant's results are wrong and its time is what the removed work cost;
the compiler also drops whatever fed only the removed work. Prints
ptxas's register and spill summary of the D=256 kernels of each build
and one ``phases`` line per variant with its two times of each kernel
and its max error against the plain versions (of max |ref|; O for the
forward), and the card's name and power limit. Exits non-zero without a
CUDA device or when a build fails.
"""

import ctypes
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(HERE, "lddl_tpu_torch", "ops", "csrc")
SOURCE = "attention_f32_bwd.cu"
FWD = "attention_f32_fwd.cu"
# The wrappers whose D=256 kernels each source's variants time.
TIMED = {SOURCE: ("online_bwd_dq", "online_bwd_dkv"), FWD: ("online_fwd",)}
SHAPE = (8, 1024, 3, 256)

_SCORES = "      item_scores(sm, wg, wg, 0, s, wtid, mine);"
_FWD_SCORES = "      item_scores(sm, 0, 1, wg * P::SK, 0, wtid, mine);"
_ZERO_MINE = "      for (int q_ = 0; q_ < P::TR / 2; ++q_) mine[q_] = 0.0f;"
_EXCHANGE = "      exchange_scores(sm, wg, wtid, mine, other);"
_NO_EXCHANGE = ("      for (int q_ = 0; q_ < P::TR / 2; ++q_) "
                "other[q_] = mine[q_];")
_SPLIT_TILE = "      split_tile_inplace(sm, s, threadIdx.x);"
_NO_SPLIT_TILE = "      copy_slices(sm, s, threadIdx.x);"
_FWD_SPLIT_TILE = "      split_tile_inplace(sm, 0, threadIdx.x);"
_FWD_NO_SPLIT_TILE = "      copy_slices(sm, 0, threadIdx.x);"
_SPLIT = tuple("      split_tf32_bits({}, {}, {});".format(*a) for a in (
    ("xa[j].x", "h0[0]", "l0[0]"), ("xb[j].x", "h0[1]", "l0[1]"),
    ("xa[j].y", "h0[2]", "l0[2]"), ("xb[j].y", "h0[3]", "l0[3]"),
    ("xa[j].z", "h1[0]", "l1[0]"), ("xb[j].z", "h1[1]", "l1[1]"),
    ("xa[j].w", "h1[2]", "l1[2]"), ("xb[j].w", "h1[3]", "l1[3]")))

_NO_ASPLIT = [("tf32x3_tiles.cuh", line, "      {} = {} = j + b;".format(
    *line[line.index("(") + 1:line.rindex(")")].split(", ")[1:]))
    for line in _SPLIT]

# name: (source built, [(file, text, replacement), ...]); every text must
# occur.
VARIANTS = {
    "base": [],
    # The score products (the item's A fragments split, the wgmma).
    "noscores": [(SOURCE, _SCORES, _ZERO_MINE)],
    # The split of the item's A fragments (their loads go with it).
    "noasplit": _NO_ASPLIT,
    # Half the score products' k8 steps.
    "halfk": [("tf32x3_tiles.cuh", "  for (int b = 0; b < KS / G; ++b) {",
               "  for (int b = 0; b < KS / G / 2; ++b) {")],
    # The split of each landed tile (natural hi/lo and transposed).
    "nosplittile": [(SOURCE, _SPLIT_TILE, _NO_SPLIT_TILE)],
    # The transposed copy alone.
    "notranspose": [("tf32x3_tiles.cuh",
                     "  if (o < P::NT) {\n    const int kl",
                     "  if (o < 0) {\n    const int kl")],
    # The contracting products.
    "nocontract": [(SOURCE, "      contract_wide(sm, ",
                    "      if (0) contract_wide(sm, ")],
    # The warpgroups' swap of their score tiles.
    "noexchange": [(SOURCE, _EXCHANGE, _NO_EXCHANGE)],
    # The score wgmma at twice the N (the extra columns read the next
    # panel's rows and are dropped): the same count of instructions.
    "ndouble": [("tf32x3_tiles.cuh", "  float acc[NACC][TR / 2];\n",
                 "  float acc[NACC][TR];\n"),
                ("tf32x3_tiles.cuh",
                 "      wgmma_rs_tf32<TR>(acc[k % NACC], fl[set][kk],",
                 "      wgmma_rs_tf32<2 * TR>(acc[k % NACC], fl[set][kk],"),
                ("tf32x3_tiles.cuh",
                 "      wgmma_rs_tf32<TR>(acc[k % NACC], fh[set][kk],",
                 "      wgmma_rs_tf32<2 * TR>(acc[k % NACC], fh[set][kk],")],
    # Two score accumulators in place of four.
    "nacc2": [(SOURCE, "  static constexpr int NACC = 4;",
               "  static constexpr int NACC = 2;")],
    # A third landing stage for dK/dV.
    "ls3": [(SOURCE, "  static constexpr int LS = DKV ? 2 : 1;",
             "  static constexpr int LS = DKV ? 3 : 1;")],
}
VARIANTS = {name: (SOURCE, subs) for name, subs in VARIANTS.items()}
VARIANTS.update({
    # The online forward at D=256 as it stands.
    "fwd_base": (FWD, []),
    # Its score products (Q's A fragments split, the wgmma).
    "fwd_noscores": (FWD, [(FWD, _FWD_SCORES, _ZERO_MINE)]),
    # The split of Q's A fragments (their loads go with it).
    "fwd_noasplit": (FWD, _NO_ASPLIT),
    # The warpgroups' swap of their halves of S.
    "fwd_noexchange": (FWD, [(FWD, _EXCHANGE, _NO_EXCHANGE)]),
    # P V.
    "fwd_nopv": (FWD, [(FWD, "      contract_wide(sm, ",
                        "      if (0) contract_wide(sm, ")]),
    # The split of each landed K/V tile (K in place, V^T).
    "fwd_nosplittile": (FWD, [(FWD, _FWD_SPLIT_TILE, _FWD_NO_SPLIT_TILE)]),
    # K/V tiles of 16 rows: twice the score wgmma and the tiles.
    "fwd_tr16": (FWD, [(FWD, "  static constexpr int TR = 32; ",
                        "  static constexpr int TR = 16; ")]),
})


def build(names, root):
    """One copy of csrc a variant under ``root``, built all at once;
    returns {name: library path}."""
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from lddl_tpu_torch.ops import _build
    procs = {}
    for name in names:
        d = os.path.join(root, name)
        shutil.copytree(CSRC, d)
        source, subs = VARIANTS[name]
        for fname, old, new in subs:
            path = os.path.join(d, fname)
            with open(path) as f:
                text = f.read()
            if old not in text:
                raise SystemExit("variant {}: {!r} is not in {}".format(
                    name, old, fname))
            with open(path, "w") as f:
                f.write(text.replace(old, new))
        out = os.path.join(d, "lib.so")
        log = open(os.path.join(d, "build.log"), "w")
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", out,
             os.path.join(d, source)], stdout=log, stderr=subprocess.STDOUT),
            out, log)
    libs = {}
    for name, (proc, out, log) in procs.items():
        proc.wait()
        log.close()
        with open(log.name) as f:
            text = f.read()
        if proc.returncode != 0:
            print(text[-4000:], file=sys.stderr)
            raise SystemExit("variant {}: nvcc exited {}".format(
                name, proc.returncode))
        print("ptxas {}: {}".format(name, {
            "{}<{}>".format(k[0], k[1]): v
            for k, v in cs.ptxas_summary(text).items() if k[1] == 256}),
            flush=True)
        libs[name] = out
    return libs


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_f32_phases: no CUDA device is available",
              file=sys.stderr)
        return 1
    names = sys.argv[1:] or list(VARIANTS)
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        print("unknown variants {}; known: {}".format(
            unknown, ", ".join(VARIANTS)), file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    cs.torch = torch
    from lddl_tpu_torch.ops import flash_attention as fa
    root = tempfile.mkdtemp(prefix="chip_f32_phases_")
    try:
        t0 = time.perf_counter()
        libs = build(names, root)
        print("build: {:.1f} s".format(time.perf_counter() - t0), flush=True)
        loaded = {}
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        for name, path in libs.items():
            lib = ctypes.CDLL(path)
            source = VARIANTS[name][0][:-len(".cu")]
            for entry, n_ptr in fa._ENTRY_POINTS[source].items():
                fn = getattr(lib, entry)
                fn.argtypes = [vp] * n_ptr + [i, i, i, i, f, vp]
                fn.restype = i
            lib.lddl_cuda_error_string.argtypes = [i]
            lib.lddl_cuda_error_string.restype = ctypes.c_char_p
            loaded[name] = lib

        b, l, h, d = SHAPE
        q, k, v, do, mask = cs.attention_inputs(b, l, h, d, seed=7,
                                                dtype=torch.float32)
        qb, kb, vb, maskb, qmaskb, _ = fa._prep(q, k, v, mask, None)
        scale = 1.0 / math.sqrt(d)
        o, lse = fa.online_fwd_plain(qb, kb, vb, maskb, qmaskb, scale)
        dob = fa._prep_one(do, l)
        delta = (dob * o).sum(-1)
        args = (qb, kb, vb, maskb, qmaskb, dob, lse, delta, scale)
        # (arguments, the plain version's first output) of each wrapper
        refs = {"online_fwd": ((qb, kb, vb, maskb, qmaskb, scale), o),
                "online_bwd_dq": (args, fa.online_bwd_dq_plain(*args)),
                "online_bwd_dkv": (args, fa.online_bwd_dkv_plain(*args)[0])}
        times = {n: {w: [] for w in TIMED[VARIANTS[n][0]]} for n in loaded}
        errs = {}
        orig = fa._lib
        try:
            for name in list(loaded) + list(reversed(list(loaded))):
                source = VARIANTS[name][0][:-len(".cu")]
                fa._lib = (lambda src, lib=loaded[name], source=source:
                           lib if src == source else orig(src))
                for w in times[name]:
                    fn, (w_args, ref) = getattr(fa, w), refs[w]
                    times[name][w].append(
                        cs.cuda_time_ms(lambda: fn(*w_args)))
                    out = fn(*w_args)
                    out = out[0] if isinstance(out, tuple) else out
                    errs[(name, w)] = cs.rel_err(out, ref)
        finally:
            fa._lib = orig
        for name in loaded:
            print("phases B={} L={} H={} D={} {}: {} max err {}".format(
                b, l, h, d, name,
                {w: [round(x, 4) for x in t] for w, t in times[name].items()},
                {w: "{:.1e}".format(errs[(name, w)]) for w in times[name]}),
                flush=True)
        print(cs.card_line(), flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
