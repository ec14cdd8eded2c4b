#!/usr/bin/env python3
"""Where the fp32 online backward pair's time goes at D=256, by phase
removal, on one NVIDIA GPU.

Run from the repository root on a machine with an NVIDIA GPU and nvcc::

    python3 chip_f32_phases.py [VARIANT ...]

Each variant is a copy of ``lddl_tpu_torch/ops/csrc`` with one text
substitution in ``attention_f32_bwd.cu`` or a header (the table
``VARIANTS`` below; ``base`` is the source as it stands). All copies are
built at once, one nvcc each, into a temporary directory; then each
build's ``online_bwd_dq`` and ``online_bwd_dkv`` are timed at phase 16's
shape (B=8, H=3, L=1024, D=256, padding masks, seed 7) in turns (the
variants in order, then in reverse), through the port's wrappers with
the library swapped in. A variant's results are wrong and its time is
what the removed work cost; the compiler also drops whatever fed only
the removed work. Prints ptxas's register and spill summary of the two
D=256 kernels of each build and one ``phases`` line per variant with its
two times of each kernel and its max error against the plain versions
(of max |ref|), and the card's name and power limit. Exits non-zero
without a CUDA device or when a build fails.
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
SHAPE = (8, 1024, 3, 256)

_SCORES = "      item_scores(sm, wg, s, wtid, mine);"
_RS32 = """template <>
__device__ __forceinline__ void wgmma_rs_tf32<32>(float (&d)[16],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\\n.reg .pred p;\\nsetp.ne.b32 p, %21, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " LDDL_D16
      ", {%16, %17, %18, %19}, %20, p, 1, 1;\\n}\\n"
      : LDDL_OUT16(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

"""
_RS64 = ("template <>\n__device__ __forceinline__ void wgmma_rs_tf32<64>"
         "(float (&d)[32],")
_SPLIT = tuple("      split_tf32_bits({}, {}, {});".format(*a) for a in (
    ("xa[j].x", "h0[0]", "l0[0]"), ("xb[j].x", "h0[1]", "l0[1]"),
    ("xa[j].y", "h0[2]", "l0[2]"), ("xb[j].y", "h0[3]", "l0[3]"),
    ("xa[j].z", "h1[0]", "l1[0]"), ("xb[j].z", "h1[1]", "l1[1]"),
    ("xa[j].w", "h1[2]", "l1[2]"), ("xb[j].w", "h1[3]", "l1[3]")))

# name: [(file, text, replacement), ...]; every text must occur.
VARIANTS = {
    "base": [],
    # The score products (the item's A fragments split, the wgmma).
    "noscores": [(SOURCE, _SCORES, "      for (int q_ = 0; q_ < P::TR / 2; "
                  "++q_) mine[q_] = 0.0f;")],
    # The split of the item's A fragments (their loads go with it).
    "noasplit": [("tf32x3_tiles.cuh", line, "      {} = {} = j + b;".format(
        *line[line.index("(") + 1:line.rindex(")")].split(", ")[1:]))
        for line in _SPLIT],
    # Half the score products' k8 steps.
    "halfk": [("tf32x3_tiles.cuh", "  for (int b = 0; b < KS / G; ++b) {",
               "  for (int b = 0; b < KS / G / 2; ++b) {")],
    # The split of each landed tile (natural hi/lo and transposed).
    "nosplittile": [(SOURCE, "      split_tile_inplace(sm, s, threadIdx.x);",
                     "      copy_slices(sm, s, threadIdx.x);")],
    # The transposed copy alone.
    "notranspose": [("tf32x3_tiles.cuh",
                     "  if (o < P::NT) {\n    const int kl",
                     "  if (o < 0) {\n    const int kl")],
    # The contracting products.
    "nocontract": [(SOURCE, "      contract_wide(sm, ",
                    "      if (0) contract_wide(sm, ")],
    # The warpgroups' swap of their score tiles.
    "noexchange": [(SOURCE,
                    "      exchange_scores(sm, wg, wtid, mine, other);",
                    "      for (int q_ = 0; q_ < P::TR / 2; ++q_) "
                    "other[q_] = mine[q_];")],
    # The score wgmma at twice the N (the extra columns read the next
    # panel's rows and are dropped): the same count of instructions.
    "ndouble": [("hopper_tiles.cuh", _RS64, _RS32 + _RS64),
                ("tf32x3_tiles.cuh", "  float acc[NACC][TR / 2];\n",
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
        for fname, old, new in VARIANTS[name]:
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
             os.path.join(d, SOURCE)], stdout=log, stderr=subprocess.STDOUT),
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
            for entry, n_ptr in fa._ENTRY_POINTS[fa.F32_BWD_SOURCE].items():
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
        refs = {"online_bwd_dq": fa.online_bwd_dq_plain(*args),
                "online_bwd_dkv": fa.online_bwd_dkv_plain(*args)[0]}
        times = {n: {w: [] for w in refs} for n in loaded}
        errs = {}
        orig = fa._lib
        try:
            for name in list(loaded) + list(reversed(list(loaded))):
                fa._lib = (lambda src, lib=loaded[name]:
                           lib if src == fa.F32_BWD_SOURCE else orig(src))
                for w in refs:
                    fn = getattr(fa, w)
                    times[name][w].append(cs.cuda_time_ms(lambda: fn(*args)))
                    out = fn(*args)
                    out = out[0] if isinstance(out, tuple) else out
                    errs[(name, w)] = cs.rel_err(out, refs[w])
        finally:
            fa._lib = orig
        for name in loaded:
            print("phases B={} L={} H={} D={} {}: {} max err {}".format(
                b, l, h, d, name,
                {w: [round(x, 4) for x in t] for w, t in times[name].items()},
                {w: "{:.1e}".format(errs[(name, w)]) for w in refs}),
                flush=True)
        print(cs.card_line(), flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
