"""Generate unicode_tables.h for the native engine.

The port's own copy of ``lddl_tpu/native/gen_tables.py``. The generated
header is committed beside it and is never regenerated by a build or a
run. The HF-side tables are probed from the installed HF ``tokenizers``
package, which a training host need not have; a header made without it
could emit token ids that differ from ``BertTokenizerFast``'s, so
``generate`` refuses to run without it. Regenerate the header by hand,
in an environment that has ``tokenizers`` (the probe imports it
lazily), with::

    python -m lddl_tpu_torch.native.gen_tables \
        lddl_tpu_torch/native/unicode_tables.h

and commit the result; ``tests/test_torch_native.py`` regenerates it to
a temporary path and requires the committed header to equal it.

The C++ engine must match two Python-side semantics exactly:

1. the rule-based sentence splitter (``preprocess.sentences``), which
   uses Python ``re`` \\s, ``str.strip()`` whitespace, and ``str.isalpha``;
2. the HF BertNormalizer pipeline (clean_text -> chinese-char spacing ->
   NFD accent strip -> lowercase) used by BertTokenizerFast, whose helper
   predicates (is_whitespace / is_control / is_punctuation) follow the
   definitions in tokenizers' Rust BertNormalizer / BertPreTokenizer.

Rather than hand-porting Unicode behavior, we *evaluate the Python
semantics per BMP codepoint* here and bake the answers into lookup tables,
so the C++ side is table-driven and exact on the BMP. Codepoints above the
BMP use sparse binary-searched tables (flag runs + non-identity folds)
generated the same way, so astral Cf/Cc removal, astral punctuation
isolation, and cased astral scripts (e.g. Deseret) also match
BertTokenizerFast exactly.
"""

import re
import sys
import unicodedata

F_RE_SPACE = 1    # Python re \s (str patterns)
F_STR_SPACE = 2   # str.isspace() — what str.strip() removes
F_HF_WS = 4       # HF fast is_whitespace: \t\n\r or Unicode White_Space
F_HF_CTRL = 8     # HF is_control: category C*, except \t\n\r
F_HF_PUNCT = 16   # HF is_punctuation: ASCII punct ranges or category P*
F_CJK = 32        # HF chinese-char ranges (BMP part)
F_ALPHA = 64      # str.isalpha()
F_LOWER = 128     # str.islower() (single char)
F_RE_DIGIT = 256  # Python re \d (str patterns) == category Nd
F_UPPER = 512     # str.isupper() (single char)
F_RE_WORD = 1024  # Python re \w (str patterns)
# CPython str.lower()'s ONLY context-sensitive case is Final_Sigma
# (U+03A3 -> ς when preceded by a cased char, skipping case-ignorables,
# and not followed by one). The two predicates are probed from CPython
# itself rather than hand-ported property tables.
F_PY_CASED = 2048
F_PY_CASE_IGNORABLE = 4096

_RE_SPACE = re.compile(r"\s")
_RE_DIGIT = re.compile(r"\d")
_RE_WORD = re.compile(r"\w")

# HF is_chinese_char ranges (BMP + astral extension blocks).
_CJK = ((0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0xF900, 0xFAFF),
        (0x20000, 0x2A6DF), (0x2A700, 0x2B73F), (0x2B740, 0x2B81F),
        (0x2B820, 0x2CEAF), (0x2F800, 0x2FA1F))

# Unicode White_Space property (what Rust's char::is_whitespace — used by
# the HF fast BertNormalizer — matches). NOTE: several of these are also
# category C (U+0085, U+000B, U+000C); the normalizer checks is_control
# FIRST, so those are removed, not spaced — the C++ engine mirrors that
# order. Empirically verified against BertTokenizerFast.
_WHITE_SPACE = frozenset(
    [0x09, 0x0A, 0x0B, 0x0C, 0x0D, 0x20, 0x85, 0xA0, 0x1680]
    + list(range(0x2000, 0x200B)) + [0x2028, 0x2029, 0x202F, 0x205F, 0x3000])


def _flags(cp):
    c = chr(cp)
    f = 0
    if _RE_SPACE.match(c):
        f |= F_RE_SPACE
    if c.isspace():
        f |= F_STR_SPACE
    cat = unicodedata.category(c)
    if cp in _WHITE_SPACE:
        f |= F_HF_WS
    # The HF fast normalizer (Rust) removes Cc/Cf/Co/Cs but KEEPS Cn
    # (unassigned codepoints survive and join words — empirically probed:
    # U+0378/U+FDD0/U+3FFFD stay, U+E000/U+100001/U+00AD are removed).
    if c not in "\t\n\r" and cat in ("Cc", "Cf", "Co", "Cs"):
        f |= F_HF_CTRL
    if (33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96
            or 123 <= cp <= 126 or cat.startswith("P")):
        f |= F_HF_PUNCT
    if any(lo <= cp <= hi for lo, hi in _CJK):
        f |= F_CJK
    if c.isalpha():
        f |= F_ALPHA
    if c.islower():
        f |= F_LOWER
    if _RE_DIGIT.match(c):
        f |= F_RE_DIGIT
    if c.isupper():
        f |= F_UPPER
    if _RE_WORD.match(c):
        f |= F_RE_WORD
    # Probes against CPython's own Final_Sigma scan: cp is "cased" iff a
    # sigma directly after it takes the final form; "case-ignorable" iff
    # it is transparent to that backward scan (and not itself cased).
    if (c + "Σ").lower().endswith("ς"):
        f |= F_PY_CASED
    elif ("A" + c + "Σ").lower().endswith("ς"):
        f |= F_PY_CASE_IGNORABLE
    return f


def _py_lower(cp):
    """Python str.lower() per codepoint (full case mapping; may expand,
    e.g. U+0130 -> 2 codepoints). The learned splitter's punkt types are
    built with str.lower, so the C++ port needs the exact mapping."""
    return [ord(c) for c in chr(cp).lower()]


_HF_BITS = F_HF_WS | F_HF_CTRL | F_HF_PUNCT | F_CJK


def calibration_tag():
    """Identifies the environment the HF-side tables were calibrated
    against. Stamped into the generated header (``header_calibration``
    reads it back): a run checks that its ``unicodedata`` version is the
    header's, since the splitter bits are baked from it."""
    # unicodedata always contributes (splitter bits F_RE_SPACE/F_STR_SPACE/
    # F_ALPHA are baked from it), so a Python/Unicode upgrade regenerates
    # even when the tokenizers version is unchanged.
    tag = "unicodedata=" + unicodedata.unidata_version
    try:
        import tokenizers
        return "tokenizers=" + tokenizers.__version__ + ";" + tag
    except Exception:
        return tag

# Codepoints never probed: surrogates (not valid scalars) and the probe
# guard digits (digits are flag-free identity in every Unicode version).
def _probe_skip(cp):
    return 0xD800 <= cp <= 0xDFFF or 0x30 <= cp <= 0x39


def _probe_rust_tables():
    """Calibrate the HF-side behaviors (clean_text removal, whitespace,
    CJK spacing, punctuation, fold output) against the INSTALLED Rust
    ``tokenizers`` pipeline, per codepoint. Python's unicodedata and the
    Rust crates can disagree by several Unicode versions (e.g. U+10EFD is
    Mn in Unicode 15 but unknown to older Rust tables; Cn codepoints are
    kept while Co are removed) — parity is defined against
    BertTokenizerFast, so the installed Rust behavior wins. Returns
    (flags: {cp: hf_bits}, folds: {cp: [out_cps]}) or None when the
    ``tokenizers`` package is unavailable (``_make_flags_fn`` then
    refuses)."""
    try:
        from tokenizers.normalizers import BertNormalizer
        from tokenizers.pre_tokenizers import BertPreTokenizer
    except Exception:
        return None
    norm_plain = BertNormalizer(clean_text=True, handle_chinese_chars=True,
                                strip_accents=False, lowercase=False)
    norm_lower = BertNormalizer(clean_text=True, handle_chinese_chars=True,
                                strip_accents=True, lowercase=True)
    pre = BertPreTokenizer()
    cps = [cp for cp in range(0x110000) if not _probe_skip(cp)]

    def norm_probe(norm):
        # "5<cp>7" groups: '5'/'7' survive every normalizer unchanged and
        # no codepoint normalizes to a digit, so the segment between the
        # guards is exactly cp's normalized expansion.
        out = {}
        chunk_size = 4096
        for i in range(0, len(cps), chunk_size):
            chunk = cps[i:i + chunk_size]
            t = norm.normalize_str(
                "".join("5" + chr(cp) + "7" for cp in chunk))
            pos = 0
            for cp in chunk:
                assert t[pos] == "5", hex(cp)
                nxt = t.index("7", pos + 1)
                out[cp] = t[pos + 1:nxt]
                pos = nxt + 1
            assert pos == len(t)
        return out

    plain = norm_probe(norm_plain)
    lower = norm_probe(norm_lower)

    # Punctuation probe: BertPreTokenizer isolates punct codepoints.
    # "5<cp>7." groups; '.' always splits, so each group parses to
    # ["5<cp>7"] (not punct), ["5", <cp>, "7"] (punct), or ["5", "7"]
    # (whitespace).
    punct = {}
    chunk_size = 4096
    for i in range(0, len(cps), chunk_size):
        chunk = cps[i:i + chunk_size]
        toks = [t for t, _ in pre.pre_tokenize_str(
            "".join("5" + chr(cp) + "7." for cp in chunk))]
        j = 0
        for cp in chunk:
            c = chr(cp)
            if toks[j] == "5" + c + "7":
                punct[cp] = False
                j += 1
            elif toks[j] == "5" and toks[j + 1] == c and toks[j + 2] == "7":
                punct[cp] = True
                j += 3
            elif toks[j] == "5" and toks[j + 1] == "7":
                punct[cp] = False  # whitespace-split, not punctuation
                j += 2
            else:
                raise AssertionError("unparseable punct probe at "
                                     + hex(cp))
            assert toks[j] == ".", hex(cp)
            j += 1
        assert j == len(toks)

    flags = {}
    folds = {}
    for cp in cps:
        nl = plain[cp]
        f = 0
        if nl == "":
            f |= F_HF_CTRL
        elif nl == " ":
            f |= F_HF_WS
        elif len(nl) >= 3 and nl[0] == " " and nl[-1] == " ":
            assert nl == " " + chr(cp) + " ", hex(cp)
            f |= F_CJK
        if punct[cp]:
            f |= F_HF_PUNCT
        flags[cp] = f
        if not (f & (F_HF_CTRL | F_HF_WS)):
            lo = lower[cp]
            if f & F_CJK:
                assert lo[0] == " " and lo[-1] == " ", hex(cp)
                lo = lo[1:-1]
            fold = [ord(ch) for ch in lo]
            if fold != [cp]:
                assert len(fold) <= 3, hex(cp)
                folds[cp] = fold
    return flags, folds


def _make_flags_fn():
    """flags(cp): splitter bits (F_RE_SPACE/F_STR_SPACE/F_ALPHA) always
    follow Python semantics (they mirror the Python splitter); HF bits
    come from the Rust probe, which must be available."""
    probed = _probe_rust_tables()
    if probed is None:
        raise RuntimeError(
            "gen_tables needs the HF tokenizers package: without it the "
            "HF-side tables would be a unicodedata approximation")
    pflags, pfolds = probed

    def flags(cp):
        f = _flags(cp)
        if cp in pflags:
            f = (f & ~_HF_BITS) | pflags[cp]
        return f

    def fold(cp):
        return pfolds.get(cp, [cp])

    return flags, fold


def _astral_tables(flags_fn, fold_fn):
    """Sparse tables for cp >= 0x10000: contiguous same-flag runs (binary
    search by start) and non-identity fold entries (binary search by cp)."""
    run_starts, run_flags = [], []
    prev = None
    for cp in range(0x10000, 0x110000):
        f = flags_fn(cp)
        if f != prev:
            run_starts.append(cp)
            run_flags.append(f)
            prev = f
    folds = []
    for cp in range(0x10000, 0x110000):
        out = fold_fn(cp)
        if out != [cp]:
            assert len(out) <= 3
            padded = out + [0] * (3 - len(out))
            folds.append((cp, len(out), padded[0], padded[1], padded[2]))
    return run_starts, run_flags, folds


def _astral_fold_entries(fold_fn):
    """Non-identity astral fold entries only (no flag-run recompute)."""
    folds = []
    for cp in range(0x10000, 0x110000):
        out = fold_fn(cp)
        if out != [cp]:
            assert len(out) <= 3
            padded = out + [0] * (3 - len(out))
            folds.append((cp, len(out), padded[0], padded[1], padded[2]))
    return folds


def generate(out_path):
    flags_fn, fold_fn = _make_flags_fn()
    flags = [flags_fn(cp) for cp in range(0x10000)]
    astral_starts, astral_flags, astral_folds = _astral_tables(flags_fn,
                                                               fold_fn)
    astral_lowers = _astral_fold_entries(_py_lower)

    # str.lower() table (BMP): only non-identity entries materialized.
    lower_idx = [0xFFFF] * 0x10000
    lower_entries = []
    for cp in range(0x10000):
        if 0xD800 <= cp <= 0xDFFF:
            continue
        out = _py_lower(cp)
        if out == [cp]:
            continue
        assert len(out) <= 3
        if len(lower_entries) >= 0xFFFF:
            raise RuntimeError("lower entry overflow")
        lower_idx[cp] = len(lower_entries)
        padded = out + [0] * (3 - len(out))
        lower_entries.append((len(out), padded[0], padded[1], padded[2]))

    # Fold table: only non-identity entries are materialized.
    fold_idx = [0xFFFF] * 0x10000
    entries = []  # list of (n, out0, out1, out2)
    for cp in range(0x10000):
        if 0xD800 <= cp <= 0xDFFF:  # surrogates: not valid scalar values
            continue
        out = fold_fn(cp)
        if out == [cp]:
            continue
        if len(out) > 3:  # no BMP codepoint folds to >3 under this pipeline
            out = out[:3]
        if len(entries) >= 0xFFFF:
            raise RuntimeError("fold entry overflow")
        fold_idx[cp] = len(entries)
        padded = out + [0] * (3 - len(out))
        entries.append((len(out), padded[0], padded[1], padded[2]))

    def dump(name, ctype, values, per_line=16):
        lines = ["static const {} {}[{}] = {{".format(ctype, name, len(values))]
        for i in range(0, len(values), per_line):
            lines.append("  " + ",".join(str(v) for v in values[i:i + per_line])
                         + ",")
        lines.append("};")
        return "\n".join(lines)

    parts = [
        "// Auto-generated by gen_tables.py — do not edit.",
        "// calibration: " + calibration_tag(),
        "#pragma once",
        "#include <cstdint>",
        "#define F_RE_SPACE {}".format(F_RE_SPACE),
        "#define F_STR_SPACE {}".format(F_STR_SPACE),
        "#define F_HF_WS {}".format(F_HF_WS),
        "#define F_HF_CTRL {}".format(F_HF_CTRL),
        "#define F_HF_PUNCT {}".format(F_HF_PUNCT),
        "#define F_CJK {}".format(F_CJK),
        "#define F_ALPHA {}".format(F_ALPHA),
        "#define F_LOWER {}".format(F_LOWER),
        "#define F_RE_DIGIT {}".format(F_RE_DIGIT),
        "#define F_UPPER {}".format(F_UPPER),
        "#define F_RE_WORD {}".format(F_RE_WORD),
        "#define F_PY_CASED {}".format(F_PY_CASED),
        "#define F_PY_CASE_IGNORABLE {}".format(F_PY_CASE_IGNORABLE),
        dump("UFLAGS", "uint16_t", flags),
        dump("LOWER_IDX", "uint16_t", lower_idx),
        dump("LOWER_N", "uint8_t", [e[0] for e in lower_entries]),
        dump("LOWER_OUT", "uint32_t",
             [v for e in lower_entries for v in (e[1], e[2], e[3])]),
        dump("ALOWER_CP", "uint32_t", [e[0] for e in astral_lowers]),
        dump("ALOWER_N", "uint8_t", [e[1] for e in astral_lowers]),
        dump("ALOWER_OUT", "uint32_t",
             [v for e in astral_lowers for v in (e[2], e[3], e[4])]),
        dump("FOLD_IDX", "uint16_t", fold_idx),
        dump("FOLD_N", "uint8_t", [e[0] for e in entries]),
        dump("FOLD_OUT", "uint32_t",
             [v for e in entries for v in (e[1], e[2], e[3])]),
        dump("AFLAG_START", "uint32_t", astral_starts),
        dump("AFLAG_VALUE", "uint16_t", astral_flags),
        dump("AFOLD_CP", "uint32_t", [e[0] for e in astral_folds]),
        dump("AFOLD_N", "uint8_t", [e[1] for e in astral_folds]),
        dump("AFOLD_OUT", "uint32_t",
             [v for e in astral_folds for v in (e[2], e[3], e[4])]),
    ]
    with open(out_path, "w") as f:
        f.write("\n".join(parts) + "\n")
    return out_path


def header_calibration(path):
    """The calibration tag stamped into a generated header, e.g.
    ``tokenizers=0.22.2;unicodedata=15.0.0``."""
    with open(path, encoding="utf-8") as f:
        for _ in range(3):
            line = f.readline().strip()
            if line.startswith("// calibration: "):
                return line[len("// calibration: "):]
    raise ValueError("no calibration line in {}".format(path))


if __name__ == "__main__":
    generate(sys.argv[1] if len(sys.argv) > 1 else "unicode_tables.h")
