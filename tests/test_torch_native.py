"""The port's native engine (lddl_tpu_torch.native, its own copy of the
C++ source and tables) against the reference's (lddl_tpu.native) and
against HF's BertTokenizerFast on the same vocab file: identical
tokenize_docs, bert_instances, bert_instances_masked, bert_pairs,
mask_batch, split_docs and join_tokens outputs on a seeded fuzz corpus
(accents, CJK, control characters, punctuation, astral codepoints, words
of 100+ characters). Exact equality throughout: integer outputs.

Also: the committed unicode_tables.h equals a fresh regeneration (skips
only without the HF tokenizers package), the two libraries are separate
files loaded side by side, a failed build raises, and the sanitizer
modes (LDDL_TPU_NATIVE_SANITIZE) parse, flag and key their libraries as
the reference's do; a ubsan build tokenizes as the normal one, and a
tsan build loaded without its runtime raises by name.
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest

from lddl_tpu import native as rnative
from lddl_tpu.preprocess import get_tokenizer as r_get_tokenizer
from lddl_tpu.preprocess.bert import TokenizerInfo as RTokenizerInfo
from lddl_tpu.utils import rng as rrng
from lddl_tpu_torch import native as tnative
from lddl_tpu_torch.native import build as tbuild
from lddl_tpu_torch.preprocess import build_wordpiece_vocab, get_tokenizer
from lddl_tpu_torch.preprocess.bert import TokenizerInfo
from lddl_tpu_torch.preprocess.sentences import split_sentences

BASE_DOCS = [
    "Hello world. This is a test! Dr. Smith went to Washington. "
    'He said "yes." Then left.',
    "U.S. policy changed in 1999. The E.U. responded. Prices rose 3.5 "
    "percent. Mr. J. R. Ewing agreed.",
    "Unicode: café naïve Zürich über Straße. “Quoted sentence.” Another "
    "one! 中文处理测试。 Mixed 中 text.",
    "control\x01chars\x02here. \x00nul and � replacement. Fine.",
    "Ellipsis... And then? Yes!! Done. (Parenthetical. Sentence.) [Also.]",
    "line separated. soft­hyphen zero​width bom﻿mark. "
    "nel\u0085char vt\x0bchar done. Compat 豈 ideograph.",
    "Ünïcödé ÀÉÎÕÜ Ǆ ǅ ǆ ΣΑΣ ὈΔΥΣΣΕΎΣ. " + "a" * 120 + " " + "Ω" * 101
    + ". End.",
]


def _fuzz_docs(n=80, seed=17):
    g = np.random.default_rng(seed)
    pools = [(0x20, 0x7F), (0x20, 0x7F), (0xA0, 0x600), (0x1E00, 0x2100),
             (0x3000, 0xA000), (0xF900, 0x10000), (0x10000, 0x11000),
             (0x1D100, 0x1D800), (0x20000, 0x20100), (0xE0000, 0xE0200),
             (0x0, 0x20)]
    docs = list(BASE_DOCS)
    for _ in range(n):
        cps = []
        for _ in range(int(g.integers(20, 160))):
            lo, hi = pools[int(g.integers(0, len(pools)))]
            cp = int(g.integers(lo, hi))
            if 0xD800 <= cp <= 0xDFFF or cp == 0x0A:
                cp = 0x61
            cps.append(cp)
            r = g.random()
            if r < 0.15:
                cps.append(0x20)
            elif r < 0.18:
                cps.extend(map(ord, ". "))
            elif r < 0.19:
                cps.extend([0x61] * int(g.integers(100, 130)))
        docs.append("".join(map(chr, cps)) + ".")
    return docs


DOCS = _fuzz_docs()


@pytest.fixture(scope="module")
def vocab_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("tnvocab") / "vocab.txt"
    return build_wordpiece_vocab(DOCS * 2, str(path), vocab_size=600)


@pytest.fixture(scope="module")
def engines(vocab_file):
    """(port TokenizerInfo, reference TokenizerInfo) on one vocab file."""
    return (TokenizerInfo(get_tokenizer(vocab_file)),
            RTokenizerInfo(r_get_tokenizer(vocab_file=vocab_file)))


def test_libraries_are_separate_and_both_load(engines):
    port, ref = engines
    assert port.native_tokenizer() is not None
    assert ref.native_tokenizer() is not None
    from lddl_tpu.native import build as rbuild
    assert os.path.dirname(tbuild.lib_path()) == tbuild.BUILD_DIR
    assert os.path.realpath(tbuild.lib_path()) != os.path.realpath(
        rbuild.lib_path())
    assert tnative._load()._name == tbuild.lib_path()


def test_split_docs_matches_reference_and_python():
    got = tnative.split_docs(DOCS)
    assert got == rnative.split_docs(DOCS)
    for text, sents in zip(DOCS, got):
        assert sents == split_sentences(text), repr(text)


def test_tokenize_docs_matches_reference_and_hf(engines, vocab_file):
    port, ref = engines
    got = port.native_tokenizer().tokenize_docs(DOCS)
    want = ref.native_tokenizer().tokenize_docs(DOCS)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    # Token ids equal BertTokenizerFast's, sentence by sentence.
    backend = r_get_tokenizer(vocab_file=vocab_file)._tokenizer
    ids, sent_lens, doc_counts = got
    k = pos = 0
    for d, text in enumerate(DOCS):
        kept = 0
        for s in split_sentences(text):
            hf = backend.encode(s, add_special_tokens=False).ids
            if not hf:
                continue
            n = int(sent_lens[k])
            assert ids[pos:pos + n].tolist() == hf, repr(s)
            k, pos, kept = k + 1, pos + n, kept + 1
        assert int(doc_counts[d]) == kept
    assert pos == len(ids) and k == len(sent_lens)


@pytest.mark.parametrize("want_ab", [False, True])
def test_bert_instances_and_pairs_match_reference(engines, want_ab):
    port, ref = engines
    args = (DOCS, 64, 0.1, 3, 12345, 7, port.cls_id, port.sep_id)
    got = port.native_tokenizer().bert_instances(*args, want_ab=want_ab)
    want = ref.native_tokenizer().bert_instances(*args, want_ab=want_ab)
    assert len(got[0]) > 0
    for a, b in zip(got, want):
        if b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(a, b)
    # The staged rung (tokenize_docs + bert_pairs) equals the fused one.
    ids, sent_lens, counts = port.native_tokenizer().tokenize_docs(DOCS)
    staged = tnative.bert_pairs(ids, sent_lens, counts, 64, 0.1, 3, 12345,
                                7, port.cls_id, port.sep_id)
    for a, b in zip(staged, got[:4]):
        np.testing.assert_array_equal(a, b)


def test_masked_instances_and_mask_batch_match_reference(engines):
    port, ref = engines
    key = rrng.sample_key_bytes(12345, 0x3A5C, 7)
    args = (DOCS, 64, 0.1, 3, 12345, 7, port.cls_id, port.sep_id, key,
            port.mask_id, port.vocab_size, 0.15, 10, 64)
    got = port.native_tokenizer().bert_instances_masked(*args)
    want = ref.native_tokenizer().bert_instances_masked(*args)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    g = np.random.default_rng(3)
    ids = g.integers(5, port.vocab_size, (300, 96)).astype(np.int32)
    cand = g.random((300, 96)) < 0.8
    num = g.integers(0, 20, 300)
    got = tnative.mask_batch(key, ids, cand, num, port.mask_id,
                             port.vocab_size)
    want = rnative.mask_batch(key, ids, cand, num, port.mask_id,
                              port.vocab_size)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    # ... and both replay mask_batch_numpy on the same Philox stream.
    from lddl_tpu_torch.ops.masking import mask_batch_numpy
    from lddl_tpu_torch.utils import rng as trng
    plain = mask_batch_numpy(ids, cand, num,
                             trng.sample_rng(12345, 0x3A5C, 7),
                             port.mask_id, port.vocab_size)
    for a, b in zip(got, plain):
        np.testing.assert_array_equal(a, b)


def test_join_tokens_matches_reference(engines):
    port, _ = engines
    table = port.token_byte_table()
    g = np.random.default_rng(5)
    lens = g.integers(0, 12, 200)
    flat = g.integers(0, port.vocab_size, int(lens.sum()))
    total = int(table.lens[flat].sum()) + len(flat) - int(
        np.count_nonzero(lens))
    got = tnative.join_tokens(flat, lens, table.blob, table.starts,
                              table.lens, total)
    want = rnative.join_tokens(flat, lens, table.blob, table.starts,
                               table.lens, total)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    words = [" ".join(port.token_list[i] for i in flat[s - n:s])
             for s, n in zip(np.cumsum(lens), lens)]
    data, offs = got
    assert [bytes(data[offs[i]:offs[i + 1]]).decode() for i in
            range(len(lens))] == words


def test_committed_tables_equal_a_regeneration(tmp_path):
    """unicode_tables.h is committed and never regenerated by a build;
    it must be what gen_tables makes here (tokenizers 0.22.2 and Python
    3.12's unicodedata 15.0.0 when it was made)."""
    pytest.importorskip(
        "tokenizers", reason="regenerating the tables needs the HF "
        "tokenizers package")
    from lddl_tpu_torch.native import gen_tables
    out = tmp_path / "unicode_tables.h"
    gen_tables.generate(str(out))
    with open(tbuild.TABLES, "rb") as f:
        committed = f.read()
    assert out.read_bytes() == committed
    assert gen_tables.header_calibration(tbuild.TABLES) == \
        gen_tables.calibration_tag()


def test_failed_build_raises(tmp_path, monkeypatch):
    """No fallback engine: a source g++ cannot compile raises with the
    compiler's message."""
    bad = tmp_path / "lddl_native.cpp"
    bad.write_text("#include \"unicode_tables.h\"\nthis is not C++;\n")
    (tmp_path / "unicode_tables.h").write_text("// empty\n")
    monkeypatch.setattr(tbuild, "SRC", str(bad))
    monkeypatch.setattr(tbuild, "TABLES", str(tmp_path / "unicode_tables.h"))
    monkeypatch.setattr(tbuild, "BUILD_DIR", str(tmp_path / "_build"))
    with pytest.raises(RuntimeError, match="g\\+\\+ exit"):
        tbuild.ensure_built()
    assert not any(n.endswith(".so") for n in os.listdir(tmp_path / "_build"))


SANITIZE_VALUES = ["", "tsan", "ubsan,tsan", " asan , ubsan ", "tsan,tsan",
                   "ubsan,,", "msan", "tsan,asan", "TSAN"]


@pytest.mark.parametrize("value", SANITIZE_VALUES)
def test_sanitize_modes_and_flags_match_reference(monkeypatch, value):
    """The same modes, flags and errors as the reference's build for each
    value of LDDL_TPU_NATIVE_SANITIZE, the bad ones included."""
    from lddl_tpu.native import build as rbuild
    monkeypatch.delenv("LDDL_TPU_NATIVE_MARCH", raising=False)
    monkeypatch.setenv("LDDL_TPU_NATIVE_SANITIZE", value)
    try:
        want = rbuild.sanitize_modes()
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tbuild.sanitize_modes()
        assert str(got.value) == str(e)
        with pytest.raises(ValueError):
            tbuild.lib_path()
        return
    assert tbuild.sanitize_modes() == want
    assert tbuild.compile_flags() == rbuild.compile_flags()
    assert tbuild.compile_flags(want) == rbuild.compile_flags(want)
    assert tbuild.lib_path() == tbuild.lib_path(want)


def test_lib_path_is_keyed_by_the_modes(monkeypatch):
    """Each mode set has its own library, named after its modes, beside
    the normal one in the git-ignored build directory."""
    monkeypatch.delenv("LDDL_TPU_NATIVE_SANITIZE", raising=False)
    paths = {modes: tbuild.lib_path(modes) for modes in
             [(), ("tsan",), ("ubsan",), ("tsan", "ubsan"),
              ("asan", "ubsan")]}
    assert len(set(paths.values())) == len(paths)
    assert paths[()] == tbuild.lib_path()
    for modes, path in paths.items():
        assert os.path.dirname(path) == tbuild.BUILD_DIR
        name = os.path.basename(path)
        if modes:
            assert name.startswith("lddl_native.san-{}-".format(
                "-".join(modes)))
        else:
            assert name.startswith("lddl_native-") and ".san-" not in name
    assert tbuild.compile_flags(())[0] == "-O3"
    assert tbuild.compile_flags(("tsan", "ubsan"))[:3] == [
        "-O1", "-g", "-fno-omit-frame-pointer"]
    assert tbuild.compile_flags(("tsan", "ubsan"))[-2:] == [
        "-fsanitize=thread", "-fsanitize=undefined"]


def _run_py(code, **env):
    full = dict(os.environ, **env)
    full.pop("LD_PRELOAD", None)
    return subprocess.run([sys.executable, "-c", code], env=full,
                          cwd=os.path.dirname(os.path.dirname(tbuild._DIR)),
                          capture_output=True, text=True, timeout=600)


UBSAN_RUN = """
import json, sys, time
t = time.monotonic()
from lddl_tpu_torch.native import build
path = build.ensure_built()
built = time.monotonic() - t
from lddl_tpu_torch import native
from lddl_tpu_torch.preprocess import get_tokenizer
from lddl_tpu_torch.preprocess.bert import TokenizerInfo
assert native._load()._name == path
with open({docs!r}) as f:
    docs = json.load(f)
t = time.monotonic()
nat = TokenizerInfo(get_tokenizer({vocab!r})).native_tokenizer()
out = nat.tokenize_docs(docs)
print(json.dumps({{"path": path, "build_s": built,
                  "run_s": time.monotonic() - t,
                  "out": [a.tolist() for a in out]}}))
"""


def test_ubsan_build_tokenizes_as_the_normal_one(engines, vocab_file,
                                                 tmp_path):
    """A ubsan build (its own library) run in a subprocess with
    UBSAN_OPTIONS=halt_on_error=1 gives the normal engine's ids; the
    build and the run are timed."""
    import json
    port, _ = engines
    docs = DOCS[:20]
    want = port.native_tokenizer().tokenize_docs(docs)
    (tmp_path / "docs.json").write_text(json.dumps(docs))
    t = time.monotonic()
    proc = _run_py(UBSAN_RUN.format(docs=str(tmp_path / "docs.json"),
                                    vocab=vocab_file),
                   LDDL_TPU_NATIVE_SANITIZE="ubsan",
                   UBSAN_OPTIONS="halt_on_error=1 print_stacktrace=1",
                   JAX_PLATFORMS="cpu")
    wall = time.monotonic() - t
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    print("ubsan build {:.1f} s, tokenize {:.2f} s, subprocess {:.1f} s"
          .format(res["build_s"], res["run_s"], wall))
    assert os.path.basename(res["path"]).startswith("lddl_native.san-ubsan-")
    assert res["path"] != tbuild.lib_path(())
    for a, b in zip(res["out"], want):
        assert a == b.tolist()
    assert "runtime error" not in proc.stderr


def test_tsan_library_without_its_runtime_raises():
    """A tsan library loaded without LD_PRELOAD raises and names the mode
    and LD_PRELOAD: never a missing engine."""
    proc = _run_py("from lddl_tpu_torch import native\nnative._load()\n",
                   LDDL_TPU_NATIVE_SANITIZE="tsan", JAX_PLATFORMS="cpu")
    assert proc.returncode != 0
    last = proc.stderr.strip().splitlines()[-1]
    assert last.startswith("RuntimeError"), proc.stderr[-2000:]
    assert "LDDL_TPU_NATIVE_SANITIZE=tsan" in last and "LD_PRELOAD" in last
