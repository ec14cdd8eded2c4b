"""Static MLM masking in the port against lddl_tpu.ops.masking.

- The numpy engines (plan_num_to_predict, mask_batch_numpy,
  mask_whole_word_batch_numpy) are copies: equal outputs on the same
  Philox stream.
- The torch maskers replace the reference's jit'd JAX maskers; the RNG
  streams differ by design, so both are held to the same invariants on
  the same inputs (tests/test_ops.py:54,192,204): the per-row count,
  non-candidates untouched, whole-word groups atomic, and the 80/10/10
  split within 6 binomial standard deviations over >= 100k selections.
- The torch maskers' draws are the SplitMix64 counter contract
  (utils.rng): equal to a uint64 numpy evaluation; their masks equal a
  per-row oracle over the same draws, and do not depend on how a
  bucket's rows are chunked.
- engine="torch" refuses to fall back to the CPU when no card is there.
"""

import numpy as np
import pytest
import torch

from lddl_tpu.ops import masking as rmask
from lddl_tpu.utils import rng as rrng
from lddl_tpu_torch.ops import masking as tmask
from lddl_tpu_torch.utils import rng as trng

MASK_ID, VOCAB = 3, 1000


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _setup(n=256, width=128, seed=0, sub_frac=0.3):
    g = np.random.default_rng(seed)
    lens = g.integers(5, width + 1, n)
    a_lens = (g.random(n) * (lens - 3)).astype(np.int64).clip(1)
    ids = g.integers(10, VOCAB, (n, width)).astype(np.int32)
    cand = np.arange(width)[None] < lens[:, None]
    cand[:, 0] = False
    cand[np.arange(n), a_lens + 1] = False
    cand[np.arange(n), lens - 1] = False
    num = rmask.plan_num_to_predict(lens, 0.15, 20)
    is_subword = g.random(VOCAB) < sub_frac
    is_subword[:10] = False
    return ids, cand, num, is_subword


def _continuations(ids, cand, is_subword):
    cont = np.zeros_like(cand)
    cont[:, 1:] = cand[:, 1:] & cand[:, :-1] & is_subword[ids[:, 1:]]
    return cont


def _check_invariants(ids, cand, num, out, sel, cont=None):
    """Returns the selection count and the (mask, kept, random) shares."""
    assert not (sel & ~cand).any()                 # only candidates
    assert (out[~sel] == ids[~sel]).all()          # the rest untouched
    taken = sel.sum(axis=1)
    if cont is None:
        np.testing.assert_array_equal(taken, np.minimum(num, cand.sum(1)))
    else:
        assert (taken <= num).all()
        # Whole words atomic: a continuation shares its word's state.
        assert (sel[:, 1:][cont[:, 1:]] == sel[:, :-1][cont[:, 1:]]).all()
        assert taken.sum() > 0.8 * num.sum()
    n = int(sel.sum())
    mask = float((out[sel] == MASK_ID).sum()) / n
    kept = float((out[sel] == ids[sel]).sum()) / n
    return n, (mask, kept, 1 - mask - kept)


def _check_split(n, shares):
    # P(random id == original) = 1/VOCAB moves 0.0001 from random to kept.
    for share, p in zip(shares, (0.8, 0.1 + 0.1 / VOCAB, 0.1 - 0.1 / VOCAB)):
        assert abs(share - p) <= 6 * np.sqrt(p * (1 - p) / n), (share, p, n)


def test_numpy_engines_equal_reference():
    ids, cand, num, is_subword = _setup(n=300)
    lens = np.random.default_rng(1).integers(0, 600, 50)
    np.testing.assert_array_equal(
        tmask.plan_num_to_predict(lens, 0.15, 20),
        rmask.plan_num_to_predict(lens, 0.15, 20))
    for fn, extra in ((("mask_batch_numpy"), ()),
                      ("mask_whole_word_batch_numpy", (is_subword,))):
        got = getattr(tmask, fn)(ids, cand, num, trng.sample_rng(5, 1),
                                 MASK_ID, VOCAB, *extra)
        want = getattr(rmask, fn)(ids, cand, num, rrng.sample_rng(5, 1),
                                  MASK_ID, VOCAB, *extra)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_counter_draws_follow_the_splitmix_contract():
    """counter_u53(seed, s, ...)[r, c] == CounterRNG-style
    mix64(stream_key(MASK_TAG, seed, s) + (counter + 1) * GOLDEN) >> 11
    with counter = row << 20 | col, evaluated in uint64 numpy and in
    Python ints."""
    seed, n, w, off = 2**63 + 12345, 6, 9, 4093
    for stream in (0, 1, 2):
        got = tmask.counter_u53(seed, stream, n, w, row_offset=off).numpy()
        key = np.uint64(trng.stream_key(tmask.MASK_TAG, seed, stream))
        r = np.arange(off, off + n, dtype=np.uint64)
        c = np.arange(w, dtype=np.uint64)
        z = key + (((r[:, None] << np.uint64(20)) | c[None])
                   + np.uint64(1)) * np.uint64(trng.GOLDEN)
        z ^= z >> np.uint64(30)
        z *= np.uint64(0xBF58476D1CE4E5B9)
        z ^= z >> np.uint64(27)
        z *= np.uint64(0x94D049BB133111EB)
        z ^= z >> np.uint64(31)
        np.testing.assert_array_equal(got, (z >> np.uint64(11)).astype(
            np.int64))
        rr, cc = 2, 7
        scalar = trng.mix64(int(key) + ((((off + rr) << 20) | cc) + 1)
                            * trng.GOLDEN) >> 11
        assert int(got[rr, cc]) == scalar
    assert got.min() >= 0 and got.max() < 2**53


@pytest.mark.parametrize("wwm", [False, True])
def test_torch_maskers_equal_a_row_oracle_on_their_draws(wwm):
    """The row-vectorised tensor code equals a per-row Python oracle that
    consumes the same three draw matrices: groups taken in ascending head
    score (ties by column) while they fit the budget."""
    ids, cand, num, is_subword = _setup(n=200, width=96, seed=4)
    seed = 99
    run = (tmask.make_torch_whole_word_masker(MASK_ID, VOCAB, is_subword,
                                              device="cpu") if wwm
           else tmask.make_torch_masker(MASK_ID, VOCAB, device="cpu"))
    out, sel = run(ids, cand, num, seed)
    n, w = ids.shape
    score = tmask.counter_u53(seed, 0, n, w).numpy()
    action = tmask.counter_u53(seed, 1, n, w).numpy() * 2.0 ** -53
    rand = (tmask.counter_u53(seed, 2, n, w).numpy() % VOCAB).astype(
        np.int32)
    want_sel = np.zeros_like(cand)
    for r in range(n):
        groups = []
        for c in np.nonzero(cand[r])[0]:
            if (wwm and groups and groups[-1][-1] == c - 1
                    and is_subword[ids[r, c]]):
                groups[-1].append(int(c))
            else:
                groups.append([int(c)])
        order = sorted(range(len(groups)),
                       key=lambda i: (score[r, groups[i][0]], groups[i][0]))
        taken = 0
        for i in order:
            if taken >= num[r]:
                break
            if taken + len(groups[i]) <= num[r]:
                want_sel[r, groups[i]] = True
                taken += len(groups[i])
    want_out = np.where(want_sel & (action < 0.8), MASK_ID, ids)
    want_out = np.where(want_sel & (action >= 0.8) & (action < 0.9), rand,
                        want_out)
    np.testing.assert_array_equal(sel, want_sel)
    np.testing.assert_array_equal(out, want_out)


@pytest.mark.parametrize("wwm", [False, True])
def test_torch_and_jax_maskers_hold_the_invariants(wwm):
    """>= 100k selections each, on the same inputs, beside the
    reference's jit'd masker."""
    ids, cand, num, is_subword = _setup(n=7000, width=256, seed=7)
    cont = _continuations(ids, cand, is_subword) if wwm else None
    if wwm:
        jax_run = rmask.make_jax_whole_word_masker(MASK_ID, VOCAB,
                                                   is_subword)
        torch_run = tmask.make_torch_whole_word_masker(
            MASK_ID, VOCAB, is_subword, device="cpu")
    else:
        jax_run = rmask.make_jax_masker(MASK_ID, VOCAB)
        torch_run = tmask.make_torch_masker(MASK_ID, VOCAB, device="cpu")
    for run in (jax_run, torch_run):
        out, sel = run(ids, cand, num, 11)
        n, shares = _check_invariants(ids, cand, num, out, sel, cont)
        assert n >= 100_000
        _check_split(n, shares)
        again, _ = run(ids, cand, num, 11)
        np.testing.assert_array_equal(out, again)
        other, _ = run(ids, cand, num, 12)
        assert not np.array_equal(out, other)


@pytest.mark.parametrize("wwm", [False, True])
def test_torch_masks_do_not_depend_on_chunking(wwm, monkeypatch):
    from lddl_tpu_torch.preprocess import bert as tbert
    ids, cand, num, is_subword = _setup(n=500, width=64, seed=8)
    run = (tmask.make_torch_whole_word_masker(MASK_ID, VOCAB, is_subword,
                                              device="cpu") if wwm
           else tmask.make_torch_masker(MASK_ID, VOCAB, device="cpu"))
    whole = tbert._run_torch_chunked(run, ids, cand, num, 7, (1, 2))
    for chunk in (1, 64, 333):
        monkeypatch.setattr(tbert, "TORCH_MASK_CHUNK", chunk)
        got = tbert._run_torch_chunked(run, ids, cand, num, 7, (1, 2))
        for a, b in zip(got, whole):
            np.testing.assert_array_equal(a, b)
    # A chunk's rows are keyed by their global index.
    seed = tbert.torch_mask_seed(7, (1, 2))
    tail = run(ids[300:], cand[300:], num[300:], seed, row_offset=300)
    for a, b in zip(tail, whole):
        np.testing.assert_array_equal(a, b[300:])


def test_torch_engine_refuses_a_missing_card(monkeypatch, tmp_path):
    from lddl_tpu_torch.preprocess import (BertPretrainConfig,
                                           get_tokenizer, run_bert_preprocess)
    from lddl_tpu_torch.testing import write_vocab
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmask.make_torch_masker(MASK_ID, VOCAB)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmask.make_torch_whole_word_masker(MASK_ID, VOCAB,
                                           np.zeros(VOCAB, bool))
    vocab = str(tmp_path / "vocab.txt")
    write_vocab(vocab, 64)
    (tmp_path / "source").mkdir()
    (tmp_path / "source" / "0.txt").write_text("d0 Some words here.\n")
    cfg = BertPretrainConfig(masking=True, engine="torch")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_bert_preprocess({"w": str(tmp_path)}, str(tmp_path / "out"),
                            get_tokenizer(vocab), config=cfg)
    assert not (tmp_path / "out").exists()
    assert tmask.make_torch_masker(MASK_ID, VOCAB,
                                   device="cpu").device.type == "cpu"
