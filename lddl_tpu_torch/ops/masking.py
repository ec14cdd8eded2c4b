"""Batched static MLM masking: numpy engines and torch maskers.

Counterpart of ``lddl_tpu/ops/masking.py``. The numpy engines
(``plan_num_to_predict``, ``mask_batch_numpy``,
``mask_whole_word_batch_numpy``) are copies. The reference's jit'd JAX
maskers (``make_jax_masker``, ``make_jax_whole_word_masker``) become
``make_torch_masker`` and ``make_torch_whole_word_masker``, with the same
``run(ids, candidate, num_to_predict, seed)`` contract, on the card by
default (``device=None``, see ``device.resolve_device``).

Algorithm (identical semantics across engines):
- per row: num_to_predict = min(max_pred, max(1, round(seq_len * ratio)))
- selection: uniform random subset of the non-special valid positions
  (smallest-k of iid uniform scores == uniform subset without replacement)
- per selected position: 80% -> [MASK], 10% -> uniform random vocab id,
  10% -> keep original.

The engines consume different streams (numpy Philox vs the torch
maskers' counter hash), so masks differ between engines; each is fully
deterministic in its seed.

Device-independent draws. Torch's CPU and CUDA generators give different
bits, so the torch maskers draw nothing from them: every draw is a
SplitMix64 hash of (seed, stream, row, column) in int64 tensor ops, the
counter contract of ``utils.rng.CounterRNG`` with counter
``row << 20 | column`` (rows count from ``row_offset``)::

    key_s  = stream_key(MASK_TAG, seed, s)     s: 0 score, 1 action, 2 id
    draw   = mix64(key_s + (counter + 1) * GOLDEN)
    u53    = draw >> 11                        (score: compared as an int)
    action = u53 * 2^-53                       (float64, exact)
    id     = low + u53 % (vocab_size - low)

int64 multiplication wraps like uint64's, and a right shift is masked to
the logical shift's bits, so the masks are bit-identical on the CPU and
on the card, and a row's masks depend only on its global row index:
chunking a bucket's rows changes nothing.
"""

import numpy as np


def plan_num_to_predict(seq_lens, masked_lm_ratio, max_predictions_per_seq):
    seq_lens = np.asarray(seq_lens)
    return np.minimum(
        max_predictions_per_seq,
        np.maximum(1, np.round(seq_lens * masked_lm_ratio)),
    ).astype(np.int32)


def mask_batch_numpy(ids, candidate, num_to_predict, g, mask_id, vocab_size,
                     random_token_low=0):
    """Vectorized masking over a padded id matrix.

    ids: [N, L] int32; candidate: [N, L] bool (valid AND non-special);
    num_to_predict: [N] int. Returns (masked_ids, selected_mask).
    """
    scores = g.random(ids.shape)
    scores[~candidate] = np.inf
    # Smallest-k selection via partition + per-row threshold: O(N*L)
    # instead of a full argsort. Equivalent to rank-based selection for
    # distinct scores (iid float64 uniforms: ties have probability ~2^-53;
    # non-candidates sit at +inf and the candidate guard excludes them
    # even when a short row's threshold is inf).
    num_to_predict = np.asarray(num_to_predict)
    if ids.shape[0] == 0:
        return ids.copy(), np.zeros_like(candidate)
    # num_to_predict values beyond the row width clamp to "take every
    # candidate" (the rank-based behavior).
    k_max = min(max(int(num_to_predict.max()), 1), ids.shape[1])
    # Single partition at k_max-1 + a sort of the k_max-wide slice. (A
    # multi-kth np.partition at every distinct k was measured 20x slower:
    # numpy runs one introselect pass per listed kth.)
    smallest = np.partition(scores, k_max - 1, axis=1)[:, :k_max]
    smallest.sort(axis=1)
    thresh = smallest[np.arange(ids.shape[0]),
                      np.clip(num_to_predict, 1, k_max) - 1]
    selected = (scores <= thresh[:, None]) & candidate
    selected[num_to_predict <= 0] = False

    action = g.random(ids.shape)
    random_ids = g.integers(random_token_low, vocab_size, ids.shape,
                            dtype=np.int64).astype(np.int32)
    out = np.where(selected & (action < 0.8), mask_id, ids)
    out = np.where(selected & (action >= 0.8) & (action < 0.9), random_ids,
                   out)
    return out, selected


def _word_groups(ids, candidate, is_subword):
    """Group candidate columns into whole words: a candidate column joins
    the previous column's group when its token is a subword continuation
    and the previous column is also a candidate. Returns (start, gid):
    start[r,c] marks group heads; gid[r,c] numbers groups left-to-right
    (meaningful only where candidate)."""
    cont = np.zeros_like(candidate)
    cont[:, 1:] = (candidate[:, 1:] & candidate[:, :-1]
                   & is_subword[ids[:, 1:]])
    start = candidate & ~cont
    gid = np.cumsum(start, axis=1) - 1
    return start, gid


def mask_whole_word_batch_numpy(ids, candidate, num_to_predict, g, mask_id,
                                vocab_size, is_subword, random_token_low=0):
    """Vectorized whole-word masking: subword continuations group with
    their word start and groups are selected atomically — a group is taken,
    in random score order, iff it fits the remaining per-row budget
    (Google-BERT wwm semantics: oversized groups are skipped, not split).

    Frozen draw contract (identical to mask_batch_numpy's shapes, so the
    stream is engine-checkable): scores [N,L], action [N,L], random ids
    [N,L] — selection order is the stable ascending argsort of each
    group's head-column score.
    """
    n, width = ids.shape
    scores = g.random(ids.shape)
    start, gid = _word_groups(ids, candidate, is_subword)
    ngroups = start.sum(axis=1)
    max_groups = max(int(ngroups.max()) if n else 0, 1)

    sizes = np.zeros((n, max_groups), dtype=np.int64)
    cand_r, cand_c = np.nonzero(candidate)
    np.add.at(sizes, (cand_r, gid[cand_r, cand_c]), 1)
    gscores = np.full((n, max_groups), np.inf)
    head_r, head_c = np.nonzero(start)
    gscores[head_r, gid[head_r, head_c]] = scores[head_r, head_c]

    order = np.argsort(gscores, axis=1, kind="stable")
    size_sorted = np.take_along_axis(sizes, order, axis=1)
    valid_rank = np.arange(max_groups)[None, :] < ngroups[:, None]
    taken = np.zeros(n, dtype=np.int64)
    budget = np.asarray(num_to_predict, dtype=np.int64)
    accept = np.zeros((n, max_groups), dtype=bool)
    rows = np.arange(n)
    # Greedy scan, vectorized over rows, sequential only over score rank.
    for k in range(max_groups):
        sz = size_sorted[:, k]
        ok = valid_rank[:, k] & (taken < budget) & (taken + sz <= budget)
        taken = np.where(ok, taken + sz, taken)
        accept[rows[ok], order[ok, k]] = True

    selected = np.zeros_like(candidate)
    selected[cand_r, cand_c] = accept[cand_r, gid[cand_r, cand_c]]

    action = g.random(ids.shape)
    random_ids = g.integers(random_token_low, vocab_size, ids.shape,
                            dtype=np.int64).astype(np.int32)
    out = np.where(selected & (action < 0.8), mask_id, ids)
    out = np.where(selected & (action >= 0.8) & (action < 0.9), random_ids,
                   out)
    return out, selected


# Tag of the torch maskers' counter streams (utils.rng domain tags
# 0x1DD1_0001-0005 are the reference's).
MASK_TAG = 0x1DD1_0006
_SCORE, _ACTION, _RANDOM_ID = 0, 1, 2
COL_BITS = 20
# Above every 53-bit score: the score of a non-candidate column or of a
# group that does not exist.
_NO_SCORE = 1 << 62


def _signed64(u):
    """A uint64 constant as the int64 with the same bits."""
    u &= (1 << 64) - 1
    return u - (1 << 64) if u >= 1 << 63 else u


_M1 = _signed64(0xBF58476D1CE4E5B9)
_M2 = _signed64(0x94D049BB133111EB)


def _mix64_t(z):
    """SplitMix64's finalizer on an int64 tensor, bit for bit the uint64
    one: the products wrap modulo 2^64 and each shift keeps only the bits
    a logical shift keeps."""
    z = z ^ ((z >> 30) & ((1 << 34) - 1))
    z = z * _M1
    z = z ^ ((z >> 27) & ((1 << 37) - 1))
    z = z * _M2
    return z ^ ((z >> 31) & ((1 << 33) - 1))


def counter_u53(seed, stream, n, width, row_offset=0, device="cpu"):
    """[n, width] int64 tensor of 53-bit draws of stream ``stream`` for
    rows ``row_offset .. row_offset + n - 1`` (the contract above)."""
    import torch
    from ..utils.rng import GOLDEN, stream_key
    if width > 1 << COL_BITS:
        raise ValueError("width {} exceeds 2^{} columns".format(width,
                                                                 COL_BITS))
    key = _signed64(stream_key(MASK_TAG, seed, stream))
    rows = torch.arange(row_offset, row_offset + n, dtype=torch.int64,
                        device=device)
    cols = torch.arange(width, dtype=torch.int64, device=device)
    counter = (rows[:, None] << COL_BITS) | cols[None, :]
    z = _mix64_t((counter + 1) * _signed64(GOLDEN) + key)
    return (z >> 11) & ((1 << 53) - 1)


def _apply_actions(ids, selected, seed, row_offset, mask_id, vocab_size,
                   random_token_low):
    import torch
    n, width = ids.shape
    action = counter_u53(seed, _ACTION, n, width, row_offset,
                         ids.device).double() * 2.0 ** -53
    rand = (random_token_low + counter_u53(
        seed, _RANDOM_ID, n, width, row_offset, ids.device)
        % (vocab_size - random_token_low)).to(ids.dtype)
    out = torch.where(selected & (action < 0.8),
                      torch.full_like(ids, mask_id), ids)
    return torch.where(selected & (action >= 0.8) & (action < 0.9), rand,
                       out)


def mask_batch_torch(ids, candidate, num_to_predict, seed, mask_id,
                     vocab_size, random_token_low=0, row_offset=0):
    """Masking over a padded id matrix on ``ids``'s device. ids [N, L]
    int32, candidate [N, L] bool (valid AND non-special), num_to_predict
    [N] int; returns (masked_ids, selected) tensors. A row takes its
    ``num_to_predict`` candidates of smallest score (all of them when it
    has fewer), ties broken by column."""
    import torch
    n, width = ids.shape
    scores = torch.where(
        candidate, counter_u53(seed, _SCORE, n, width, row_offset,
                               ids.device), _NO_SCORE)
    order = torch.argsort(scores, dim=1, stable=True)
    ranks = torch.empty_like(order).scatter_(
        1, order, torch.arange(width, device=ids.device).expand(n, width))
    selected = (ranks < num_to_predict.to(torch.int64)[:, None]) & candidate
    return _apply_actions(ids, selected, seed, row_offset, mask_id,
                          vocab_size, random_token_low), selected


def mask_whole_word_batch_torch(ids, candidate, num_to_predict, seed,
                                mask_id, vocab_size, is_subword,
                                random_token_low=0, row_offset=0):
    """Whole-word masking on ``ids``'s device: a candidate column whose
    token is a subword continuation joins the group of the candidate
    column before it; groups are taken atomically in ascending order of
    their head column's score (ties by column) while they fit the row's
    remaining budget, as ``mask_whole_word_batch_numpy`` takes them. The
    greedy acceptance (``lax.scan`` in the reference) is a loop over the
    score rank, vectorised over rows. ``is_subword`` is a bool tensor
    over the vocab on the same device."""
    import torch
    n, width = ids.shape
    dev = ids.device
    cont = torch.zeros_like(candidate)
    cont[:, 1:] = (candidate[:, 1:] & candidate[:, :-1]
                   & is_subword[ids[:, 1:].to(torch.int64)])
    start = candidate & ~cont
    gid = (torch.cumsum(start.to(torch.int64), dim=1) - 1).clamp_(min=0)
    ngroups = start.sum(dim=1)
    sizes = torch.zeros((n, width), dtype=torch.int64, device=dev)
    sizes.scatter_add_(1, gid, candidate.to(torch.int64))
    heads = torch.where(start, counter_u53(seed, _SCORE, n, width,
                                           row_offset, dev), _NO_SCORE)
    gscores = torch.full((n, width), _NO_SCORE, dtype=torch.int64,
                         device=dev)
    gscores.scatter_reduce_(1, gid, heads, reduce="amin")
    order = torch.argsort(gscores, dim=1, stable=True)
    size_sorted = torch.gather(sizes, 1, order)
    budget = num_to_predict.to(torch.int64)
    taken = torch.zeros(n, dtype=torch.int64, device=dev)
    accept_sorted = torch.zeros((n, width), dtype=torch.bool, device=dev)
    for k in range(int(ngroups.max()) if n else 0):
        sz = size_sorted[:, k]
        ok = (k < ngroups) & (taken < budget) & (taken + sz <= budget)
        taken = torch.where(ok, taken + sz, taken)
        accept_sorted[:, k] = ok
    accept = torch.zeros_like(accept_sorted).scatter_(1, order,
                                                      accept_sorted)
    selected = candidate & torch.gather(accept, 1, gid)
    return _apply_actions(ids, selected, seed, row_offset, mask_id,
                          vocab_size, random_token_low), selected


def _runner(fn, device, **kwargs):
    import torch

    from ..device import resolve_device
    dev = resolve_device(device)
    consts = {k: (torch.as_tensor(v, device=dev) if isinstance(v, np.ndarray)
                  else v) for k, v in kwargs.items()}

    def run(ids, candidate, num_to_predict, seed, row_offset=0):
        """numpy in, numpy out: (masked ids, selected). Rows are numbered
        from ``row_offset`` in the draw counter."""
        out, selected = fn(
            torch.as_tensor(np.ascontiguousarray(ids, dtype=np.int32),
                            device=dev),
            torch.as_tensor(np.ascontiguousarray(candidate, dtype=bool),
                            device=dev),
            torch.as_tensor(np.asarray(num_to_predict, dtype=np.int64),
                            device=dev),
            int(seed), row_offset=int(row_offset), **consts)
        return out.cpu().numpy(), selected.cpu().numpy()

    run.device = dev
    return run


def make_torch_masker(mask_id, vocab_size, random_token_low=0, device=None):
    """The torch masker as ``run(ids, candidate, num_to_predict, seed,
    row_offset=0)``, the counterpart of the reference's
    ``make_jax_masker``; runs on the card unless ``device="cpu"``."""
    return _runner(mask_batch_torch, device, mask_id=int(mask_id),
                   vocab_size=int(vocab_size),
                   random_token_low=int(random_token_low))


def make_torch_whole_word_masker(mask_id, vocab_size, is_subword,
                                 random_token_low=0, device=None):
    """The whole-word torch masker (same call shape as
    ``make_torch_masker``'s), the counterpart of
    ``make_jax_whole_word_masker``."""
    return _runner(mask_whole_word_batch_torch, device, mask_id=int(mask_id),
                   vocab_size=int(vocab_size),
                   is_subword=np.asarray(is_subword, dtype=bool),
                   random_token_low=int(random_token_low))
