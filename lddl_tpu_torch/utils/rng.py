"""Deterministic, counter-based RNG streams.

Counterpart of ``lddl_tpu/utils/rng.py``: the same keying, so the port's
loader and preprocess draw byte-for-byte the same streams as the
reference's — batch and shard identity depend on it. Every scope gets its own numpy Philox
generator whose 128-bit key is the blake2b digest of the scope tuple.

- ``world_rng(seed, epoch)``: one stream shared by all processes (file
  shuffle, per-iteration bin choice).
- ``worker_rng(seed, epoch, dp_rank, num_dp_groups, worker, num_workers)``:
  one stream per (dp group, worker), shared by every peer of a group.
- ``sample_rng(seed, *scope)``: a one-off stream (per-worker dynamic
  masking in the collate, per-block sampling and static masking in the
  preprocess); ``sample_key_bytes`` is its Philox key, which the native
  engine replays.
- ``CounterRNG`` / ``stream_key`` / ``stable_shuffle_perm``: the frozen
  cross-engine SplitMix64 contract of pair creation, mirrored by the C++
  engine and, in int64 tensor ops, by the torch maskers
  (``ops.masking``).

``dropout_seed(seed, step, stream)`` is the port's own: the torch seed of
one train step's dropout masks, a function of (seed, step) and, on a
mesh, of the rank's stream alone.
"""

import hashlib
import struct

import numpy as np

# Domain-separation tags (frozen: identical to the reference's).
_WORLD_TAG = 0x1DD1_0001
_WORKER_TAG = 0x1DD1_0002
_SAMPLE_TAG = 0x1DD1_0003
# The port's own tag (no counterpart: the reference folds the step into a
# JAX PRNG key).
_DROPOUT_TAG = 0x1DD1_0D70


def _key_bytes(*scope):
    return hashlib.blake2b(
        struct.pack("<{}Q".format(len(scope)),
                    *(int(s) % 2**64 for s in scope)),
        digest_size=16).digest()


def _generator(*scope):
    key = np.frombuffer(_key_bytes(*scope), dtype=np.uint64)
    return np.random.Generator(np.random.Philox(key=key))


def world_rng(base_seed, epoch):
    """Stream identical on every process for (base_seed, epoch)."""
    return _generator(_WORLD_TAG, np.uint64(base_seed), np.uint64(epoch), 0)


def worker_rng(base_seed, epoch, dp_rank, num_dp_groups, worker,
               num_workers):
    """Stream per (epoch, dp_rank, worker)."""
    if not (0 <= dp_rank < num_dp_groups):
        raise ValueError("dp_rank {} out of range [0, {})".format(
            dp_rank, num_dp_groups))
    if not (0 <= worker < num_workers):
        raise ValueError("worker {} out of range [0, {})".format(
            worker, num_workers))
    return _generator(
        _WORKER_TAG,
        np.uint64(base_seed),
        np.uint64(epoch),
        np.uint64(dp_rank) << np.uint64(32) | np.uint64(worker),
    )


def sample_rng(base_seed, *scope):
    """A one-off stream keyed by arbitrary non-negative ints."""
    key = [_SAMPLE_TAG, np.uint64(base_seed)]
    key.extend(np.uint64(s) for s in scope)
    return _generator(*key)


def sample_key_bytes(base_seed, *scope):
    """The 16-byte Philox key of ``sample_rng(base_seed, *scope)``'s
    stream: what the native engine needs to replay that exact stream."""
    key = [_SAMPLE_TAG, np.uint64(base_seed)]
    key.extend(np.uint64(s) for s in scope)
    return _key_bytes(*key)


def shuffle(rng, seq):
    """In-place shuffle of a list: the stable argsort of one batch of raw
    uniform draws (one ``random(len(seq))`` draw per call). Span views
    (``preprocess.readers.DocSpans``) permute their offset arrays in
    place under the same draw."""
    perm = np.argsort(rng.random(len(seq)), kind="stable")
    if hasattr(seq, "take_"):
        seq.take_(perm)
        return seq
    seq[:] = [seq[i] for i in perm]
    return seq


# Cross-engine counter RNG (SplitMix64 contract), frozen:
#
#   key      = fold(parts): k := mix64(k + p_i) starting from 0xA0761D6478BD642F
#   draw(i)  = mix64(key + (i+1) * 0x9E3779B97F4A7C15),  i = 0, 1, 2, ...
#   uniform  = (draw >> 11) * 2^-53                      in [0, 1)
#   randint(lo, hi) = lo + draw % (hi - lo)
#   shuffle perm(n) = stable argsort of [uniform(0..n-1)]

MASK64 = (1 << 64) - 1
GOLDEN = 0x9E3779B97F4A7C15
_KEY_INIT = 0xA0761D6478BD642F


def mix64(z):
    """SplitMix64 finalizer (Steele et al.) on a 64-bit int."""
    z &= MASK64
    z ^= z >> 30
    z = (z * 0xBF58476D1CE4E5B9) & MASK64
    z ^= z >> 27
    z = (z * 0x94D049BB133111EB) & MASK64
    z ^= z >> 31
    return z


def stream_key(*parts):
    """Fold integer scope parts into a 64-bit stream key."""
    k = _KEY_INIT
    for p in parts:
        k = mix64((k + (int(p) & MASK64)) & MASK64)
    return k


class CounterRNG:
    """Sequential draws from one SplitMix64 stream (the contract above):
    the scalar reference the native engine matches draw for draw."""

    __slots__ = ("key", "i")

    def __init__(self, *parts):
        self.key = stream_key(*parts)
        self.i = 0

    def next_u64(self):
        self.i += 1
        return mix64((self.key + self.i * GOLDEN) & MASK64)

    def uniform(self):
        return (self.next_u64() >> 11) * (2.0 ** -53)

    def randint(self, lo, hi):
        """One draw in [lo, hi): hi exclusive, hi > lo."""
        return lo + self.next_u64() % (hi - lo)


def stable_shuffle_perm(n, *parts):
    """Permutation of range(n): stable argsort of the stream's first n
    uniforms (uint64 numpy ops, bit-exact against the scalar contract)."""
    key = np.uint64(stream_key(*parts))
    idx = np.arange(1, n + 1, dtype=np.uint64)
    z = key + idx * np.uint64(GOLDEN)
    z ^= z >> np.uint64(30)
    z *= np.uint64(0xBF58476D1CE4E5B9)
    z ^= z >> np.uint64(27)
    z *= np.uint64(0x94D049BB133111EB)
    z ^= z >> np.uint64(31)
    u = (z >> np.uint64(11)).astype(np.float64) * (2.0 ** -53)
    return np.argsort(u, kind="stable")


def choices(rng, population, weights, k=1):
    """Weighted sampling with replacement (like random.choices)."""
    w = np.asarray(weights, dtype=np.float64)
    total = w.sum()
    if total <= 0:
        raise ValueError("weights must sum to a positive value")
    idx = rng.choice(len(population), size=k, replace=True, p=w / total)
    return [population[int(i)] for i in idx]


def dropout_seed(seed, step, stream=0):
    """A 63-bit ``torch.manual_seed`` value for the dropout of train step
    ``step`` under ``seed``, the counterpart of the reference's
    ``fold_in(PRNGKey(seed), step)``. ``stream`` separates the ranks of a
    mesh that must draw different masks (the sharded steps pass the
    rank's data and sp coordinates); stream 0 is the one-device seed."""
    scope = (_DROPOUT_TAG, seed, step) + ((stream,) if stream else ())
    digest = _key_bytes(*scope)[:8]
    return int.from_bytes(digest, "little") >> 1
