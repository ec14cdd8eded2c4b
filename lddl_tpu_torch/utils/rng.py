"""Deterministic, counter-based RNG streams (the loader's subset).

Counterpart of ``lddl_tpu/utils/rng.py``: the same keying, so the port's
loader draws byte-for-byte the same streams as the reference loader —
batch identity depends on it. Every scope gets its own numpy Philox
generator whose 128-bit key is the blake2b digest of the scope tuple.

- ``world_rng(seed, epoch)``: one stream shared by all processes (file
  shuffle, per-iteration bin choice).
- ``worker_rng(seed, epoch, dp_rank, num_dp_groups, worker, num_workers)``:
  one stream per (dp group, worker), shared by every peer of a group.
- ``sample_rng(seed, *scope)``: a one-off stream (per-worker dynamic
  masking in the collate).

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


def shuffle(rng, seq):
    """In-place shuffle of a list: the stable argsort of one batch of raw
    uniform draws (one ``random(len(seq))`` draw per call)."""
    perm = np.argsort(rng.random(len(seq)), kind="stable")
    seq[:] = [seq[i] for i in perm]
    return seq


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
