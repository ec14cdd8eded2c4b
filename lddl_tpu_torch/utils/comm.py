"""The communicator interface and its world of one, without torch.

``parallel.distributed`` re-exports both beside the torch-backed
communicators. They live here so that what runs on one host without a
process group (the preprocess runner and its pool workers, the balancer,
the ingest service and its helper hosts) imports no torch, and so loads
no CUDA library.
"""

import numpy as np


class Communicator:
    """Interface. Ranks are 0..world_size-1."""

    @property
    def rank(self):
        raise NotImplementedError

    @property
    def world_size(self):
        raise NotImplementedError

    def barrier(self):
        raise NotImplementedError

    def allreduce_sum(self, values):
        """Element-wise sum of an int64 numpy vector across ranks."""
        raise NotImplementedError

    def allreduce_max(self, values):
        raise NotImplementedError


class LocalCommunicator(Communicator):

    @property
    def rank(self):
        return 0

    @property
    def world_size(self):
        return 1

    def barrier(self):
        pass

    def allreduce_sum(self, values):
        return np.array(values, dtype=np.int64, copy=True)

    def allreduce_max(self, values):
        return np.array(values, dtype=np.int64, copy=True)
