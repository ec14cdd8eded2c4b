"""Value types shared across pipeline stages.

Counterpart of ``lddl_tpu/utils/types.py``.
"""

import dataclasses


@dataclasses.dataclass
class File:
    """A data shard on disk together with its sample count: the currency
    of the load balancer."""

    path: str
    num_samples: int
