"""Mesh-aware batch placement: a rank's local numpy batch -> tensors on
its device.

Counterpart of ``lddl_tpu/loader/sharding.py``:

- ``dp_info_of_process``: the grouping rule over a plain ndarray of
  device-like objects (anything with a ``process_index``), a copy of the
  reference's, callable with synthetic layouts;
- ``process_dp_info(mesh)``: (dp_rank, num_dp_groups) of the calling
  rank, from the ``DeviceMesh``'s rank grid (one process per device, so
  a rank's ``process_index`` is the rank itself): tp and sp peers share
  their dp_rank and draw identical batches;
- ``to_device_batch``, ``to_device_step_batches``: each rank's local
  batch goes onto its own device as plain tensors. The rows a rank holds
  are its block of the global batch, so the global batch is sharded over
  the data axes (dp-major, the reference's block order) and replicated
  over tp and sp, the placement of the reference's ``batch_sharding``;
  the sharded steps compute on those local rows. No data crosses ranks.
"""

import numpy as np
import torch

from ..parallel.mesh import data_axes_of


def _batch_block_of_device(device_shape, axis_names, coords, data_axes):
    """Index of the batch block a device at ``coords`` consumes, i.e. its
    position along the flattened data axes."""
    block = 0
    for axis in data_axes:
        axis_idx = axis_names.index(axis)
        block = block * device_shape[axis_idx] + coords[axis_idx]
    return block


def dp_info_of_process(device_array, axis_names, process_index):
    """Core grouping rule of ``process_dp_info`` over a plain ndarray of
    device-like objects (anything with a ``process_index`` attribute).

    Two processes belong to the same data-parallel group iff their
    devices cover exactly the same set of batch blocks. Groups are
    ordered by their smallest block so dp_rank is stable and identical on
    every process."""
    axis_names = tuple(axis_names)
    data_axes = data_axes_of(axis_names)
    if not data_axes:
        return 0, 1
    blocks_by_process = {}
    for coords in np.ndindex(*device_array.shape):
        device = device_array[coords]
        block = _batch_block_of_device(device_array.shape, axis_names,
                                       coords, data_axes)
        blocks_by_process.setdefault(device.process_index, set()).add(block)

    groups = {}
    for proc, blocks in blocks_by_process.items():
        groups.setdefault(frozenset(blocks), []).append(proc)
    ordered = sorted(groups.keys(), key=min)
    # Block sets must tile the batch without overlap.
    seen = set()
    for blocks in ordered:
        if seen & blocks:
            raise ValueError(
                "mesh layout maps one batch block to multiple process "
                "groups; choose a mesh whose data axes align with hosts")
        seen |= blocks

    for dp_rank, blocks in enumerate(ordered):
        if process_index in groups[blocks]:
            return dp_rank, len(ordered)
    raise RuntimeError(
        "process {} owns no devices in the mesh".format(process_index))


class _Rank:
    """A mesh entry as ``dp_info_of_process`` reads it: one process per
    device, so the process index is the rank."""

    def __init__(self, rank):
        self.process_index = int(rank)


def process_dp_info(mesh):
    """(dp_rank, num_dp_groups) of the calling rank for ``mesh``; see
    ``dp_info_of_process`` for the grouping rule."""
    import torch.distributed as dist
    grid = mesh.mesh.cpu().numpy()
    ranks = np.empty(grid.shape, dtype=object)
    for coords in np.ndindex(*grid.shape):
        ranks[coords] = _Rank(grid[coords])
    return dp_info_of_process(ranks, mesh.mesh_dim_names, dist.get_rank())


def to_device_batch(batch, mesh):
    """This rank's batch dict (numpy arrays or tensors) -> dict of tensors
    on its device: its block of the global batch of ``local_batch *
    num_dp_groups`` rows. Every rank passes its own dp group's batch
    (identical within a group, as the loader's dp_rank makes it).

    Every rank must pass arrays of the same non-batch shape: use the
    loader's ``fixed_seq_lengths`` (or packed rows) on a mesh with more
    than one dp group."""
    if mesh.device_type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device(mesh.device_type)
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def to_device_step_batches(batches, mesh):
    """Stacked local batches ``{k: [n_steps, local_batch, ...]}`` -> the
    same on this rank's device, for ``models.make_sharded_multi_step``."""
    return to_device_batch(batches, mesh)
