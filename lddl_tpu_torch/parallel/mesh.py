"""Device-mesh conventions on ``torch.distributed.DeviceMesh``.

Counterpart of ``lddl_tpu/parallel/mesh.py`` (axis names, ``DATA_AXES``,
``make_mesh``, ``data_axes_of``, ``mesh_data_axes``,
``data_parallel_size``) and of the ambient mesh of
``lddl_tpu/parallel/compat.py`` (``set_mesh``, ``get_abstract_mesh``),
which the attention reads to decide on the sequence-parallel paths.
``compat.shard_map`` and ``compat.pcast`` are shims over JAX versions and
have no counterpart here.

Canonical axis names (a subset may be present):

    dp    data parallel          (batch dim; params replicated)
    fsdp  fully-sharded DP       (batch dim + param shards)
    tp    tensor parallel        (heads, MLP and vocabulary dims)
    sp    sequence parallel      (sequence dim)
    pp    pipeline parallel      (encoder layer stages, parallel.pipeline)

Batches are sharded over ``DATA_AXES = ('dp', 'fsdp')``: every rank that
shares a (dp, fsdp) coordinate, i.e. the tp and sp peers, gets the same
rows, which is the loader's dp_rank contract.
"""

import contextlib
import contextvars
import math

AXIS_DP = "dp"
AXIS_FSDP = "fsdp"
AXIS_TP = "tp"
AXIS_SP = "sp"
AXIS_PP = "pp"

# Mesh axes over which the global batch is sharded.
DATA_AXES = (AXIS_DP, AXIS_FSDP)
# Mesh axes over which parameters are replicated and gradients summed
# outside FSDP: data-parallel replicas and the sequence shards.
REPLICA_AXES = (AXIS_DP, AXIS_SP)

_AMBIENT = contextvars.ContextVar("lddl_tpu_torch_mesh", default=None)


def make_mesh(axis_sizes, device_type=None, ranks=None):
    """A ``DeviceMesh`` over the ranks of the default process group from
    {axis_name: size}; size -1 means "absorb the rest".

    Axis order follows the insertion order of ``axis_sizes``, rank-major
    as ``init_device_mesh`` lays it out. Axes of size 1 are kept.
    ``device_type`` defaults to the group's: ``cuda`` under NCCL, ``cpu``
    under gloo. The process group must be up (``init_distributed``).

    ``ranks`` (the reference's ``devices``) lays the mesh over those world
    ranks only, in order. Every rank of the world still calls it, since
    making a group is collective; a rank outside gets a mesh whose
    ``get_coordinate()`` is None and must not use it. Such a mesh may
    have one data axis and one replica axis at most: their flattened
    groups would be made by the mesh's ranks alone."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs the process group: call "
                           "parallel.init_distributed() first")
    n = dist.get_world_size() if ranks is None else len(ranks)
    names = list(axis_sizes.keys())
    sizes = list(axis_sizes.values())
    if sizes.count(-1) > 1:
        raise ValueError("at most one axis may be -1")
    known = math.prod(s for s in sizes if s != -1)
    if -1 in sizes:
        if n % known != 0:
            raise ValueError(
                "cannot infer -1 axis: {} devices not divisible by {}".format(
                    n, known))
        sizes[sizes.index(-1)] = n // known
    if math.prod(sizes) != n:
        raise ValueError(
            "mesh {} needs {} devices, have {}".format(
                dict(zip(names, sizes)), math.prod(sizes), n))
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    if ranks is None:
        mesh = init_device_mesh(device_type, tuple(sizes),
                                mesh_dim_names=tuple(names))
    else:
        flat = [axes for axes in (data_axes_of(names),
                                  tuple(a for a in names
                                        if a in REPLICA_AXES))
                if len(axes) > 1]
        if flat:
            raise ValueError("a mesh over some ranks cannot flatten {}"
                             .format(flat))
        mesh = DeviceMesh(device_type,
                          torch.tensor(list(ranks)).reshape(sizes),
                          mesh_dim_names=tuple(names))
        if mesh.get_coordinate() is None:
            return mesh
    # Make the flattened groups now, at one point of every rank's program
    # (making a group is collective over the world).
    axes_mesh(mesh, mesh_data_axes(mesh))
    axes_mesh(mesh, tuple(a for a in names if a in REPLICA_AXES))
    return mesh


def data_axes_of(axis_names):
    """The data axes among ``axis_names``, in given order."""
    return tuple(a for a in axis_names if a in DATA_AXES)


def mesh_data_axes(mesh):
    """The data axes present in this mesh, in mesh order."""
    return data_axes_of(mesh.mesh_dim_names)


def data_parallel_size(mesh):
    """Number of data-parallel groups = product of data-axis sizes."""
    return math.prod(axis_size(mesh, a) for a in mesh_data_axes(mesh))


def axis_size(mesh, name):
    """Size of axis ``name``; 1 when ``mesh`` is None or lacks it."""
    if mesh is None or name not in mesh.mesh_dim_names:
        return 1
    return mesh.size(mesh.mesh_dim_names.index(name))


def axis_rank(mesh, name):
    """This rank's coordinate on axis ``name``; 0 when absent."""
    if mesh is None or name not in mesh.mesh_dim_names:
        return 0
    return mesh.get_local_rank(name)


def axes_mesh(mesh, axes):
    """The 1-D mesh over ``axes`` (one axis, or several flattened in mesh
    order, named by joining them with '_'); None when ``axes`` is empty.
    Flattening is cached by name, so a second call makes no group."""
    axes = tuple(a for a in mesh.mesh_dim_names if a in axes)
    if not axes:
        return None
    if len(axes) == 1:
        return mesh[axes[0]]
    return mesh[axes]._flatten("_".join(axes))


def data_index(mesh):
    """This rank's batch block: its position along the flattened data
    axes (dp-major), the block order of ``loader.sharding``."""
    block = 0
    for a in mesh_data_axes(mesh):
        block = block * axis_size(mesh, a) + axis_rank(mesh, a)
    return block


@contextlib.contextmanager
def set_mesh(mesh):
    """Context manager making ``mesh`` the ambient mesh of the model code
    run inside it (the sharded steps enter it)."""
    token = _AMBIENT.set(mesh)
    try:
        yield mesh
    finally:
        _AMBIENT.reset(token)


def get_abstract_mesh():
    """The ambient mesh, or None outside ``set_mesh``."""
    return _AMBIENT.get()
