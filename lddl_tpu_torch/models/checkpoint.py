"""Train-state checkpoints: save, find and restore model + optimizer.

Counterpart of ``lddl_tpu/models/checkpoint.py`` (``save_train_state``,
``latest_step``, ``restore_train_state``) on
``torch.distributed.checkpoint``: in its single-process mode without a
process group, and collectively from every rank of a world once one is
up, each rank writing and reading its own shards of a sharded model
(``create_train_state``). Each save writes one directory named by its
step under ``ckpt_dir`` (a filesystem every rank sees), built in a hidden
temporary directory and published atomically by rank 0
(``utils.io.atomic_publish``), so a crash mid-save leaves the previous
step intact; ``keep`` prunes the oldest steps.

The payload: the params, AdamW's ``exp_avg``/``exp_avg_sq`` and ``step``
per parameter, the schedule's update count and the train step counter.
With the train step's dropout a function of (seed, update count), a
restored run continues bit for bit like the uninterrupted one:

    step = restore_train_state(ckpt_dir, model, optimizer)
    loader = get_bert_pretrain_data_loader(..., start_epoch=step // steps_per_epoch)
"""

import contextlib
import os
import shutil
import warnings

import torch

from ..utils.io import atomic_publish
from .sharding import reshard

_TMP_PREFIX = ".tmp-"


@contextlib.contextmanager
def _dcp():
    """``torch.distributed.checkpoint``, quiet about running without a
    process group (its single-process mode is the point here)."""
    import torch.distributed.checkpoint as dcp
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="torch.distributed is "
                                "disabled, unavailable or uninitialized")
        yield dcp


def _payload(model, optimizer, step):
    """The state dict that is saved and restored in place: tensors of the
    live model and optimizer, so a restore writes straight into them.
    Optimizer state a fresh optimizer has not made yet is made as zeros;
    a sharded model gives its shards."""
    reshard(model)
    opt = optimizer.optimizer
    names = {p: n for n, p in model.named_parameters()}
    moments = {}
    for p in optimizer.params:
        state = opt.state[p]
        if not state:
            state["step"] = torch.zeros((), dtype=torch.float32)
            state["exp_avg"] = torch.zeros_like(
                p, dtype=optimizer.mu_dtype,
                memory_format=torch.preserve_format)
            state["exp_avg_sq"] = torch.zeros_like(
                p, memory_format=torch.preserve_format)
        moments[names[p]] = {k: state[k]
                             for k in ("step", "exp_avg", "exp_avg_sq")}
    return {
        "params": dict(model.state_dict()),
        "adamw": moments,
        "schedule_count": torch.tensor(optimizer.step_count,
                                       dtype=torch.int64),
        "step": torch.tensor(int(step), dtype=torch.int64),
    }


def _world():
    """(rank, world size) of the process group; (0, 1) without one."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _barrier(world):
    if world > 1:
        import torch.distributed as dist
        dist.barrier()


def _steps(ckpt_dir):
    return sorted(int(d) for d in os.listdir(ckpt_dir) if d.isdigit())


def save_train_state(ckpt_dir, model, optimizer, step, keep=3):
    """Save the model and optimizer (a ``models.train.make_optimizer``)
    as step ``step`` under ``ckpt_dir``; prune to the ``keep`` newest
    steps. Returns the saved step. A step saved already raises."""
    step = int(step)
    rank, world = _world()
    final = os.path.join(ckpt_dir, str(step))
    if os.path.exists(final):
        raise FileExistsError("step {} is already saved under {}".format(
            step, ckpt_dir))
    pid = [os.getpid()]
    if world > 1:
        import torch.distributed as dist
        dist.broadcast_object_list(pid, src=0)
    tmp = os.path.join(ckpt_dir, "{}{}.{}".format(_TMP_PREFIX, step, pid[0]))
    if rank == 0:
        os.makedirs(ckpt_dir, exist_ok=True)
        shutil.rmtree(tmp, ignore_errors=True)
    _barrier(world)
    try:
        with _dcp() as dcp:
            dcp.save(_payload(model, optimizer, step), checkpoint_id=tmp)
        _barrier(world)
        if rank == 0:
            atomic_publish(tmp, final)
    finally:
        if rank == 0:
            shutil.rmtree(tmp, ignore_errors=True)
    if rank == 0:
        for old in _steps(ckpt_dir)[:-keep] if keep else []:
            shutil.rmtree(os.path.join(ckpt_dir, str(old)))
    _barrier(world)
    return step


def latest_step(ckpt_dir):
    """The newest saved step under ``ckpt_dir``; None when the directory
    does not exist or holds none. Read-only."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def restore_train_state(ckpt_dir, model, optimizer, step=None):
    """Load step ``step`` (default: the newest) into ``model`` and
    ``optimizer`` in place: every param, AdamW moment and count comes
    from the checkpoint. Returns the restored train step counter. Raises
    ``FileNotFoundError`` when there is no such checkpoint."""
    if step is None:
        step = latest_step(ckpt_dir)
    path = None if step is None else os.path.join(ckpt_dir, str(int(step)))
    if path is None or not os.path.isdir(path):
        raise FileNotFoundError("no checkpoint{} under {}".format(
            "" if step is None else " for step {}".format(step), ckpt_dir))
    payload = _payload(model, optimizer, 0)
    with _dcp() as dcp:
        dcp.load(payload, checkpoint_id=path)
    optimizer.set_step_count(int(payload["schedule_count"]))
    return int(payload["step"])
