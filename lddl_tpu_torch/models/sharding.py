"""The sharding plan of the model stack on a ``DeviceMesh``.

Counterpart of ``LOGICAL_AXIS_RULES`` and ``axis_rules_for``
(``lddl_tpu/models/bert.py``) and of what XLA does with them there. One
plan, derived from the same rule table and filtered by the mesh's axes,
serves BERT and BART:

- tp (``torch.distributed.tensor.parallel``): a Dense whose kernel's
  output axis maps to tp ("heads", "mlp", "vocab") is column-parallel, one
  whose input axis does is row-parallel. The vocabulary projection keeps
  its logits sharded (a ``DTensor`` on tp), and ``token_cross_entropy``
  reduces the cross entropy across tp without gathering them.
- fsdp (FSDP2 ``fully_shard``): "embed" and the embedding-table rows
  ("embed_vocab") map to fsdp, so every parameter is sharded over fsdp:
  each encoder (and decoder) layer is one unit, the root the last. FSDP2
  shards each parameter's dim 0.
- dp and sp: parameters are replicated; ``reduce_replicated_grads`` sums
  the gradients over dp x sp after the backward. With fsdp that makes dp
  x fsdp HSDP (replicate over dp, shard over fsdp).

Gradients are sums, never averages: the sharded steps make each rank's
loss its share of the global batch's loss (global denominators,
``data_sum``), so the sum over ranks is the global gradient.
"""

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Shard

from ..parallel.mesh import (AXIS_FSDP, AXIS_TP, DATA_AXES, REPLICA_AXES,
                             axes_mesh, get_abstract_mesh)
from .attention import MultiHeadAttention

# Logical-to-mesh rules, the reference's table. "embed" names parameter
# embed dims (fsdp); activations use "act_embed", since their batch dim
# already rides fsdp. Embedding-table rows ("embed_vocab") shard over fsdp
# only.
LOGICAL_AXIS_RULES = (
    ("batch", ("dp", "fsdp")),
    ("seq", "sp"),
    ("embed", "fsdp"),
    ("act_embed", None),
    ("embed_out", None),
    ("mlp", "tp"),
    ("heads", "tp"),
    ("kv", None),
    ("vocab", "tp"),
    ("embed_vocab", "fsdp"),
)


def axis_rules_for(mesh):
    """LOGICAL_AXIS_RULES restricted to the axes ``mesh`` has, so one plan
    runs on any mesh (dp-only, dp x tp, dp x tp x sp, ...)."""
    names = mesh.mesh_dim_names
    rules = []
    for logical, target in LOGICAL_AXIS_RULES:
        if isinstance(target, tuple):
            present = tuple(a for a in target if a in names)
            rules.append((logical, present if present else None))
        elif target is not None and target not in names:
            rules.append((logical, None))
        else:
            rules.append((logical, target))
    return tuple(rules)


def tp_plan(model, mesh):
    """{module path: ParallelStyle} for ``parallelize_module``: every Dense
    named in a module's ``LOGICAL_AXES`` whose output axis maps to tp is
    column-parallel (the vocabulary projection keeps its logits sharded),
    one whose input axis does is row-parallel."""
    from torch.distributed.tensor.parallel import (ColwiseParallel,
                                                   RowwiseParallel)
    rules = dict(axis_rules_for(mesh))
    plan = {}
    for path, module in model.named_modules():
        for child, (axis_in, axis_out) in getattr(module, "LOGICAL_AXES",
                                                  {}).items():
            name = "{}.{}".format(path, child) if path else child
            if rules.get(axis_out) == AXIS_TP:
                plan[name] = (ColwiseParallel(output_layouts=Shard(-1),
                                              use_local_output=False)
                              if axis_out == "vocab" else ColwiseParallel())
            elif rules.get(axis_in) == AXIS_TP:
                plan[name] = RowwiseParallel()
    return plan


def shard_model(model, mesh):
    """Apply the plan to ``model`` in place: tensor parallelism on tp, then
    FSDP2 on fsdp (each layer holding an attention, then the root), with
    the gradient reduced as a sum. Returns the model.

    Each style applies wherever the mesh names its axis, size 1 included,
    as the reference's rule table reads. XLA compiles a size-1 axis away;
    here it still runs DTensor's dispatch and FSDP2's hooks, so a mesh
    should name only the axes it shards over."""
    from torch.distributed.tensor.parallel import parallelize_module
    names = mesh.mesh_dim_names
    if AXIS_TP in names:
        parallelize_module(model, mesh[AXIS_TP], tp_plan(model, mesh))
    if AXIS_FSDP in names:
        from torch.distributed.fsdp import FSDPModule, fully_shard
        for layer in model.children():
            if any(isinstance(c, MultiHeadAttention)
                   for c in layer.children()):
                fully_shard(layer, mesh=mesh[AXIS_FSDP])
        fully_shard(model, mesh=mesh[AXIS_FSDP])
        for module in model.modules():
            if isinstance(module, FSDPModule):
                module.set_gradient_divide_factor(1.0)
                module.set_force_sum_reduction_for_comms(True)
    return model


def reshard(model):
    """Free the unsharded parameters FSDP2 keeps after a forward without a
    backward (its root keeps them for the backward it expects), so the
    module holds its sharded parameters again."""
    from torch.distributed.fsdp import FSDPModule
    for module in model.modules():
        if isinstance(module, FSDPModule):
            module.reshard()


def _local(t):
    return t.to_local() if isinstance(t, DTensor) else t


def reduce_replicated_grads(model, mesh):
    """Sum every gradient over the replica axes (dp x sp) in one
    all-reduce per dtype; a no-op where they have one rank."""
    import torch.distributed as dist
    replicas = axes_mesh(mesh, REPLICA_AXES)
    if replicas is None or replicas.size() == 1:
        return
    grads = [_local(p.grad) for p in model.parameters()
             if p.grad is not None]
    for dtype in sorted({g.dtype for g in grads}, key=str):
        group = [g for g in grads if g.dtype == dtype]
        flat = torch.cat([g.reshape(-1) for g in group])
        dist.all_reduce(flat, group=replicas.get_group())
        for g, part in zip(group, flat.split([g.numel() for g in group])):
            g.copy_(part.view_as(g))


def replication_counts(tensors):
    """For each tensor, the number of ranks of the world that hold the same
    values: a DTensor is the same across the mesh dims it replicates and
    the world's ranks outside its mesh, and distinct across every other
    dim (``Shard``, and the ``_StridedShard`` of FSDP2 over tp, which is
    no ``is_shard()``); a plain tensor is the same on every rank."""
    import torch.distributed as dist
    world = dist.get_world_size()
    counts = []
    for t in tensors:
        count = world
        if isinstance(t, DTensor):
            mesh = t.device_mesh
            count = world // mesh.size()
            for dim, placement in enumerate(t.placements):
                if placement.is_replicate():
                    count *= mesh.size(dim)
        counts.append(count)
    return counts


def data_sum(*tensors):
    """``tensors`` (of one dtype) summed over the ambient mesh's data axes
    (the global batch's value from each rank's share); returned as they
    are outside a mesh or on one data rank. Not differentiable."""
    import torch.distributed as dist
    mesh = get_abstract_mesh()
    group = None if mesh is None else axes_mesh(mesh, DATA_AXES)
    if group is None or group.size() == 1:
        return tensors
    flat = torch.stack([t.detach() for t in tensors])
    dist.all_reduce(flat, group=group.get_group())
    return tuple(flat.unbind())


def _gather_stack(t, group):
    """[ranks, *t.shape]: ``t`` from every rank of ``group``."""
    import torch.distributed as dist
    n = dist.get_world_size(group)
    t = t.contiguous().reshape(1, -1)
    out = t.new_empty((n, t.shape[1]))
    dist.all_gather_into_tensor(out, t, group=group)
    return out


class _VocabParallelCrossEntropy(torch.autograd.Function):
    """Cross entropy and argmax of fp32 logits sharded over the vocabulary
    (last dim) across a tp group; ``offset`` is the rank's first vocab id.
    Moves a max, a sum and the label's logit per row, never the logits."""

    @staticmethod
    def forward(ctx, logits, labels, group, offset):
        import torch.distributed as dist
        v_local = logits.shape[-1]
        local_max, local_arg = logits.max(dim=-1)
        top = local_max.clone()
        dist.all_reduce(top, op=dist.ReduceOp.MAX, group=group)
        exp = (logits - top[..., None]).exp()
        total = exp.sum(dim=-1)
        dist.all_reduce(total, group=group)
        local_label = labels - offset
        inside = (local_label >= 0) & (local_label < v_local)
        idx = local_label.clamp(0, v_local - 1)
        picked = torch.where(inside, logits.gather(-1, idx[..., None])[..., 0]
                             - top, 0.0)
        dist.all_reduce(picked, group=group)
        ll = total.log() - picked
        # Global argmax: the largest local max, the lowest vocab id on ties
        # (ranks hold ascending vocab ranges), as torch.argmax picks.
        maxes = _gather_stack(local_max, group)
        args = _gather_stack(local_arg + offset, group)
        pred = args.gather(0, maxes.argmax(dim=0, keepdim=True))[0].view(
            labels.shape)
        ctx.save_for_backward(exp / total[..., None], idx, inside)
        ctx.mark_non_differentiable(pred)
        return ll, pred

    @staticmethod
    def backward(ctx, grad_ll, grad_pred):
        softmax, idx, inside = ctx.saved_tensors
        grad = softmax * grad_ll[..., None]
        grad.scatter_add_(-1, idx[..., None],
                          -torch.where(inside, grad_ll, 0.0)[..., None])
        return grad, None, None, None


def token_cross_entropy(logits, labels):
    """(per-token cross entropy, argmax) of ``logits`` [..., vocab] at
    ``labels`` [...] (valid ids). Logits sharded over the vocabulary (a
    ``DTensor`` on tp from the plan's vocabulary projection) reduce across
    tp without a gather; plain logits take ``F.cross_entropy``."""
    if isinstance(logits, DTensor):
        mesh = logits.device_mesh
        if mesh.size() > 1:
            if (mesh.ndim != 1 or not logits.placements[0].is_shard()
                    or logits.placements[0].dim % logits.ndim
                    != logits.ndim - 1):
                raise ValueError("token_cross_entropy takes logits sharded "
                                 "over the vocabulary on one mesh axis, got "
                                 "{}".format(logits.placements))
            chunk = -(-logits.shape[-1] // mesh.size())
            return _VocabParallelCrossEntropy.apply(
                logits.to_local().float(), labels.long(), mesh.get_group(),
                mesh.get_local_rank() * chunk)
        logits = logits.to_local()
    ll = F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]),
                         labels.reshape(-1).long(),
                         reduction="none").reshape(labels.shape)
    return ll, logits.argmax(dim=-1)
