"""Rank bodies of the multi-rank CPU tests.

The tests run them in gloo worlds of spawned processes
(``parallel.run_world(n, fn, *args, device="cpu")``). They take and
return numpy arrays and plain Python values only (inputs made from a
seed, or read from ``.npz`` files the caller wrote), so a test can hold
them against another package's results on the same inputs.
"""

import numpy as np
import torch


def _np(t):
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        t = t.full_tensor()
    return t.detach().cpu().float().numpy()


def full_state(model):
    """{name: numpy} of the unsharded parameters (collective)."""
    return {n: _np(p) for n, p in model.named_parameters()}


def _config(kind, cfg_kw):
    from ..models import BartConfig, BertConfig
    return (BartConfig if kind == "bart" else BertConfig).tiny(**cfg_kw)


def _model(kind, cfg):
    from ..models import (BartForPreTraining, BertForPreTraining,
                          BertForPreTrainingPacked)
    return {"bert": BertForPreTraining, "bert_packed": BertForPreTrainingPacked,
            "bart": BartForPreTraining}[kind](cfg)


def record_clip(model, opt, out):
    """Make ``opt`` keep, in ``out``, the norm its clip returns at every
    update (``out["norms"]``) and the unsharded gradients it is given at
    the first (``out["grads"]``, {name: numpy}, before the clip)."""
    names = {id(p): n for n, p in model.named_parameters()}
    clip = opt.clip_grads
    out["norms"] = []

    def recorded():
        if "grads" not in out:
            out["grads"] = {names[id(p)]: _np(p.grad).copy()
                            for p in opt.params if p.grad is not None}
        norm = clip()
        out["norms"].append(float(norm))
        return norm

    opt.clip_grads = recorded


def plant_averaged_grads():
    """The fault the gradient checks must catch: gradients averaged over
    the data ranks where the loss's global denominators need a sum.
    FSDP2 keeps its default divide factor (its sum divided by the fsdp
    ranks), and the dp x sp all-reduce is divided by its ranks."""
    from torch.distributed.fsdp import FSDPModule

    from ..models import sharding, train
    from .mesh import REPLICA_AXES, axes_mesh
    FSDPModule.set_gradient_divide_factor = lambda self, factor: None
    summed = sharding.reduce_replicated_grads

    def averaged(model, mesh):
        summed(model, mesh)
        replicas = axes_mesh(mesh, REPLICA_AXES)
        n = 1 if replicas is None else replicas.size()
        for p in model.parameters():
            if p.grad is not None:
                sharding._local(p.grad).div_(n)

    train.reduce_replicated_grads = averaged


def _rows(batch, mesh, dim=0):
    """This rank's rows of a global numpy batch: its dp group's block."""
    from ..loader.sharding import process_dp_info
    dp_rank, groups = process_dp_info(mesh)
    out = {}
    for k, v in batch.items():
        n = v.shape[dim] // groups
        out[k] = np.take(v, np.arange(dp_rank * n, (dp_rank + 1) * n),
                         axis=dim)
    return out


def train_world(spec):
    """One rank of a sharded training run described by ``spec``: builds
    the mesh, the model from ``spec["params"]`` (an .npz state dict) or
    ``spec["seed"]``, then runs ``spec["steps"]`` sharded steps on this
    rank's rows of the global batches in ``spec["batches"]`` (an .npz of
    [steps, B, ...] arrays). Returns the per-step metrics, the unsharded
    parameters after the steps, every update's clip norm, the first
    update's unsharded gradients and, when asked, eval metrics, a
    multi-step run and a checkpoint round trip. ``spec["fault"] =
    "averaged_grads"`` plants ``plant_averaged_grads`` first."""
    import functools

    from ..loader.sharding import to_device_batch, to_device_step_batches
    from ..models import (bart_batch_loss, create_train_state,
                          make_eval_step, make_optimizer,
                          make_sharded_multi_step, make_sharded_train_step)
    from ..ops import flash_attention as fa
    from .mesh import make_mesh
    if spec.get("fault") == "averaged_grads":
        plant_averaged_grads()
    mesh = make_mesh(spec["mesh"])
    kind = spec.get("model", "bert")
    cfg = _config(kind, spec.get("cfg", {}))
    params = None
    if spec.get("params"):
        params = {k: torch.from_numpy(v)
                  for k, v in np.load(spec["params"]).items()}
    torch.manual_seed(spec.get("seed", 0))
    model, opt = create_train_state(
        cfg, mesh, model=_model(kind, cfg), params=params,
        optimizer=functools.partial(make_optimizer, **spec.get("opt", {})))
    loss = bart_batch_loss if kind == "bart" else None
    data = dict(np.load(spec["batches"]))
    calls = [0]
    plain = fa.onekv_fwd_plain

    def counted(*a):
        calls[0] += 1
        return plain(*a)

    fa.onekv_fwd_plain = counted
    out = {"metrics": [], "dropout_masks": []}
    record_clip(model, opt, out)
    if spec.get("record_dropout"):
        model.embeddings.dropout.register_forward_hook(
            lambda mod, args, y: out["dropout_masks"].append(
                (y != 0).numpy()) if mod.training else None)
    seed = spec.get("dropout_seed", 0)

    def batch_of(i):
        return to_device_batch(
            _rows({k: v[i % len(v)] for k, v in data.items()}, mesh), mesh)

    try:
        step = make_sharded_train_step(mesh, model, opt, batch_loss=loss)
        for i in range(spec["steps"]):
            m = step(batch_of(i), seed=seed)
            out["metrics"].append({k: float(v) for k, v in m.items()})
        if spec.get("multi"):
            multi = make_sharded_multi_step(mesh, model, opt, spec["multi"],
                                            batch_loss=loss)
            m = multi(to_device_step_batches(
                _rows({k: v[:spec["multi"]] for k, v in data.items()}, mesh,
                      dim=1), mesh), seed=spec.get("dropout_seed", 0))
            out["multi"] = {k: v.cpu().numpy() for k, v in m.items()}
        if spec.get("eval"):
            m = make_eval_step(model, batch_loss=loss, mesh=mesh)(
                to_device_batch(_rows({k: v[0] for k, v in data.items()},
                                      mesh), mesh))
            out["eval"] = {k: float(v) for k, v in m.items()}
        if spec.get("checkpoint"):
            out["checkpoint"] = _checkpoint_round_trip(
                spec, kind, cfg, mesh, model, opt, step, batch_of, loss,
                seed)
    finally:
        fa.onekv_fwd_plain = plain
    out["kernel_calls"] = calls[0]
    out["params"] = full_state(model)
    out["param_types"] = sorted({type(p).__name__
                                 for p in model.parameters()})
    out["moment_dtypes"] = sorted({str(st["exp_avg"].dtype) for st in
                                   opt.optimizer.state.values()})
    return out


def _checkpoint_round_trip(spec, kind, cfg, mesh, model, opt, step,
                           batch_of, loss, seed):
    """Save the sharded state, restore it into a model and optimizer
    built from another seed, then one more step from each on the same
    batch: (live loss, resumed loss, local tensors that differ)."""
    import functools

    from ..models import (create_train_state, make_optimizer,
                          make_sharded_train_step, restore_train_state,
                          save_train_state)
    count = opt.step_count
    save_train_state(spec["checkpoint"], model, opt, count)
    torch.manual_seed(spec.get("seed", 0) + 1)
    fresh, fresh_opt = create_train_state(
        cfg, mesh, model=_model(kind, cfg),
        optimizer=functools.partial(make_optimizer, **spec.get("opt", {})))
    restored = restore_train_state(spec["checkpoint"], fresh, fresh_opt)
    batch = batch_of(spec["steps"])
    resumed = make_sharded_train_step(mesh, fresh, fresh_opt,
                                      batch_loss=loss)(batch, seed=seed)
    live = step(batch, seed=seed)

    def local(t):
        return t.to_local() if hasattr(t, "to_local") else t

    differ = [n for (n, a), b in zip(model.state_dict().items(),
                                     fresh.state_dict().values())
              if not torch.equal(local(a), local(b))]
    return {"restored": restored, "count": count,
            "live": float(live["loss"]), "resumed": float(resumed["loss"]),
            "differ": differ}


def eval_meshes_world(meshes, cfg_kw, params, batch_path):
    """The eval loss of one global batch on each of ``meshes`` (a rank of
    a world that fits them all), from the weights in ``params``."""
    from ..loader.sharding import to_device_batch
    from ..models import BertConfig, create_train_state, make_eval_step
    from .mesh import make_mesh
    state = {k: torch.from_numpy(v) for k, v in np.load(params).items()}
    batch = dict(np.load(batch_path))
    losses = []
    for axes in meshes:
        mesh = make_mesh(axes)
        model, _ = create_train_state(BertConfig.tiny(**cfg_kw), mesh,
                                      params=state)
        metrics = make_eval_step(model, mesh=mesh)(
            to_device_batch(_rows(batch, mesh), mesh))
        losses.append(float(metrics["loss"]))
    return losses


def communicator_world():
    """A rank of the communicator checks: int64 sum and max past 2^31, a
    barrier, what ``get_communicator`` and ``node_info`` give, and the
    rendezvous variables ``run_world`` set."""
    import os
    from .distributed import TorchCommunicator, get_communicator, node_info
    comm = get_communicator()
    big = np.array([2**31 + comm.rank, -(2**40), comm.rank], np.int64)
    out = {"type": type(comm).__name__, "rank": comm.rank,
           "world": comm.world_size, "node": node_info(),
           "master_port": os.environ.get("MASTER_PORT"),
           "agent_store": os.environ.get("TORCHELASTIC_USE_AGENT_STORE"),
           "sum": comm.allreduce_sum(big), "max": comm.allreduce_max(big)}
    comm.barrier()
    out["is_torch"] = isinstance(comm, TorchCommunicator)
    return out


def mesh_world():
    """A rank of the mesh checks on a world of 4: shapes, the -1 rule, the
    errors, the data axes, the rank rule on the real mesh, the batch
    placement and the default device."""
    from .. import resolve_device
    from ..loader.sharding import process_dp_info, to_device_batch
    from .mesh import (axis_rank, data_parallel_size, get_abstract_mesh,
                       make_mesh, mesh_data_axes, set_mesh)
    out = {}
    mesh = make_mesh({"dp": 2, "tp": 2})
    out["shape"] = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    out["dp_size"] = data_parallel_size(mesh)
    out["data_axes"] = mesh_data_axes(mesh)
    out["dp_info"] = process_dp_info(mesh)
    out["coords"] = (axis_rank(mesh, "dp"), axis_rank(mesh, "tp"))
    batch = to_device_batch({"x": np.full((3, 5), axis_rank(mesh, "dp"))},
                            mesh)["x"]
    out["batch"] = (type(batch).__name__, str(batch.device),
                    batch.numpy())
    out["inferred"] = dict(zip(
        ("dp", "tp"), make_mesh({"dp": -1, "tp": 2}).mesh.shape))
    full = make_mesh({"dp": 1, "fsdp": 2, "tp": 2})
    out["fsdp_dp_size"] = data_parallel_size(full)
    out["fsdp_dp_info"] = process_dp_info(full)
    with set_mesh(full):
        out["ambient"] = get_abstract_mesh() is full
    out["ambient_after"] = get_abstract_mesh()
    errors = {}
    for name, axes in (("two_inferred", {"dp": -1, "tp": -1}),
                       ("indivisible", {"dp": -1, "tp": 3}),
                       ("too_many", {"dp": 3, "tp": 4})):
        try:
            make_mesh(axes)
            errors[name] = None
        except ValueError as e:
            errors[name] = "{}: {}".format(type(e).__name__, e)
    out["errors"] = errors
    pp = make_mesh({"pp": 2, "dp": 2})
    out["pp_mesh"] = dict(zip(pp.mesh_dim_names, pp.mesh.shape))
    try:
        resolve_device()
    except RuntimeError as e:
        out["no_card"] = str(e)
    available = torch.cuda.is_available
    torch.cuda.is_available = lambda: True   # a card as the rule sees it
    try:
        out["default_device"] = str(resolve_device())
    finally:
        torch.cuda.is_available = available
    return out


def ring_world(path, bert_kw, bart_kw):
    """A rank of the ring checks on an sp-only world: ``ring_attention`` on
    this rank's blocks of the inputs in ``path`` (forward and the
    gradients of sum(out * g)), then tiny BERT's and BART's logits under
    attention_impl="ring" with the weights in ``path``, and the refusal
    of packed segments. Returns this rank's blocks and the full logits."""
    import torch.distributed as dist

    from ..models import BartConfig, BertConfig
    from ..ops.ring_attention import ring_attention
    from .mesh import axis_rank, make_mesh, set_mesh
    sp = dist.get_world_size()
    mesh = make_mesh({"sp": sp})
    r = axis_rank(mesh, "sp")
    data = dict(np.load(path))
    q, k, v = (torch.from_numpy(data[n]).chunk(sp, 1)[r].clone()
               .requires_grad_() for n in "qkv")
    mask = torch.from_numpy(data["mask"]).chunk(sp, 1)[r]
    out = ring_attention(q, k, v, mask, mesh["sp"].get_group())
    (out * torch.from_numpy(data["g"]).chunk(sp, 1)[r]).sum().backward()
    res = {"out": out.detach().numpy(), "dq": q.grad.numpy(),
           "dk": k.grad.numpy(), "dv": v.grad.numpy()}
    ids = torch.from_numpy(data["ids"])
    typ = torch.from_numpy(data["typ"])
    am = torch.from_numpy(data["am"])
    for kind, config, kw in (("bert", BertConfig, bert_kw),
                             ("bart", BartConfig, bart_kw)):
        cfg = config(attention_impl="ring", **kw)
        model = _model(kind, cfg).eval()
        model.load_state_dict({k[len(kind) + 1:]: torch.from_numpy(v)
                               for k, v in data.items()
                               if k.startswith(kind + ".")})
        with set_mesh(mesh), torch.no_grad():
            if kind == "bert":
                mlm, nsp = model(ids, typ, am)
                res["bert"] = (mlm.numpy(), nsp.numpy())
            else:
                res["bart"] = model(ids, am, torch.from_numpy(data["dec"])
                                    ).numpy()
    packed = _model("bert_packed", BertConfig(attention_impl="ring",
                                              **bert_kw))
    try:
        with set_mesh(mesh), torch.no_grad():
            packed(ids, typ, am, segments=am, position_ids=None,
                   cls_positions=torch.zeros((ids.shape[0], 1),
                                             dtype=torch.int64))
        res["packed"] = None
    except NotImplementedError as e:
        res["packed"] = str(e)
    return res


def _count_p2p(counts):
    """Make torch.distributed's point-to-point and collective calls count
    themselves into ``counts``; returns the undo. (``isend``/``irecv``
    are left alone: ``P2POp`` checks their identity, and
    ``batch_isend_irecv`` counts them.)"""
    import torch.distributed as dist
    names = ("batch_isend_irecv", "broadcast", "all_reduce", "send", "recv")
    saved = {n: getattr(dist, n) for n in names}

    def counted(name):
        def call(*a, **kw):
            counts[name] = counts.get(name, 0) + 1
            return saved[name](*a, **kw)
        return call

    for n in names:
        setattr(dist, n, counted(n))
    return lambda: [setattr(dist, n, f) for n, f in saved.items()]


def pipeline_world(path, cfg_kw, cases, train_spec=None):
    """A rank of the pipeline checks: for each ``(axes, n_micro, dtype)``
    of ``cases`` (dtype a torch attribute name), the mesh, this rank's
    stage of ``make_pipelined_encoder`` loaded from the stacked weights
    in ``path`` (``w.<rest>`` arrays, plus ``x`` and ``mask``), its
    output ``y``, the gradients of mean(y.float()**2) for ``x`` and the
    stage's layers ({state-dict name: numpy}), the torch.distributed
    calls it made ({name: count}) and the rank rule on the mesh. Then,
    with ``train_spec``, ``train_world(train_spec)``. Returns {"cases":
    [...], "train": ...}."""
    from ..loader.sharding import process_dp_info
    from ..models import BertConfig
    from .mesh import make_mesh
    from .pipeline import make_pipelined_encoder
    data = dict(np.load(path))
    stacked = {k[2:]: torch.from_numpy(v) for k, v in data.items()
               if k.startswith("w.")}
    out = []
    for axes, n_micro, dtype in cases:
        cfg = BertConfig.tiny(dtype=getattr(torch, dtype), **cfg_kw)
        mesh = make_mesh(axes)
        enc = make_pipelined_encoder(mesh, cfg, n_micro).load_stacked(
            stacked)
        x = torch.from_numpy(data["x"]).requires_grad_()
        calls = {}
        undo = _count_p2p(calls)
        try:
            y = enc(x, torch.from_numpy(data["mask"]))
            y.float().pow(2).mean().backward()
        finally:
            undo()
        out.append({"y": _np(y), "gx": _np(x.grad),
                    "grads": {n: _np(p.grad)
                              for n, p in enc.named_parameters()},
                    "calls": calls, "stage": enc.stage,
                    "dp_info": process_dp_info(mesh)})
    return {"cases": out,
            "train": train_world(train_spec) if train_spec else None}
