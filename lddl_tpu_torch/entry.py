"""Entry points: the BERT-base forward and the multi-device dryrun.

Counterpart of ``__graft_entry__.py`` (``entry``, ``_mesh_axes_for``,
``dryrun_multichip``):

- ``entry()``: the BERT-base pretraining forward (eval mode) and its
  example arguments on the card, for a one-device check;
- ``dryrun_multichip(n)``: one full sharded training step of tiny BERT
  and BART (forward, backward, clip, AdamW with sharded parameters and
  moments) on a world of n ranks over a mesh with real dp/fsdp/tp/sp
  axes. It joins the process group when one is up (a world of n, e.g.
  under ``torchrun``), else starts n local processes: NCCL, one card
  each, by default; gloo on the CPU with ``device="cpu"``. At n >= 2 its
  pipeline leg runs tiny BERT's encoder as a GPipe pipeline over a
  {pp: 2, dp: n // 2} mesh on the first 2·(n // 2) ranks against the
  unpipelined stack (``pp2_gpipe_max_err``).
"""

import functools

import numpy as np
import torch

from .testing import (fake_bart_batch, fake_hidden_states,
                      fake_pretrain_batch)


def _example_batch(vocab_size, batch, seq_len, seed=0):
    return fake_pretrain_batch(vocab_size, batch, seq_len, seed=seed,
                               segment_split=True)


def entry(device=None):
    """(fn, example_args): BERT-base's pretraining forward, ``fn(input_ids,
    token_type_ids, attention_mask)`` -> (mlm_logits, nsp_logits), with
    random weights from seed 0 on ``device`` (the card by default)."""
    from . import resolve_device
    from .models import BertConfig, BertForPreTraining
    dev = resolve_device(device)
    cfg = BertConfig.bert_base()
    torch.manual_seed(0)
    with dev:
        model = BertForPreTraining(cfg).eval()
    batch = _example_batch(cfg.vocab_size, batch=4, seq_len=128)

    def forward(input_ids, token_type_ids, attention_mask):
        with torch.no_grad():
            return model(input_ids, token_type_ids, attention_mask)

    example_args = tuple(torch.from_numpy(batch[k]).to(dev)
                         for k in BertForPreTraining.BATCH_INPUTS)
    return forward, example_args


def _mesh_axes_for(n_devices):
    """Spread n devices over (dp, fsdp, tp, sp). Every nontrivial axis
    joins as soon as a factor of 2 is available, so at 8 devices the mesh
    is {dp:1, fsdp:2, tp:2, sp:2} and one dryrun drives parameter
    sharding, tensor parallelism and the sp ring together; dp absorbs what
    remains."""
    axes = {"dp": 1, "fsdp": 1, "tp": 1, "sp": 1}
    remaining = n_devices
    for name in ("sp", "fsdp", "tp"):
        if remaining % 2 == 0:
            axes[name] = 2
            remaining //= 2
    axes["dp"] = remaining
    return axes


class _SimDevice:

    def __init__(self, process_index):
        self.process_index = process_index


def _fsdp_sharded(tensors):
    """How many of ``tensors`` are DTensors sharded on the fsdp axis
    (``Shard``, or ``_StridedShard`` where tp shards the same dim)."""
    from torch.distributed.tensor import DTensor
    return sum(1 for t in tensors if isinstance(t, DTensor)
               and any(not p.is_replicate() and name == "fsdp"
                       for p, name in zip(t.placements,
                                          t.device_mesh.mesh_dim_names)))


def _dryrun_rank(n_devices):
    """One rank of ``dryrun_multichip``; returns its summary."""
    import torch.distributed as dist

    from .loader.sharding import (dp_info_of_process, process_dp_info,
                                  to_device_batch)
    from .models import (BartConfig, BartForPreTraining, BertConfig,
                         bart_batch_loss, create_train_state, make_optimizer,
                         make_sharded_train_step)
    from .parallel.mesh import data_parallel_size, make_mesh
    axes = _mesh_axes_for(n_devices)
    mesh = make_mesh(axes)
    names = mesh.mesh_dim_names

    # The dp-group rule on a simulated one-host-per-dp-block layout, then
    # on this world (one process per rank).
    shape = tuple(axes[a] for a in names)
    sim = np.empty(shape, dtype=object)
    for coords in np.ndindex(*shape):
        sim[coords] = _SimDevice(coords[names.index("dp")])
    for host in range(axes["dp"]):
        info = dp_info_of_process(sim, names, host)
        if info != (host, axes["dp"]):
            raise AssertionError("host-per-dp-block layout derived {} for "
                                 "host {}".format(info, host))
    dp_rank, groups = process_dp_info(mesh)
    if groups != data_parallel_size(mesh):
        raise AssertionError("{} dp groups on mesh {}".format(groups, axes))

    impl = "ring" if axes["sp"] > 1 else "dense"
    opt = functools.partial(make_optimizer, warmup_steps=1, total_steps=10)
    rows = 2
    out = {"mesh": axes, "attention": impl}
    for kind in ("bert", "bart"):
        if kind == "bert":
            cfg = BertConfig.tiny(attention_impl=impl)
            batch = _example_batch(cfg.vocab_size, rows * groups, 32)
            model, optimizer = create_train_state(cfg, mesh, optimizer=opt)
            loss = None
        else:
            cfg = BartConfig.tiny(attention_impl=impl, attention_dropout=0.0)
            batch = fake_bart_batch(cfg.vocab_size, rows * groups, 32)
            torch.manual_seed(0)
            model, optimizer = create_train_state(
                cfg, mesh, optimizer=opt, model=BartForPreTraining(cfg))
            loss = bart_batch_loss
        local = {k: v[dp_rank * rows:(dp_rank + 1) * rows]
                 for k, v in batch.items()}
        step = make_sharded_train_step(mesh, model, optimizer,
                                       batch_loss=loss)
        metrics = step(to_device_batch(local, mesh), seed=0)
        value = float(metrics["loss"])
        if not np.isfinite(value):
            raise AssertionError("non-finite {} loss {}".format(kind, value))
        if optimizer.step_count != 1:
            raise AssertionError("{} took {} steps".format(
                kind, optimizer.step_count))
        if axes["fsdp"] > 1:
            params = list(model.parameters())
            moments = [optimizer.optimizer.state[p]["exp_avg"]
                       for p in params]
            n_params, n_moments = _fsdp_sharded(params), _fsdp_sharded(
                moments)
            if not n_params == n_moments == len(params):
                raise AssertionError(
                    "fsdp > 1 but {} params and {} moments are fsdp-sharded"
                    .format(n_params, n_moments))
            out["{}_fsdp_sharded".format(kind)] = [n_params, n_moments]
        out["{}_loss".format(kind)] = value
    out["pp2_gpipe_max_err"] = _pipeline_leg(n_devices)
    if dist.get_rank() == 0:
        print("dryrun_multichip ok: world={} {}".format(
            dist.get_world_size(), out), flush=True)
    return out


def _pipeline_leg(n_devices):
    """The reference dryrun's pipeline leg: one forward of tiny BERT's
    encoder (4 rows of 32, ``n_micro`` 2) as a GPipe pipeline over a {pp:
    2, dp: pp_used // 2} mesh on the first pp_used = 2·(n // 2) ranks,
    against the unpipelined stack on the same weights. Returns the max
    |error| (below 0.1, the reference's bar); None at n = 1 and on the
    ranks outside the mesh, which still take part in making it."""
    if n_devices < 2:
        return None
    from .models import BertConfig, BertForPreTraining
    from .parallel import (make_mesh, make_pipelined_encoder,
                           reference_encoder, stack_layer_params)
    pp_used = 2 * (n_devices // 2)
    mesh = make_mesh({"pp": 2, "dp": pp_used // 2}, ranks=range(pp_used))
    if mesh.get_coordinate() is None:
        return None
    device = torch.device("cpu")
    if mesh.device_type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    cfg = BertConfig.tiny(attention_impl="dense")
    torch.manual_seed(0)
    with device:
        stacked = stack_layer_params(BertForPreTraining(cfg).state_dict(),
                                     cfg.num_layers)
        pipe = make_pipelined_encoder(mesh, cfg, n_micro=2)
        ref = reference_encoder(cfg)
    batch = _example_batch(cfg.vocab_size, batch=4, seq_len=32)
    x = torch.from_numpy(fake_hidden_states(4, 32, cfg.hidden_size,
                                            seed=0)).to(device)
    mask = torch.from_numpy(batch["attention_mask"]).to(device)
    with torch.no_grad():
        y_pipe = pipe.load_stacked(stacked)(x, mask)
        y_ref = ref.load_stacked(stacked)(x, mask)
    err = float((y_pipe.float() - y_ref.float()).abs().max())
    if not err < 0.1:
        raise AssertionError("pipeline drift vs reference: {}".format(err))
    return err


def dryrun_multichip(n_devices, device=None):
    """One sharded train step of tiny BERT and BART on a world of
    ``n_devices`` ranks, then the pipeline leg; returns rank 0's summary
    (mesh, losses, counts of fsdp-sharded parameters and moments,
    ``pp2_gpipe_max_err``)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        if dist.get_world_size() != n_devices:
            raise ValueError("the process group has {} ranks, not {}".format(
                dist.get_world_size(), n_devices))
        return _dryrun_rank(n_devices)
    from .parallel.distributed import run_world
    return run_world(n_devices, _dryrun_rank, n_devices, device=device)[0]
