"""Pretraining step: loss, clipped AdamW under a warmup-cosine schedule,
the gathered MLM head, the batch-loss adapter, on one device or sharded
over a mesh.

Counterpart of ``lddl_tpu/models/train.py`` (``pretrain_loss``,
``bert_batch_loss``, ``make_optimizer``, ``mlm_gather_cap``,
``_mlm_gather_prologue``, ``_mlm_gather_of``, ``_batch_inputs``,
``_make_step_fn``, ``create_train_state``, ``make_sharded_train_step``,
``make_sharded_multi_step``, ``make_eval_step``). Dropout is a function
of (seed, optimizer step) alone, as in the reference, so a run restored
from a checkpoint continues bit for bit like the uninterrupted one; on a
mesh the seed also folds in the rank's data and sp coordinates (never tp:
tp peers hold replicated activations and must draw the same masks).

On a mesh (``create_train_state`` + the sharded steps) each rank runs its
local rows: the loss's denominators are the global batch's (all-reduced
over the data axes), each rank's loss is its share of the global loss,
gradients are summed (``models.sharding``), and the clip takes the norm
of the unsharded gradients, so one step equals the unsharded step on the
global batch. The optimizer keeps optax's semantics:
global-norm clipping (``optax.clip_by_global_norm``), then AdamW (eps
outside the sqrt, weight decay on every parameter) at the learning rate
``warmup_cosine_decay_schedule(count)``, where the first update uses
count 0, whose rate is 0.
"""

import math
import warnings

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from ..parallel.mesh import (AXIS_SP, axis_rank, axis_size, data_index,
                             set_mesh)
from ..utils.rng import dropout_seed
from .sharding import (data_sum, reduce_replicated_grads,
                       replication_counts, reshard, shard_model,
                       token_cross_entropy)


def pretrain_loss(mlm_logits, nsp_logits, labels, next_sentence_labels,
                  ignore_index=-1):
    """Masked-LM cross entropy (mean over masked positions) + NSP cross
    entropy. Returns (loss, metrics).

    Under a mesh with data axes (the sharded steps) the batch is this
    rank's rows: the denominators are the global batch's counts, the
    returned loss is this rank's share of the global loss (the shares sum
    to it) and the metrics are the global batch's."""
    mask = labels != ignore_index
    safe_labels = torch.where(mask, labels, 0).long()
    mlm_ll, mlm_pred = token_cross_entropy(mlm_logits, safe_labels)
    nsp_mask = next_sentence_labels != ignore_index
    nsp_safe = torch.where(nsp_mask, next_sentence_labels, 0).long()
    nsp_ll = F.cross_entropy(
        nsp_logits.float().reshape(-1, nsp_logits.shape[-1]),
        nsp_safe.reshape(-1), reduction="none").reshape(nsp_safe.shape)
    denom, nsp_denom = (c.clamp_min(1) for c in data_sum(mask.sum(),
                                                         nsp_mask.sum()))
    mlm_loss = torch.where(mask, mlm_ll, 0.0).sum() / denom
    nsp_loss = torch.where(nsp_mask, nsp_ll, 0.0).sum() / nsp_denom
    loss = mlm_loss + nsp_loss
    mlm_correct, nsp_correct = data_sum(
        (mask & (mlm_pred == safe_labels)).sum(),
        (nsp_mask & (nsp_logits.argmax(dim=-1) == nsp_safe)).sum())
    total, mlm_total, nsp_total = data_sum(loss, mlm_loss, nsp_loss)
    metrics = {
        "loss": total,
        "mlm_loss": mlm_total,
        "nsp_loss": nsp_total,
        "mlm_accuracy": mlm_correct / denom,
        "nsp_accuracy": nsp_correct / nsp_denom,
    }
    return loss, metrics


def bert_batch_loss(outputs, batch, ignore_index=-1):
    """Default loss adapter: BertForPreTraining outputs -> pretrain_loss."""
    mlm_logits, nsp_logits = outputs
    return pretrain_loss(mlm_logits, nsp_logits, batch["labels"],
                         batch["next_sentence_labels"],
                         ignore_index=ignore_index)


def warmup_cosine_decay_schedule(count, peak_value, warmup_steps,
                                 decay_steps, init_value=0.0, end_value=0.0):
    """optax.warmup_cosine_decay_schedule at step ``count``: linear from
    ``init_value`` to ``peak_value`` over ``warmup_steps``, then cosine
    decay to ``end_value`` until ``decay_steps``."""
    if warmup_steps > 0 and count < warmup_steps:
        return init_value + (peak_value - init_value) * count / warmup_steps
    span = decay_steps - warmup_steps
    if span <= 0:
        return peak_value
    t = min(count - warmup_steps, span)
    cosine = 0.5 * (1.0 + math.cos(math.pi * t / span))
    alpha = end_value / peak_value if peak_value else 0.0
    return peak_value * ((1.0 - alpha) * cosine + alpha)


def _param_groups(params):
    """``params`` split into AdamW parameter groups whose tensors its
    multi-tensor (foreach) kernels can take together: the plain tensors,
    and the ``DTensor``s of each mesh (a tp plan without fsdp leaves both
    kinds in one model, and one foreach op refuses a mix)."""
    groups = {}
    for p in params:
        key = p.device_mesh if isinstance(p, DTensor) else None
        groups.setdefault(key, []).append(p)
    return [{"params": group} for group in groups.values()]


class LowMuAdamW(torch.optim.Optimizer):
    """AdamW whose first moment is stored in ``mu_dtype`` (bf16 halves its
    bytes at rest), in optax's order (``scale_by_adam(mu_dtype=)``, then
    ``add_decayed_weights`` and the learning rate): the update uses the
    fp32 moment computed from the stored one, b1 times it rounded to
    ``mu_dtype`` first, as JAX's product of a Python float and a bf16
    array is, and only what is stored is cast. torch's foreach AdamW
    refuses state of another dtype than its parameter's, so this is the
    port's own foreach update. The state keeps AdamW's keys (``step``,
    ``exp_avg``, ``exp_avg_sq``); a moment that ``load_state_dict`` cast
    to its parameter's dtype is cast back, losslessly, at the next step."""

    def __init__(self, params, lr, betas, eps, weight_decay, mu_dtype):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay))
        self.mu_dtype = mu_dtype

    def _state(self, p):
        state = self.state[p]
        if not state:
            state["step"] = torch.zeros((), dtype=torch.float32)
            state["exp_avg"] = torch.zeros_like(
                p, dtype=self.mu_dtype, memory_format=torch.preserve_format)
            state["exp_avg_sq"] = torch.zeros_like(
                p, memory_format=torch.preserve_format)
        elif state["exp_avg"].dtype != self.mu_dtype:
            state["exp_avg"] = state["exp_avg"].to(self.mu_dtype)
        state["step"] += 1
        return state

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            b1, b2 = group["betas"]
            states = [self._state(p) for p in params]
            grads = [p.grad for p in params]
            b1_mu = float(torch.tensor(b1, dtype=self.mu_dtype))
            mu = [t.float() for t in torch._foreach_mul(
                [s["exp_avg"] for s in states], b1_mu)]
            m = torch._foreach_mul(grads, 1.0 - b1)
            torch._foreach_add_(m, mu)
            v = torch._foreach_mul(torch._foreach_mul(grads, grads), 1.0 - b2)
            torch._foreach_add_(v, torch._foreach_mul(
                [s["exp_avg_sq"] for s in states], b2))
            counts = [int(s["step"]) for s in states]
            one = torch.tensor(1.0)
            bc1 = [float(one - torch.tensor(b1) ** c) for c in counts]
            bc2 = [float(one - torch.tensor(b2) ** c) for c in counts]
            den = torch._foreach_div(v, bc2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, group["eps"])
            upd = torch._foreach_div(m, bc1)
            torch._foreach_div_(upd, den)
            torch._foreach_add_(upd, torch._foreach_mul(
                params, group["weight_decay"]))
            torch._foreach_mul_(upd, -group["lr"])
            torch._foreach_add_(params, upd)
            for s, m_i, v_i in zip(states, m, v):
                s["exp_avg"].copy_(m_i)
                s["exp_avg_sq"].copy_(v_i)


class ClippedAdamW:
    """Global-norm clipping, then ``torch.optim.AdamW`` under a
    ``LambdaLR`` stepped after every update — optax's
    ``chain(clip_by_global_norm, adamw(schedule))``. AdamW takes its
    multi-tensor path on every device, the one it takes by default on
    CUDA, so a run on the CPU goes through the same code."""

    def __init__(self, params, learning_rate, weight_decay, warmup_steps,
                 total_steps, b1, b2, clip_norm, mu_dtype=None):
        self.params = [p for p in params if p.requires_grad]
        self.clip_norm = clip_norm
        self.mu_dtype = mu_dtype
        decay_steps = max(total_steps, warmup_steps + 1)
        if mu_dtype is None:
            self.optimizer = torch.optim.AdamW(
                _param_groups(self.params), lr=learning_rate,
                betas=(b1, b2), eps=1e-8, weight_decay=weight_decay,
                foreach=True)
        else:
            self.optimizer = LowMuAdamW(
                _param_groups(self.params), lr=learning_rate,
                betas=(b1, b2), eps=1e-8, weight_decay=weight_decay,
                mu_dtype=mu_dtype)

        def factor(count):
            if learning_rate == 0:
                return 0.0
            return warmup_cosine_decay_schedule(
                count, learning_rate, warmup_steps,
                decay_steps) / learning_rate

        self.scheduler = torch.optim.lr_scheduler.LambdaLR(self.optimizer,
                                                           factor)

    def zero_grad(self):
        self.optimizer.zero_grad(set_to_none=True)

    def clip_grads(self):
        """optax.clip_by_global_norm: g / norm * clip_norm when the global
        norm is at least clip_norm. Returns the norm (a device tensor).

        Sharded gradients (``DTensor``s) give the norm of the unsharded
        ones: each rank's squares, each tensor counted once over the
        ranks that hold the same values, summed over the world, so every
        rank clips alike."""
        grads = [p.grad for p in self.params if p.grad is not None]
        if any(isinstance(g, DTensor) for g in grads):
            return self._clip_sharded(grads)
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        self._scale(grads, norm)
        return norm

    def _clip_sharded(self, grads):
        import torch.distributed as dist
        counts = replication_counts(grads)
        grads = [g.to_local() if isinstance(g, DTensor) else g
                 for g in grads]
        norms = torch._foreach_norm(grads)
        if any(c != 1 for c in counts):
            norms = torch._foreach_div(norms, [math.sqrt(c) for c in counts])
        norm = torch.linalg.vector_norm(torch.stack(norms))
        if dist.get_world_size() > 1:
            square = norm.square()
            dist.all_reduce(square)
            norm = square.sqrt()
        self._scale(grads, norm)
        return norm

    def _scale(self, grads, norm):
        keep = norm < self.clip_norm
        torch._foreach_div_(grads, torch.where(keep, 1.0, norm))
        torch._foreach_mul_(grads, torch.where(keep, 1.0, self.clip_norm)
                            .to(norm.dtype))

    def step(self):
        norm = self.clip_grads()
        self.optimizer.step()
        self.scheduler.step()
        return norm

    def get_last_lr(self):
        return self.scheduler.get_last_lr()[0]

    @property
    def step_count(self):
        """Updates applied so far (the schedule's count)."""
        return self.scheduler.last_epoch

    def set_step_count(self, count):
        """Put the schedule where it stands after ``count`` updates (a
        restore); the learning rate is computed as the scheduler does."""
        sched = self.scheduler
        sched.last_epoch = int(count)
        lrs = [base * f(sched.last_epoch)
               for base, f in zip(sched.base_lrs, sched.lr_lambdas)]
        for group, lr in zip(self.optimizer.param_groups, lrs):
            group["lr"] = lr
        sched._last_lr = lrs


def make_optimizer(params, learning_rate=1e-4, weight_decay=0.01,
                   warmup_steps=100, total_steps=10000, b1=0.9, b2=0.999,
                   clip_norm=1.0, mu_dtype=None):
    """AdamW with warmup-cosine schedule and global-norm clipping.

    ``mu_dtype`` (e.g. ``torch.bfloat16``) stores the first Adam moment in
    that dtype (``LowMuAdamW``), a memory option; None keeps torch's
    foreach AdamW with fp32 moments. The second moment stays fp32."""
    return ClippedAdamW(params, learning_rate, weight_decay, warmup_steps,
                        total_steps, b1, b2, clip_norm, mu_dtype)


def mlm_gather_cap(seq_len, n_samples_per_row=1):
    """Static cap P on masked positions per row for the gathered MLM head:
    the 15% masking budget plus a 4-sigma binomial margin, rounded up to a
    multiple of 8. Rows above P drop the excess labels, counted in the
    step metrics as ``mlm_dropped_labels``."""
    l_eff = seq_len / max(n_samples_per_row, 1)
    per_sample = 0.15 * l_eff + 1.43 * math.sqrt(l_eff)
    p = int(math.ceil(per_sample)) * max(n_samples_per_row, 1)
    return min(seq_len, -(-p // 8) * 8)


def _mlm_gather_of(batch, ignore_index=-1):
    """(masked_positions [B, P], gathered labels [B, P], dropped count),
    or None when the cap would not shrink the head. Packed rows
    (``cls_positions`` [B, n_per_row] in the batch) cap at
    ``mlm_gather_cap(L, n_per_row)``. Positions are the first P masked
    columns per row in ascending order; rows with fewer than P pad with
    unmasked columns, whose labels are ``ignore_index``."""
    labels = batch["labels"]
    seq_len = labels.shape[-1]
    n_per_row = 1
    if "cls_positions" in batch:
        n_per_row = batch["cls_positions"].shape[-1]
    p = mlm_gather_cap(seq_len, n_per_row)
    if p >= seq_len:
        return None
    mask = labels != ignore_index
    cols = torch.arange(seq_len, device=labels.device)
    score = torch.where(mask, seq_len - cols[None, :], 0)
    pos = torch.sort(score, dim=1, descending=True, stable=True).indices[:, :p]
    gathered = torch.gather(labels, 1, pos)
    dropped = mask.sum() - (gathered != ignore_index).sum()
    return pos, gathered, dropped


def _mlm_gather_prologue(model, batch, ignore_index, enabled):
    """(model kwargs, batch, extra metrics) of the train and eval steps:
    when ``enabled`` (the default loss), the model's config asks for the
    gathered head (``cfg.mlm_gather``) and the cap shrinks it, the batch's
    labels become the gathered [B, P] labels and the dropped-label count
    is reported; else ({}, batch, {})."""
    cfg = getattr(model, "cfg", None)
    gather = None
    if enabled and getattr(cfg, "mlm_gather", False) and "labels" in batch:
        gather = _mlm_gather_of(batch, ignore_index)
    if gather is None:
        return {}, batch, {}
    pos, gathered_labels, dropped = gather
    return ({"masked_positions": pos}, dict(batch, labels=gathered_labels),
            {"mlm_dropped_labels": dropped})


def _resolve_batch_loss(batch_loss, ignore_index):
    """(batch_loss, gather_ok): the default BERT loss (and with it the
    gathered MLM head, which rewrites the labels under BERT's
    conventions) unless the caller brings a loss of their own."""
    if batch_loss is not None and ignore_index != -1:
        raise ValueError(
            "ignore_index only configures the default BERT loss; bind it "
            "into your batch_loss instead")
    if batch_loss is not None:
        return batch_loss, False

    def default_loss(outputs, batch):
        return bert_batch_loss(outputs, batch, ignore_index)

    return default_loss, True


def _mesh_totals(extra):
    """The prologue's counts summed over the data axes."""
    return dict(zip(extra, data_sum(*extra.values()))) if extra else extra


def _make_step(model, optimizer, ignore_index, batch_loss, mesh):
    batch_loss, gather_ok = _resolve_batch_loss(batch_loss, ignore_index)
    device = next(model.parameters()).device
    rng_devices = [device] if device.type == "cuda" else []
    sp = axis_size(mesh, AXIS_SP)
    # The dropout stream: the rank's data block and sp chunk (0 on one
    # device), never its tp coordinate.
    stream = 0 if mesh is None else (data_index(mesh) * sp
                                     + axis_rank(mesh, AXIS_SP))

    def step(batch, seed=0):
        model.train()
        with set_mesh(mesh):
            kwargs, batch, extra = _mlm_gather_prologue(
                model, batch, ignore_index, gather_ok)
            with torch.random.fork_rng(devices=rng_devices,
                                       device_type=device.type):
                torch.manual_seed(dropout_seed(seed, optimizer.step_count,
                                               stream))
                outputs = model(*(batch[k] for k in model.BATCH_INPUTS),
                                **kwargs)
                loss, metrics = batch_loss(outputs, batch)
                optimizer.zero_grad()
                # Every sp rank computes the whole loss of its rows after
                # the heads' gather; the sum over sp counts it once.
                (loss / sp if sp > 1 else loss).backward()
            extra = _mesh_totals(extra)
        if mesh is not None:
            reduce_replicated_grads(model, mesh)
        optimizer.step()
        metrics.update(extra)
        return {k: v.detach() for k, v in metrics.items()}

    return step


def make_train_step(model, optimizer, ignore_index=-1, batch_loss=None):
    """A train step: ``step(batch, seed=0)`` on a batch of tensors on the
    model's device -> metrics (device tensors; reading them syncs the
    device). Runs the model in train mode on the batch keys its
    ``BATCH_INPUTS`` names, then clip + AdamW + schedule.

    Dropout draws its masks under ``torch.manual_seed(dropout_seed(seed,
    n))``, n the optimizer's update count, in a forked RNG state: the
    masks depend on (seed, n) alone, and the global generators are left
    as they were.

    ``batch_loss(outputs, batch)`` -> (loss, metrics) adapts the model's
    outputs (e.g. ``bart.bart_batch_loss``); bind its ignore_index
    yourself. The default is BERT's loss with the gathered MLM head
    (``cfg.mlm_gather``), on only for the default loss."""
    return _make_step(model, optimizer, ignore_index, batch_loss, None)


def make_sharded_train_step(mesh, model, optimizer, ignore_index=-1,
                            batch_loss=None):
    """``make_train_step`` over ``mesh`` for a model and optimizer from
    ``create_train_state``: ``step(batch, seed=0)`` -> the global batch's
    metrics on every rank. ``batch`` is this rank's rows (tensors on its
    device, ``loader.to_device_batch``), the same on tp and sp peers.
    Each rank's dropout seed folds in its data and sp coordinates. A
    custom ``batch_loss`` returns this rank's share of the
    global loss (``pretrain_loss`` and ``bart_batch_loss`` do)."""
    return _make_step(model, optimizer, ignore_index, batch_loss, mesh)


def _make_multi(step, n_steps):
    def multi(batches, seed=0):
        per_step = [step({k: v[i] for k, v in batches.items()}, seed)
                    for i in range(n_steps)]
        return {k: torch.stack([m[k] for m in per_step])
                for k in per_step[0]}

    return multi


def make_multi_step(model, optimizer, n_steps, ignore_index=-1,
                    batch_loss=None):
    """``n_steps`` train steps in one call, the counterpart of the
    reference's ``make_sharded_multi_step``: ``multi(batches, seed=0)``
    takes batch tensors with a leading ``[n_steps]`` axis, runs one train
    step per slice and returns the metrics stacked over the steps.
    Dropout still varies per step: each step folds the seed with its own
    update count."""
    return _make_multi(make_train_step(model, optimizer, ignore_index,
                                       batch_loss), n_steps)


def make_sharded_multi_step(mesh, model, optimizer, n_steps, ignore_index=-1,
                            batch_loss=None):
    """``make_multi_step`` over ``mesh``: ``multi(batches, seed=0)`` on
    this rank's stacked rows (``loader.to_device_step_batches``)."""
    return _make_multi(make_sharded_train_step(mesh, model, optimizer,
                                               ignore_index, batch_loss),
                       n_steps)


def make_eval_step(model, ignore_index=-1, batch_loss=None, mesh=None):
    """A forward-only step: ``eval_step(batch)`` -> metrics, with the
    model in eval mode (no dropout) under ``torch.no_grad`` and the train
    step's gather prologue. With ``mesh`` (a model from
    ``create_train_state``) the batch is this rank's rows and the metrics
    the global batch's. The first step that drops masked labels past
    the gather's cap raises a ``RuntimeWarning``: eval numbers are read
    as exact, and ``cfg.mlm_gather=False`` gives them so."""
    batch_loss, gather_ok = _resolve_batch_loss(batch_loss, ignore_index)
    warned = [False]

    def eval_step(batch):
        was_training = model.training
        model.eval()
        try:
            with set_mesh(mesh):
                kwargs, batch, extra = _mlm_gather_prologue(
                    model, batch, ignore_index, gather_ok)
                with torch.no_grad():
                    outputs = model(*(batch[k] for k in model.BATCH_INPUTS),
                                    **kwargs)
                    _, metrics = batch_loss(outputs, batch)
                extra = _mesh_totals(extra)
        finally:
            model.train(was_training)
            if mesh is not None:
                reshard(model)
        metrics.update(extra)
        if not warned[0] and "mlm_dropped_labels" in metrics:
            if int(metrics["mlm_dropped_labels"]) > 0:
                warned[0] = True
                warnings.warn(
                    "mlm_gather dropped masked labels in an eval step: the "
                    "reported loss excludes them. Labels exceeded the "
                    "4-sigma cap (mlm_gather_cap); evaluate with "
                    "config.mlm_gather=False for exact loss.",
                    RuntimeWarning, stacklevel=2)
        return metrics

    return eval_step


def create_train_state(config, mesh, seed=0, optimizer=None, model=None,
                       params=None):
    """A model and optimizer sharded over ``mesh`` (``models.sharding``'s
    plan): returns (model, optimizer).

    The model is ``model`` or ``BertForPreTraining(config)`` built on the
    rank's device under ``torch.manual_seed(seed)`` (the same weights on
    every rank), then loaded from ``params`` (a state dict, e.g.
    ``convert.flax_to_state_dict`` of a reference param tree) when given,
    and sharded. ``optimizer(params)`` builds the optimizer
    (``make_optimizer`` by default); AdamW's moments take their
    parameters' placements."""
    from .bert import BertForPreTraining
    device = torch.device(mesh.device_type)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    if model is None:
        with torch.random.fork_rng(
                devices=[device] if device.type == "cuda" else [],
                device_type=device.type):
            torch.manual_seed(seed)
            with device:
                model = BertForPreTraining(config)
    if params is not None:
        model.load_state_dict(params)
    shard_model(model.to(device), mesh)
    return model, (optimizer or make_optimizer)(model.parameters())
