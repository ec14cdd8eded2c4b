"""Pretraining step: loss, clipped AdamW under a warmup-cosine schedule,
the gathered MLM head, the batch-loss adapter.

Counterpart of ``lddl_tpu/models/train.py`` (``pretrain_loss``,
``bert_batch_loss``, ``make_optimizer``, ``mlm_gather_cap``,
``_mlm_gather_of``, ``_batch_inputs``, ``_make_step_fn``) on one
device. The optimizer keeps optax's semantics:
global-norm clipping (``optax.clip_by_global_norm``), then AdamW (eps
outside the sqrt, weight decay on every parameter) at the learning rate
``warmup_cosine_decay_schedule(count)``, where the first update uses
count 0, whose rate is 0.
"""

import math

import torch
import torch.nn.functional as F


def pretrain_loss(mlm_logits, nsp_logits, labels, next_sentence_labels,
                  ignore_index=-1):
    """Masked-LM cross entropy (mean over masked positions) + NSP cross
    entropy. Returns (loss, metrics)."""
    mask = labels != ignore_index
    safe_labels = torch.where(mask, labels, 0).long()
    mlm_ll = F.cross_entropy(
        mlm_logits.float().reshape(-1, mlm_logits.shape[-1]),
        safe_labels.reshape(-1), reduction="none").reshape(labels.shape)
    denom = mask.sum().clamp_min(1)
    mlm_loss = torch.where(mask, mlm_ll, 0.0).sum() / denom
    nsp_mask = next_sentence_labels != ignore_index
    nsp_safe = torch.where(nsp_mask, next_sentence_labels, 0).long()
    nsp_ll = F.cross_entropy(
        nsp_logits.float().reshape(-1, nsp_logits.shape[-1]),
        nsp_safe.reshape(-1), reduction="none").reshape(nsp_safe.shape)
    nsp_denom = nsp_mask.sum().clamp_min(1)
    nsp_loss = torch.where(nsp_mask, nsp_ll, 0.0).sum() / nsp_denom
    loss = mlm_loss + nsp_loss
    mlm_correct = mask & (mlm_logits.argmax(dim=-1) == safe_labels)
    nsp_correct = nsp_mask & (nsp_logits.argmax(dim=-1) == nsp_safe)
    metrics = {
        "loss": loss,
        "mlm_loss": mlm_loss,
        "nsp_loss": nsp_loss,
        "mlm_accuracy": mlm_correct.sum() / denom,
        "nsp_accuracy": nsp_correct.sum() / nsp_denom,
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


class ClippedAdamW:
    """Global-norm clipping, then ``torch.optim.AdamW`` under a
    ``LambdaLR`` stepped after every update — optax's
    ``chain(clip_by_global_norm, adamw(schedule))``."""

    def __init__(self, params, learning_rate, weight_decay, warmup_steps,
                 total_steps, b1, b2, clip_norm):
        self.params = [p for p in params if p.requires_grad]
        self.clip_norm = clip_norm
        decay_steps = max(total_steps, warmup_steps + 1)
        self.optimizer = torch.optim.AdamW(
            self.params, lr=learning_rate, betas=(b1, b2), eps=1e-8,
            weight_decay=weight_decay)

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
        norm is at least clip_norm. Returns the norm (a device tensor)."""
        grads = [p.grad for p in self.params if p.grad is not None]
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        keep = norm < self.clip_norm
        torch._foreach_div_(grads, torch.where(keep, 1.0, norm))
        torch._foreach_mul_(grads, torch.where(keep, 1.0, self.clip_norm)
                            .to(norm.dtype))
        return norm

    def step(self):
        norm = self.clip_grads()
        self.optimizer.step()
        self.scheduler.step()
        return norm

    def get_last_lr(self):
        return self.scheduler.get_last_lr()[0]


def make_optimizer(params, learning_rate=1e-4, weight_decay=0.01,
                   warmup_steps=100, total_steps=10000, b1=0.9, b2=0.999,
                   clip_norm=1.0):
    """AdamW with warmup-cosine schedule and global-norm clipping."""
    return ClippedAdamW(params, learning_rate, weight_decay, warmup_steps,
                        total_steps, b1, b2, clip_norm)


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
    or None when the cap would not shrink the head. Positions
    are the first P masked columns per row in ascending order; rows with
    fewer than P pad with unmasked columns, whose labels are
    ``ignore_index``."""
    labels = batch["labels"]
    seq_len = labels.shape[-1]
    p = mlm_gather_cap(seq_len)
    if p >= seq_len:
        return None
    mask = labels != ignore_index
    cols = torch.arange(seq_len, device=labels.device)
    score = torch.where(mask, seq_len - cols[None, :], 0)
    pos = torch.sort(score, dim=1, descending=True, stable=True).indices[:, :p]
    gathered = torch.gather(labels, 1, pos)
    dropped = mask.sum() - (gathered != ignore_index).sum()
    return pos, gathered, dropped


def make_train_step(model, optimizer, ignore_index=-1, batch_loss=None):
    """A train step: (batch of tensors on the model's device) -> metrics
    (device tensors; reading them syncs the device). Runs the model in
    train mode (dropout on) on the batch keys its ``BATCH_INPUTS`` names,
    then clip + AdamW + schedule.

    ``batch_loss(outputs, batch)`` -> (loss, metrics) adapts the model's
    outputs (e.g. ``bart.bart_batch_loss``); bind its ignore_index
    yourself. The default is BERT's loss with the gathered MLM head, which
    rewrites the batch's labels under BERT's conventions and so is on only
    for the default loss."""
    if batch_loss is not None and ignore_index != -1:
        raise ValueError(
            "ignore_index only configures the default BERT loss; bind it "
            "into your batch_loss instead")
    gather_ok = batch_loss is None
    if batch_loss is None:
        def batch_loss(outputs, batch):
            return bert_batch_loss(outputs, batch, ignore_index)

    def step(batch):
        model.train()
        kwargs, extra = {}, {}
        gather = _mlm_gather_of(batch, ignore_index) if gather_ok else None
        if gather is not None:
            pos, gathered_labels, dropped = gather
            kwargs = {"masked_positions": pos}
            batch = dict(batch, labels=gathered_labels)
            extra = {"mlm_dropped_labels": dropped}
        outputs = model(*(batch[k] for k in model.BATCH_INPUTS), **kwargs)
        loss, metrics = batch_loss(outputs, batch)
        optimizer.zero_grad()
        loss.backward()
        optimizer.step()
        metrics.update(extra)
        return {k: v.detach() for k, v in metrics.items()}

    return step
