"""GPipe pipeline parallelism over the ``pp`` mesh axis.

Counterpart of ``lddl_tpu/parallel/pipeline.py`` (``stack_layer_params``,
``unstack_layer_params``, ``make_pipelined_encoder``,
``reference_encoder``). The BERT encoder's layers are split over the pp
ranks: stage s holds layers [s·L/pp, (s+1)·L/pp) and, at step t of the
``n_micro + pp - 1`` step schedule, runs them on microbatch t - s, then
hands the result to stage s + 1 around a ring (the wrap-around into stage
0 is ignored: stage 0 injects fresh microbatches). The last stage banks
the outputs and broadcasts them, so every pp rank returns the same
``y``. Embeddings and heads stay outside, replicated.

The reference differentiates its ``ppermute`` ring for free. Torch's
point-to-point ops have no autograd, so the schedule is built from three
``torch.autograd.Function``s:

- ``_Handoff``: the forward sends to stage s + 1 and receives from s - 1;
  the backward sends the received tensor's gradient back to s - 1 and
  receives from s + 1 the gradient of what was sent. Each hand-off also
  takes the previous hand-off's output (the first takes the entered
  input) as an input whose gradient is zero. That chains all hand-offs
  of a rank into one path of its autograd graph, so every rank's
  backward runs every hand-off, bubble steps included, in reverse step
  order: the same p2p sequence on every rank.
- ``_Epilogue``: the last stage's banked outputs broadcast over pp. Its
  backward gives the last stage its own cotangent, unscaled, and the
  others none: under the reference's ``shard_map`` the transpose of the
  mask-and-psum hands the replicated loss's cotangent to the last stage
  once, where an all-reduce's backward would sum it pp times.
- ``_Enter``: ``x`` as it enters; its backward sums the gradient over
  pp, the transpose of a replicated input, so every rank returns stage
  0's ``gx``.

Bubble steps skip the layers (the reference computes them and discards
the result) but keep the hand-off. At pp = 1 nothing communicates: the
hand-offs are the identity. The layers run deterministic (no dropout),
as the reference passes ``deterministic=True``; carries are in
``cfg.dtype``.
"""

import torch
from torch import nn

from .mesh import AXIS_PP, axis_rank, axis_size

_LAYER = "layer_{}"


def stack_layer_params(params, num_layers):
    """A state dict's ``layer_<i>.<rest>`` tensors, i < ``num_layers`` ->
    ``{<rest>: tensor [num_layers, ...]}`` (the pp-splittable layout;
    ``BertForPreTraining.state_dict()`` names its layers so)."""
    prefix = _LAYER.format(0) + "."
    rests = [k[len(prefix):] for k in params if k.startswith(prefix)]
    return {rest: torch.stack([params["{}.{}".format(_LAYER.format(i),
                                                     rest)]
                               for i in range(num_layers)])
            for rest in rests}


def unstack_layer_params(stacked, num_layers):
    """The inverse: ``{<rest>: [num_layers, ...]}`` ->
    ``{layer_<i>.<rest>: tensor}``."""
    return {"{}.{}".format(_LAYER.format(i), rest): t[i]
            for i in range(num_layers) for rest, t in stacked.items()}


class LayerStack(nn.Module):
    """``EncoderLayer``s ``layer_<i>`` for i in ``layers`` (global indices,
    so the state dict names match ``BertForPreTraining``'s), run in order
    and always deterministic: ``train()`` leaves them in eval mode."""

    def __init__(self, cfg, layers):
        super().__init__()
        from ..models.bert import EncoderLayer
        self.cfg = cfg
        self.layers = list(layers)
        for i in self.layers:
            setattr(self, _LAYER.format(i), EncoderLayer(cfg))
        self.train(False)

    def train(self, mode=True):
        return super().train(False)

    def load_stacked(self, stacked):
        """Copy this module's layers out of a stacked tree of all layers
        (``stack_layer_params``). Returns the module."""
        own = self.state_dict()
        with torch.no_grad():
            for name, t in own.items():
                layer, rest = name.split(".", 1)
                t.copy_(stacked[rest][int(layer[len("layer_"):])])
        return self

    def forward(self, x, mask):
        """[B, T, H] -> [B, T, H] in ``cfg.dtype``."""
        x = x.to(self.cfg.dtype)
        for i in self.layers:
            x = getattr(self, _LAYER.format(i))(x, mask).to(self.cfg.dtype)
        return x


def _zero_like(link):
    """The zero gradient of a link input, defined (so every hand-off's
    backward receives a gradient, whatever the engine does with undefined
    ones) and allocation-free (a stride-0 view of one zero)."""
    return link.new_zeros(()).expand(link.shape)


class _Enter(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, anchor, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist
        grad = grad.contiguous()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None, None


class _Handoff(torch.autograd.Function):

    @staticmethod
    def forward(ctx, out, link, group):
        from .distributed import rotate
        ctx.group = group
        ctx.link_grad = _zero_like(link)
        return rotate([out], group, 1)[0]

    @staticmethod
    def backward(ctx, grad):
        from .distributed import rotate
        sent = rotate([grad], ctx.group, -1)[0]
        return (sent if ctx.needs_input_grad[0] else None, ctx.link_grad,
                None)


class _Epilogue(torch.autograd.Function):

    @staticmethod
    def forward(ctx, banked, link, group, src):
        import torch.distributed as dist
        ctx.link_grad = _zero_like(link)
        out = banked.clone()
        dist.broadcast(out, src=src, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return (grad if ctx.needs_input_grad[0] else None, ctx.link_grad,
                None, None)


class PipelinedEncoder(LayerStack):
    """This pp rank's stage of the encoder stack under the GPipe schedule
    (see the module docstring). ``forward(x, mask)``: ``x`` [B, T, H] and
    ``mask`` [B, T], the same on every pp rank, B divisible by
    ``n_micro``; returns ``y`` [B, T, H] in ``cfg.dtype`` on every pp
    rank. Every pp rank must call it, and run the backward of its
    result, alike."""

    def __init__(self, cfg, pp, stage, n_micro, group):
        per = cfg.num_layers // pp
        super().__init__(cfg, range(stage * per, (stage + 1) * per))
        self.pp, self.stage, self.n_micro = pp, stage, n_micro
        self.group = group
        if pp > 1:
            import torch.distributed as dist
            self.last = dist.get_global_rank(group, pp - 1)

    def forward(self, x, mask):
        pp, stage, n_micro = self.pp, self.stage, self.n_micro
        b = x.shape[0]
        if b % n_micro:
            raise ValueError("batch {} not divisible by n_micro {}".format(
                b, n_micro))
        if pp > 1:
            anchor = None
            if torch.is_grad_enabled():
                anchor = torch.empty(0, device=x.device, requires_grad=True)
            x = _Enter.apply(x, anchor, self.group)
        micro = x.reshape(n_micro, b // n_micro, *x.shape[1:])
        micro_mask = mask.reshape(n_micro, b // n_micro, *mask.shape[1:])
        link = x
        carry = None
        banked = []
        for t in range(n_micro + pp - 1):
            m = t - stage
            if 0 <= m < n_micro:
                inp = micro[t] if stage == 0 else carry
                out = super().forward(inp, micro_mask[m])
            else:
                out = micro.new_zeros(micro.shape[1:], dtype=self.cfg.dtype)
            if stage == pp - 1 and t >= pp - 1:
                banked.append(out)
            if pp > 1:
                carry = link = _Handoff.apply(out, link, self.group)
            else:
                carry = out
        if pp == 1:
            return torch.cat(banked)
        # Only the last stage banked; the others receive its outputs.
        y = (torch.cat(banked) if banked
             else x.new_zeros(x.shape, dtype=self.cfg.dtype))
        return _Epilogue.apply(y, link, self.group, self.last)


def make_pipelined_encoder(mesh, cfg, n_micro):
    """This rank's stage of the encoder stack as a pp-split GPipe
    pipeline over ``mesh``'s pp axis (size 1 when absent): a
    ``PipelinedEncoder`` holding only layers [s·L/pp, (s+1)·L/pp) of
    stage s, freshly initialised; ``load_stacked(stacked)`` copies them
    out of ``stack_layer_params``' tree. ``n_micro >= pp`` keeps every
    stage busy in steady state."""
    pp = axis_size(mesh, AXIS_PP)
    if cfg.num_layers % pp:
        raise ValueError("num_layers {} not divisible by pp {}".format(
            cfg.num_layers, pp))
    group = mesh[AXIS_PP].get_group() if pp > 1 else None
    return PipelinedEncoder(cfg, pp, axis_rank(mesh, AXIS_PP), n_micro,
                            group)


def reference_encoder(cfg):
    """The same stack, unpipelined (for equivalence tests): all
    ``cfg.num_layers`` layers in one ``LayerStack``, loaded by
    ``load_stacked`` from the same tree."""
    return LayerStack(cfg, range(cfg.num_layers))
