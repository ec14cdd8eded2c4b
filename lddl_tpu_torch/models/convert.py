"""Parameter trees between the reference's flax layout and the port's
``state_dict``.

The port's modules carry the flax module names, so a param path maps
one to one: ``layer_0/attention/query/kernel`` <->
``layer_0.attention.query.weight``. Leaves convert by kind:

- ``nn.Dense`` ``kernel`` [in, out] <-> ``Linear.weight`` [out, in]
- ``nn.Embed`` ``embedding`` <-> ``Embedding.weight``
- ``nn.LayerNorm`` ``scale`` <-> ``weight``; ``bias`` <-> ``bias``

Flax trees are nested dicts of numpy arrays (``jax.device_get`` of the
params); state dicts hold float32 CPU tensors.

``load_flax_train_state`` carries a whole reference ``TrainState``
(params, and the optax ``chain(clip_by_global_norm, adamw)`` moments and
count) into a port model and its ``make_optimizer`` optimizer, so that a
run trained by the reference resumes in the port.
"""

import numpy as np
import torch

# Modules whose 2-D weight is an ``nn.Embed`` table (BERT's three, BART's
# shared token table and learned positions), not a Dense kernel.
_EMBEDDINGS = ("word_embeddings", "position_embeddings",
               "token_type_embeddings", "shared_embeddings", "positions")


def flax_to_state_dict(params):
    """Nested flax param dict -> ``{name: torch.Tensor}``."""
    out = {}

    def walk(tree, prefix):
        for key, value in tree.items():
            if isinstance(value, dict):
                walk(value, prefix + (key,))
                continue
            arr = np.asarray(value, dtype=np.float32)
            if key == "kernel":
                name, arr = "weight", arr.T
            elif key in ("embedding", "scale"):
                name = "weight"
            elif key == "bias":
                name = "bias"
            else:
                raise KeyError("unknown flax leaf {}".format(
                    "/".join(prefix + (key,))))
            out[".".join(prefix + (name,))] = torch.tensor(arr)

    walk(params, ())
    return out


def state_dict_to_flax(state_dict):
    """``{name: tensor}`` -> nested flax param dict of float32 numpy."""
    tree = {}
    for name, tensor in state_dict.items():
        *path, leaf = name.split(".")
        arr = tensor.detach().cpu().float().numpy()
        if leaf == "weight":
            if arr.ndim == 1:
                leaf = "scale"
            elif path[-1] in _EMBEDDINGS:
                leaf = "embedding"
            else:
                leaf, arr = "kernel", arr.T
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = np.ascontiguousarray(arr)
    return tree


def load_flax_train_state(model, optimizer, params, mu, nu, count):
    """Load a reference train state into ``model`` and ``optimizer`` (a
    ``models.train.make_optimizer``): ``params``, adam's ``mu`` and
    ``nu`` (flax trees of numpy, like the params) and ``count``, the
    updates applied so far (adam's and the schedule's count, which is
    the reference's ``TrainState.step``). Moments convert like their
    params; AdamW's ``step`` and the schedule take ``count``."""
    model.load_state_dict(flax_to_state_dict(params), strict=True)
    exp_avg, exp_avg_sq = flax_to_state_dict(mu), flax_to_state_dict(nu)
    names = {p: n for n, p in model.named_parameters()}
    for p in optimizer.params:
        name = names[p]
        optimizer.optimizer.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": exp_avg[name].to(p.device,
                                        optimizer.mu_dtype or p.dtype),
            "exp_avg_sq": exp_avg_sq[name].to(p.device, p.dtype),
        }
    optimizer.set_step_count(int(count))
