"""Weight bridge between the JAX package's parameter pytree and the port.

``load_jax_params(model, tree)`` fills a ``MonoSDF`` from the pytree of
``monosdf_tpu.models.init_monosdf`` or a checkpoint's ``params``, given as
nested dicts of numpy arrays: ``tree["implicit"]["lin0"]["g"]`` goes to
``model.implicit.lin0.g``. Arrays keep their layout (weights (in, out)).

``save_params_npz`` writes such a tree to one ``.npz`` (keys joined with
``/``; numpy only, so a JAX environment can write it), and
``load_params_npz`` reads it back for ``cli/eval.py --params``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def flatten_tree(tree: dict, prefix: str = "") -> dict:
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            flat.update(flatten_tree(v, key + "/"))
        else:
            flat[key] = np.asarray(v)
    return flat


def unflatten_tree(flat: dict) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


@torch.no_grad()
def load_jax_params(model: nn.Module, tree: dict) -> nn.Module:
    """Copy every array of ``tree`` into the parameter of the same path.
    An array of the parameter's size but another shape is reshaped (the
    hash table as (T, C) or, with ``param_flat``, (T*C,), the same
    row-major values: monosdf_tpu/train/checkpoint.py restore_state). Raises
    on a missing or extra key and on a size mismatch."""
    flat = {k.replace("/", "."): v for k, v in flatten_tree(tree).items()}
    named = dict(model.named_parameters())
    missing, extra = set(named) - set(flat), set(flat) - set(named)
    if missing or extra:
        raise KeyError(f"parameter trees differ: missing {sorted(missing)}, extra {sorted(extra)}")
    for name, p in named.items():
        src = torch.from_numpy(np.array(flat[name], dtype=np.float32))
        if tuple(src.shape) != tuple(p.shape) and src.numel() == p.numel():
            src = src.reshape(p.shape)
        if tuple(src.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {tuple(src.shape)}, model has {tuple(p.shape)}")
        p.copy_(src.to(p.device))
    return model


def params_to_tree(model: nn.Module) -> dict:
    """The model's parameters as a nested dict of numpy arrays."""
    return unflatten_tree({
        name.replace(".", "/"): p.detach().cpu().numpy() for name, p in model.named_parameters()
    })


def save_params_npz(path, tree: dict):
    np.savez(path, **flatten_tree(tree))


def load_params_npz(path) -> dict:
    with np.load(path) as z:
        return unflatten_tree({k: z[k] for k in z.files})
