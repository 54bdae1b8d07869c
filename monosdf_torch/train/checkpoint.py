"""Checkpoints in the JAX package's format (monosdf_tpu/train/checkpoint.py):
one pickle per snapshot, ``<epoch>.ckpt`` and ``latest.ckpt`` written
through a temporary name and ``os.replace``, garbage-collected to the last
``keep_last`` (3) numbered files.

The payload is JAX's: ``params``, the parameter tree in the JAX layout
(nested dicts of numpy arrays, ``params.params_to_tree``); ``opt_state``;
``step``; ``epoch``; and ``opt_flavor``, the optimizer state's class name.
The port writes ``opt_state`` as ``AdamState(count, mu, nu)``, a namedtuple
whose moment trees are shaped like ``params``, which the JAX package's
``restore_state`` takes into each of its optimizer flavors (its
``_find_adam_node`` and ``_as_param_trees``). Reading that pickle imports
this module, so the JAX side needs the port importable.

The port reads the JAX package's checkpoints of all three flavors: the
fused ``FlatAdamState`` (one raveled moment vector, in ``ravel_pytree``'s
order, sorted keys, with the zero-padded tail dropped), the per-leaf
``optax.adam`` state and grid mode's ``multi_transform`` partitions (each
group's moments stitched from the leaves it owns). Those pickles name
classes of ``monosdf_tpu`` and ``optax``; ``load_checkpoint`` unpickles
them without either, each known class onto a namedtuple stand-in with its
field order (``_STAND_INS``). Any other class raises. A table leaf of the
model's size but another shape (``param_flat``) is reshaped.

``restore_state`` puts the moments into ``torch.optim.Adam``'s
``exp_avg``/``exp_avg_sq`` with its per-parameter ``step`` = the count,
and sets the schedule's ``last_epoch`` to ``step``, so the learning rate
and the loss's ``end_step`` decay continue exactly where they stopped.
"""

from __future__ import annotations

import collections
import os
import pickle
import re
import warnings
from typing import NamedTuple

import numpy as np
import torch

from ..params import load_jax_params, params_to_tree, unflatten_tree
from .optim import Optimizer


class AdamState(NamedTuple):
    """The port's optimizer payload: the update count and both moments as
    parameter trees."""

    count: np.ndarray
    mu: dict
    nu: dict


# the classes of the JAX package's and optax's optimizer states, each as a
# stand-in with the original's fields in order
_STAND_INS = {
    name: collections.namedtuple(name, fields)
    for name, fields in (
        ("FlatAdamState", ("count", "mu", "nu")),
        ("ScaleByAdamState", ("count", "mu", "nu")),
        ("ScaleByScheduleState", ("count",)),
        ("EmptyState", ()),
        ("MultiTransformState", ("inner_states",)),
        ("PartitionState", ("inner_states",)),
        ("MaskedState", ("inner_state",)),
        ("MaskedNode", ()),
    )
}
_NUMPY = ("_reconstruct", "ndarray", "dtype", "scalar")


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        root = module.split(".")[0]
        if root == "numpy" and name in _NUMPY:
            return super().find_class(module, name)
        if module == __name__ and name == "AdamState":
            return AdamState
        if root in ("monosdf_tpu", "optax") and name in _STAND_INS:
            return _STAND_INS[name]
        raise pickle.UnpicklingError(f"a checkpoint holds {module}.{name}, which the port "
                                     "does not read")


def save_checkpoint(ckpt_dir: str, model, optimizer: Optimizer, epoch: int,
                    keep_last: int = 3) -> str:
    """Write <epoch>.ckpt and latest.ckpt of ``model`` and its ``optimizer``
    (``train.make_optimizer``); GC to ``keep_last`` numbered files. Returns
    the numbered file's path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    step = int(optimizer.schedule.last_epoch)
    payload = {
        "params": params_to_tree(model),
        "opt_state": adam_state(model, optimizer),
        "step": step,
        "epoch": int(epoch),
        "opt_flavor": "AdamState",
    }
    data = pickle.dumps(payload)
    for name in (f"{epoch}.ckpt", "latest.ckpt"):
        tmp = os.path.join(ckpt_dir, name + ".tmp")
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, os.path.join(ckpt_dir, name))
    _gc(ckpt_dir, keep_last)
    return os.path.join(ckpt_dir, f"{epoch}.ckpt")


def _gc(ckpt_dir: str, keep_last: int):
    numbered = []
    for fn in os.listdir(ckpt_dir):
        m = re.fullmatch(r"(\d+)\.ckpt", fn)
        if m:
            numbered.append((int(m.group(1)), fn))
    for _, fn in sorted(numbered)[:-keep_last] if keep_last > 0 else []:
        os.remove(os.path.join(ckpt_dir, fn))


def load_checkpoint(ckpt_dir: str, name: str = "latest") -> dict:
    """The payload {params, opt_state, step, epoch, opt_flavor} of a
    checkpoint that either package wrote, with numpy leaves."""
    with open(os.path.join(ckpt_dir, f"{name}.ckpt"), "rb") as f:
        return _Unpickler(f).load()


def adam_state(model, optimizer: Optimizer) -> AdamState:
    """``AdamState`` of the optimizer's moments, zeros before the first step."""
    state = optimizer.adam.state
    mu, nu, count = {}, {}, 0
    for name, p in model.named_parameters():
        st = state.get(p, {})
        key = name.replace(".", "/")
        if "exp_avg" in st:
            count = int(st["step"])
            mu[key] = st["exp_avg"].detach().cpu().numpy().copy()
            nu[key] = st["exp_avg_sq"].detach().cpu().numpy().copy()
        else:
            mu[key] = np.zeros(tuple(p.shape), np.float32)
            nu[key] = np.zeros(tuple(p.shape), np.float32)
    return AdamState(np.asarray(count, np.int32), unflatten_tree(mu), unflatten_tree(nu))


def _leaves_sorted(tree: dict, prefix: str = "") -> list:
    """(name, array) leaves in ``jax.flatten_util.ravel_pytree``'s order:
    dict keys sorted at every level."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out += _leaves_sorted(v, f"{prefix}{k}.")
        else:
            out.append((f"{prefix}{k}", v))
    return out


def _is_adam_node(t) -> bool:
    return hasattr(t, "_fields") and {"count", "mu", "nu"} <= set(t._fields)


def _find_adam_node(tree):
    """The first namedtuple with (count, mu, nu) fields in an optimizer state."""
    if _is_adam_node(tree):
        return tree
    children = (tree.values() if isinstance(tree, dict)
                else tree if isinstance(tree, (tuple, list)) else ())
    for c in children:
        node = _find_adam_node(c)
        if node is not None:
            return node
    return None


def _moment_leaves(node, params: dict):
    """(count, {name: mu}, {name: nu}) of one Adam node, names dotted as
    ``named_parameters()`` gives them; a raveled (FlatAdamState) moment is
    cut in ravel order, its padded tail dropped. Leaves that are not arrays
    (a partition's masked nodes) are left out."""
    if isinstance(node.mu, np.ndarray):
        leaves = _leaves_sorted(params)
        n = sum(int(np.size(a)) for _, a in leaves)
        mu, nu = np.asarray(node.mu).reshape(-1), np.asarray(node.nu).reshape(-1)
        if mu.shape[0] < n:
            raise ValueError(f"raveled moments of {mu.shape[0]} entries for {n} parameters")
        out_mu, out_nu, off = {}, {}, 0
        for name, a in leaves:
            size = int(np.size(a))
            out_mu[name] = mu[off:off + size].reshape(np.shape(a))
            out_nu[name] = nu[off:off + size].reshape(np.shape(a))
            off += size
        return int(np.asarray(node.count)), out_mu, out_nu
    arrays = lambda tree: {k: v for k, v in _leaves_sorted(tree) if isinstance(v, np.ndarray)}
    return int(np.asarray(node.count)), arrays(node.mu), arrays(node.nu)


def checkpoint_moments(payload: dict):
    """(count, {name: mu}, {name: nu}) of a payload's optimizer state,
    whichever flavor wrote it; None where it holds no Adam moments."""
    saved, params = payload["opt_state"], payload["params"]
    if hasattr(saved, "inner_states"):  # grid mode's multi_transform partitions
        count, mu, nu = 0, {}, {}
        for group in saved.inner_states.values():
            node = _find_adam_node(group)
            if node is None:
                continue
            c, m, v = _moment_leaves(node, params)
            count = max(count, c)
            mu.update(m)
            nu.update(v)
        return (count, mu, nu) if mu else None
    node = _find_adam_node(saved)
    return None if node is None else _moment_leaves(node, params)


def restore_state(model, optimizer: Optimizer, payload: dict, strict: bool = False) -> int:
    """Load a checkpoint payload into ``model`` and ``optimizer``: the
    parameters, Adam's moments and count, and the schedule's step. Where the
    payload holds no Adam moments the optimizer keeps its fresh state, with a
    warning (an error under ``strict``), as the JAX package's
    ``restore_state``. Returns the step."""
    load_jax_params(model, payload["params"])
    adam, schedule = optimizer
    step = int(payload["step"])
    moments = checkpoint_moments(payload)
    named = dict(model.named_parameters())
    if moments is None or set(moments[1]) != set(named):
        msg = ("checkpoint opt_state holds no Adam moments for this model; optimizer moments "
               f"reset (saved flavor: {payload.get('opt_flavor', 'unknown')})")
        if strict:
            raise ValueError(msg)
        warnings.warn(msg)
    elif moments[0] > 0:
        count, mu, nu = moments
        index = {id(p): i for i, p in enumerate(p for g in adam.param_groups for p in g["params"])}
        state = {index[id(p)]: {"step": torch.tensor(float(count)),
                                "exp_avg": torch.from_numpy(np.array(mu[n], np.float32)).reshape(p.shape),
                                "exp_avg_sq": torch.from_numpy(np.array(nu[n], np.float32)).reshape(p.shape)}
                 for n, p in named.items()}
        adam.load_state_dict({"state": state, "param_groups": adam.state_dict()["param_groups"]})
    schedule.last_epoch = step
    for group, lam in zip(adam.param_groups, schedule.lr_lambdas):
        group["lr"] = group["initial_lr"] * lam(step)
    schedule._last_lr = [group["lr"] for group in adam.param_groups]
    return step
