"""Lanes: a leading batch axis over the port's state objects.

The JAX package batches by ``jax.tree.map(jnp.stack)`` over its pytrees and
``jax.vmap`` of the one-lane solver.  Here the state objects are frozen
dataclasses (``DeviceLP``, ``PDASState``, ``PDASDDState``), ``DD`` named
tuples and tuples of tensors, with plain ints (``m``, ``n``) beside the
tensors.  :func:`flatten` splits such an object into its tensors and a
rebuild function that keeps everything else as it was, so that
:func:`stack` and :func:`vmap` work on any of them:

- :func:`stack` stacks equal-shaped objects leaf by leaf (the JAX
  ``tree.map(stack)``); the non-tensor fields must agree;
- :func:`vmap` runs a one-lane function over the leading axis of every
  tensor of its arguments with ``torch.func.vmap``;
- :func:`select` keeps, lane by lane, the new or the old object: the
  freeze of a finished lane in a batched loop (JAX's vmapped
  ``while_loop`` advances a lane's carry only while its own condition
  holds).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch


def flatten(obj) -> tuple[list[torch.Tensor], Callable[[list], object]]:
    """(tensors, rebuild): the tensors of ``obj`` in a fixed order, and a
    function that rebuilds ``obj`` with other tensors in their places."""
    if isinstance(obj, torch.Tensor):
        return [obj], lambda ts: ts[0]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        names = [f.name for f in dataclasses.fields(obj)]
        leaves, build = flatten(tuple(getattr(obj, k) for k in names))

        def rebuild(ts):
            return dataclasses.replace(obj, **dict(zip(names, build(ts))))

        return leaves, rebuild
    if isinstance(obj, (tuple, list)):
        parts = [flatten(v) for v in obj]
        sizes = [len(p[0]) for p in parts]
        leaves = [t for p in parts for t in p[0]]

        def rebuild(ts):
            out, at = [], 0
            for (_, build), k in zip(parts, sizes):
                out.append(build(ts[at: at + k]))
                at += k
            if hasattr(obj, "_fields"):  # a named tuple (DD)
                return type(obj)(*out)
            return type(obj)(out)

        return leaves, rebuild
    if isinstance(obj, dict):
        keys = list(obj)
        leaves, build = flatten(tuple(obj[k] for k in keys))
        return leaves, lambda ts: dict(zip(keys, build(ts)))
    return [], lambda ts: obj


def _static(obj):
    """Everything of ``obj`` but its tensors, for comparing structures."""
    if isinstance(obj, torch.Tensor):
        return "tensor"
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj),) + tuple(
            (f.name, _static(getattr(obj, f.name)))
            for f in dataclasses.fields(obj))
    if isinstance(obj, (tuple, list)):
        return (type(obj),) + tuple(_static(v) for v in obj)
    if isinstance(obj, dict):
        return (dict,) + tuple((k, _static(v)) for k, v in obj.items())
    return obj


def stack(objs: Sequence):
    """One object whose tensors are the lanes' tensors stacked on a new
    leading axis.  Every object must have the same structure, the same
    non-tensor fields and the same tensor shapes."""
    if not objs:
        raise ValueError("nothing to stack")
    statics = {repr(_static(o)) for o in objs}
    if len(statics) != 1:
        raise ValueError("the objects to stack differ outside their tensors")
    parts = [flatten(o)[0] for o in objs]
    shapes = {tuple(tuple(t.shape) for t in p) for p in parts}
    if len(shapes) != 1:
        raise ValueError(f"the objects to stack differ in shape: {shapes}")
    return flatten(objs[0])[1]([torch.stack(ts) for ts in zip(*parts)])


def lane(obj, k: int):
    """Lane ``k`` of a stacked object."""
    leaves, build = flatten(obj)
    return build([t[k] for t in leaves])


def vmap(fn: Callable, *args):
    """``fn(*args)`` for every lane: ``torch.func.vmap`` over the leading
    axis of every tensor in ``args``.  What ``fn`` returns may be any object
    :func:`flatten` takes (a state dataclass too): its tensors come back
    with the lane axis first, everything else as ``fn`` gave it."""
    leaves, build = flatten(args)
    rebuild = []

    def one(*ts):
        out, out_build = flatten(fn(*build(list(ts))))
        rebuild.append(out_build)
        return tuple(out)

    out = torch.func.vmap(one)(*leaves)
    return rebuild[0](list(out))


def select(keep: torch.Tensor, new, old):
    """Per lane: ``new`` where ``keep`` (a (B,) bool) holds, else ``old``."""
    n_leaves, build = flatten(new)
    o_leaves, _ = flatten(old)

    def pick(a, b):
        k = keep.view(-1, *([1] * (a.dim() - 1)))
        return torch.where(k, a, b)

    return build([pick(a, b) for a, b in zip(n_leaves, o_leaves)])
