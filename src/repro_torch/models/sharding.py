"""The ParamSpec system, reduced to what one card needs.

Every parameter is declared as a ``ParamSpec(shape, logical_axes)``, as in
the JAX package; ``init_params`` materialises a tree of specs on one
device.  The logical axes are kept (they name what each dimension is), but
the mesh rules, ``constrain`` and the shardings of the JAX package wait for
the rest of the LM substrate (ROADMAP queue 1, item 15): the port's layers
run on one card and never constrain an activation.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Tuple

import torch

from ..core.device_stats import resolve_device


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    logical: Tuple[str, ...]
    init: str = "normal"       # normal | zeros | ones
    scale: float = 0.02
    dtype: Any = torch.bfloat16

    def __post_init__(self):
        assert len(self.shape) == len(self.logical), (self.shape, self.logical)


def tree_map(fn: Callable, tree):
    """Apply ``fn`` to every leaf of a tree of nested dicts (the port's
    parameter and spec trees), keeping the dict structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree) -> list:
    """The leaves of a tree of nested dicts in ``jax.tree.leaves``'s order:
    the keys of each dict sorted."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(like, leaves):
    """A tree shaped like ``like`` whose leaves are ``leaves``, given in
    ``tree_leaves``'s order."""
    return _unflatten(like, iter(leaves))


def _unflatten(like, it):
    # module level, not a recursive closure: a closure that calls itself
    # is a reference cycle, which would keep ``leaves`` (a step's
    # gradients) alive until the garbage collector runs
    if not isinstance(like, dict):
        return next(it)
    out = {k: _unflatten(like[k], it) for k in sorted(like)}
    return {k: out[k] for k in like}


def init_params(specs, generator: torch.Generator, device=None):
    """Materialise a spec tree on ``device`` (None: the GPU, raising
    without one; ``"cpu"`` for tests).

    As in the JAX package: ``normal`` is scale x N(0, 1) sampled in f32
    and cast to the spec's dtype, ``zeros`` and ``ones`` are constants.
    The samples come from ``generator`` (a ``torch.Generator`` on the same
    device), leaf after leaf in the tree's order, so they are not the
    numbers ``jax.random`` gives for the same seed: a parity test carries
    the JAX package's parameters over with ``convert.params_from_numpy``.

    A leaf stacked over the layers (its first logical axis ``"layers"``)
    is drawn one layer at a time into the finished tensor, so the f32
    draw never holds more than one layer: a whole f32 draw of a MoE
    expert leaf at full width (``[48, 128, 2048, 768]``, 38.65 GB) beside
    the leaves already made would not fit on one card.  The hybrid's
    doubly stacked ``[groups, attn_every, ...]`` leaves are drawn one
    group at a time.
    """
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator is on {generator.device}, parameters "
                         f"go to {dev}")

    def mk(spec: ParamSpec) -> torch.Tensor:
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=spec.dtype, device=dev)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=spec.dtype, device=dev)
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        scale = spec.scale if spec.init == "normal" else 1.0 / math.sqrt(fan_in)

        def draw(shape):
            x = torch.randn(shape, generator=generator, dtype=torch.float32,
                            device=dev)
            return x.mul_(scale).to(spec.dtype)

        if spec.logical[0] != "layers":
            return draw(spec.shape)
        out = torch.empty(spec.shape, dtype=spec.dtype, device=dev)
        for i in range(spec.shape[0]):
            out[i] = draw(spec.shape[1:])
        return out

    return tree_map(mk, specs)


def tree_bytes(tree) -> int:
    """Bytes held by the tensors of a tree."""
    total = 0

    def add(t):
        nonlocal total
        total += t.numel() * t.element_size()

    tree_map(add, tree)
    return total
