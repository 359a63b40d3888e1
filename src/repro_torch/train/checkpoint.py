"""Fault-tolerant checkpointing: npz + manifest, atomic commit.

The counterpart of the JAX package's ``train/checkpoint.py``, writing and
reading the same format, so each package restores the other's
checkpoints:

    <dir>/step_<N:08d>/
        manifest.json     step, keys, shapes, dtypes (numpy's names:
                          "bfloat16", "float32", "int32"), extra —
                          written LAST
        shard_0.npz       every leaf, keyed by its path in the state tree
                          ("params/layers/attn/wq", "opt/step",
                          "opt/m/embed"; a None subtree has no key)

npz cannot hold bfloat16 or the float8 types: they are stored as
same-width unsigned-integer views (through torch's integer views, with no
``ml_dtypes``), their true dtype in the manifest.  Everything is written
into ``step_<N>.tmp`` and renamed after the manifest is in place, so a
crash mid-save never leaves a directory that ``latest_step`` would pick.
``restore`` takes ``shardings=`` as the JAX one does (a tree like ``like``
of ``sharding.NamedSharding``s: each leaf is placed on its mesh by
``elastic.place``, the elastic-resume path), or ``device=`` for one card;
``save`` writes a DTensor leaf as its whole tensor.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..core.device_stats import resolve_device

# dtype name -> (the numpy view npz stores, the numpy and torch integer
# views of the same width that torch reads it through, the torch dtype)
_VIEWS = {
    "bfloat16": (np.uint16, np.int16, torch.int16, torch.bfloat16),
    "float8_e4m3fn": (np.uint8, np.uint8, torch.uint8, torch.float8_e4m3fn),
    "float8_e5m2": (np.uint8, np.uint8, torch.uint8, torch.float8_e5m2),
}
_NAME_OF = {view[3]: name for name, view in _VIEWS.items()}


def _to_savable(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """(the array npz stores, the dtype name the manifest records)."""
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        t = t.full_tensor()
    t = t.detach().cpu().contiguous()
    name = _NAME_OF.get(t.dtype)
    if name is None:
        arr = t.numpy()
        return arr, str(arr.dtype)
    stored, _, int_view, _ = _VIEWS[name]
    return t.view(int_view).numpy().view(stored), name


def _from_savable(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name in _VIEWS:
        _, np_view, _, torch_dt = _VIEWS[dtype_name]
        return torch.from_numpy(arr.view(np_view)).view(torch_dt)
    return torch.from_numpy(arr)


def _paths(tree, prefix: str = ""):
    """(path, leaf) of every tensor of a state tree: dicts by key,
    named tuples by field, sequences by index; None holds no leaf."""
    if tree is None:
        return
    if isinstance(tree, dict):
        items = ((str(k), v) for k, v in tree.items())
    elif hasattr(tree, "_fields"):
        items = ((f, getattr(tree, f)) for f in tree._fields)
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        yield prefix, tree
        return
    for k, v in items:
        yield from _paths(v, f"{prefix}/{k}" if prefix else k)


def _rebuild(like, leaf_at, prefix: str = ""):
    """A tree shaped like ``like`` whose leaf at each path is
    ``leaf_at(path, leaf)``."""
    if like is None:
        return None
    join = lambda k: f"{prefix}/{k}" if prefix else str(k)
    if isinstance(like, dict):
        return {k: _rebuild(v, leaf_at, join(k)) for k, v in like.items()}
    if hasattr(like, "_fields"):
        return type(like)(*(_rebuild(getattr(like, f), leaf_at, join(f))
                            for f in like._fields))
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, leaf_at, join(i))
                          for i, v in enumerate(like))
    return leaf_at(prefix, like)


def save(directory: str, step: int, state, extra: Optional[dict] = None
         ) -> str:
    """Save a state tree; returns the committed checkpoint path."""
    tmp = os.path.join(directory, f"step_{step:08d}.tmp")
    final = os.path.join(directory, f"step_{step:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)

    arrays: Dict[str, np.ndarray] = {}
    dtypes: Dict[str, str] = {}
    for key, leaf in _paths(state):
        arrays[key], dtypes[key] = _to_savable(leaf)
    np.savez(os.path.join(tmp, "shard_0.npz"), **arrays)

    manifest = {
        "step": step,
        "keys": sorted(arrays),
        "shapes": {k: list(v.shape) for k, v in arrays.items()},
        "dtypes": dtypes,
        "treedef": type(state).__name__,
        "n_processes": 1,
        "n_devices": 1,
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, name, "manifest.json")):
                steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def restore(directory: str, step: int, like, device=None,
            shardings=None) -> Tuple[Any, dict]:
    """Restore into the structure of ``like`` (a tree of tensors, on any
    device, ``meta`` included) on ``device`` (None: the GPU, raising
    without one; ``"cpu"`` for tests) or, with ``shardings`` (a tree like
    ``like`` of ``NamedSharding``s), onto each leaf's sharding: a DTensor
    on its mesh, or a plain tensor on the mesh's device where the mesh has
    one rank.  Passing both raises ``ValueError``.  Each leaf keeps the
    dtype it was saved in; a shape other than ``like``'s raises."""
    if device is not None and shardings is not None:
        raise ValueError("restore takes device= or shardings=, not both")
    sh_at = dict(_paths(shardings)) if shardings is not None else None
    dev = resolve_device(device) if sh_at is None else None
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "shard_0.npz")) as data:
        def leaf_at(key: str, leaf):
            if key not in data:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            t = _from_savable(data[key], manifest["dtypes"][key])
            if tuple(t.shape) != tuple(leaf.shape):
                raise ValueError(f"shape mismatch for {key!r}: ckpt "
                                 f"{tuple(t.shape)} vs {tuple(leaf.shape)}")
            if sh_at is not None:
                from .elastic import place
                return place(t, sh_at[key])
            return t.to(dev)

        return _rebuild(like, leaf_at), manifest


def restore_latest(directory: str, like, device=None, shardings=None):
    step = latest_step(directory)
    if step is None:
        return None, None
    return restore(directory, step, like, device, shardings)
