"""Carry the JAX package's parameters over to the port.

``params_from_numpy`` takes a parameter tree whose leaves are numpy arrays
(``np.asarray`` of each JAX array) and returns the port's tree of torch
tensors: the same nested dicts, the same shapes, the values bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.device_stats import resolve_device
from .sharding import tree_map


def params_from_numpy(tree, device=None, dtype=None):
    """The port's parameter tree on ``device`` (None: the GPU, raising
    without one; ``"cpu"`` for tests), each leaf in its own dtype or in
    ``dtype`` when one is given.

    ``np.asarray`` of a bf16 JAX array has the ``ml_dtypes`` bfloat16
    dtype, which ``torch.from_numpy`` refuses: such a leaf goes through f32
    and back to bf16, which is exact both ways.
    """
    dev = resolve_device(device)

    def leaf(a) -> torch.Tensor:
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a))      # a writable copy
        return t.to(device=dev, dtype=dtype or t.dtype)

    return tree_map(leaf, tree)
