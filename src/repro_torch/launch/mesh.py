"""The partition-shard mesh of the metadata-plane kernels.

A mesh here is an ordered tuple of ``torch.device``s: shard i of a
resident plane's capacity is evaluated on ``mesh[i]``
(``kernels.ops.mesh_shards``).  The JAX package's production and host
meshes (``data`` / ``model`` axes) belong to the LM substrate and are not
part of this module.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch


def make_plane_mesh(devices: Optional[Sequence] = None
                    ) -> Tuple[torch.device, ...]:
    """The devices a resident plane's partition (capacity) dim shards over.

    ``devices=None`` takes the visible CUDA devices (raising without one)
    and keeps the largest power-of-two prefix of them: plane capacities
    are powers of two, so every capacity at least as wide as the mesh
    divides evenly.  On a one-card machine the mesh has one device and the
    launches stay unsharded.

    An explicit list is kept as given, repeats included: ``[dev] * 4`` is
    a *logical* mesh of four shards on one device, which runs the split,
    the per-shard launches and the merge where only one device exists.
    """
    if devices is None:
        n_visible = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        if n_visible == 0:
            raise RuntimeError(
                "no CUDA device is available; pass devices=['cpu'] (or a "
                "list of one device repeated) for a mesh on the CPU")
        n = 1
        while n * 2 <= n_visible:
            n *= 2
        return tuple(torch.device("cuda", i) for i in range(n))
    mesh = tuple(_indexed(torch.device(d)) for d in devices)
    if not mesh:
        raise ValueError("a plane mesh needs at least one device")
    return mesh


def _indexed(dev: torch.device) -> torch.device:
    """``cuda`` as the current CUDA device's index (what a tensor placed on
    ``cuda`` reports), so a mesh device compares equal to its planes'."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev
