"""Mesh construction: the LM meshes and the metadata planes' mesh.

FUNCTIONS, not module-level constants — importing this module never
touches a process group or a device.

  * ``make_production_mesh``: single pod (data=16, model=16) = 256 ranks;
    multi-pod (pod=2, data=16, model=16) = 512, the ``pod`` axis composing
    with ``data`` into the DP/FSDP dimension.  A ``DeviceMesh`` over the
    default process group, which must have that many ranks: a real job's,
    or the dry-run's fake one.
  * ``make_host_mesh``: the world as a (data, model) mesh, starting a
    one-rank group of its own when none exists (tests, one card).
  * ``make_plane_mesh``: the partition-shard mesh of the metadata-plane
    kernels, an ordered tuple of ``torch.device``s: shard i of a resident
    plane's capacity is evaluated on ``mesh[i]`` (``kernels.ops.
    mesh_shards``).

The port's ``DeviceMesh``es carry no axis types: JAX's ``jax.make_mesh``
makes Explicit axes under jax 0.9, which the JAX package's ``constrain``
then refuses (ROADMAP queue 3, R3); nothing here has that fault.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Sequence, Tuple

import torch

from ..core.device_stats import resolve_device


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The production mesh over the first ranks of the default process
    group (which must have at least as many: ``jax.make_mesh`` takes the
    first devices too).  ``REPRO_MESH_SCALE=n`` shrinks every axis but
    ``pod`` by n for CI-scale validation of the identical code path, as in
    the JAX package.  ``device`` is the DTensors' device: None means the
    GPU, raising without one; the dry-run's fake group passes ``"cpu"``."""
    from torch.distributed.device_mesh import DeviceMesh

    dev = resolve_device(device)
    scale = int(os.environ.get("REPRO_MESH_SCALE", "1"))
    d, m = 16 // scale, 16 // scale
    shape = (2, d, m) if multi_pod else (d, m)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    ranks = torch.arange(math.prod(shape)).reshape(shape)
    return DeviceMesh(dev.type, ranks, mesh_dim_names=axes)


def make_host_mesh(device=None):
    """Whatever this job offers, as a (data, model) mesh: the world of the
    default process group, the model axis 4 or 2 wide where the world
    divides (as the JAX package picks it), else 1.

    Without a process group it starts a one-rank one on a
    ``torch.distributed.HashStore`` (no network, no environment
    variables): NCCL on the card, gloo on the CPU (``device="cpu"``); the
    mesh is then (1, 1).  ``device`` None means the GPU, raising without
    one."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    if not dist.is_initialized():
        if dev.type == "cuda":
            dist.init_process_group(
                "nccl", store=dist.HashStore(), rank=0, world_size=1,
                device_id=torch.device("cuda", torch.cuda.current_device()))
        else:
            dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                    world_size=1)
    n = dist.get_world_size()
    model = 1
    for m in (4, 2):
        if n % m == 0 and n > m:
            model = m
            break
    return init_device_mesh(dev.type, (n // model, model),
                            mesh_dim_names=("data", "model"))


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
