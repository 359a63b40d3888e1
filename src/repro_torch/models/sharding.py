"""Logical-axis sharding rules (MaxText-style) + the ParamSpec system.

The counterpart of the JAX package's ``models/sharding.py``, with the
same names.  Every parameter is declared as a ``ParamSpec(shape,
logical_axes)``; logical axes are resolved to mesh axes through a rule
table, with *divisibility resolution*: a logical axis whose dimension does
not divide the mesh axis size falls back to replication (e.g. GLM-4's 2
KV heads on 16-way TP).

Parallelism mapping (as in the JAX package):
  batch   -> (pod, data)   data parallelism, hierarchical across pods
  fsdp    -> data           parameter/optimizer sharding (ZeRO-3 style)
  model   -> model          tensor parallelism: heads / mlp / experts / vocab
  kv_seq  -> model          context parallelism for decode KV caches when
                            kv_heads cannot use the model axis

PyTorch's idiom in place of JAX's:
  * a mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with
    ``mesh_dim_names`` (or, device-free, an ``AbstractMesh``); its
    ``shape`` is a tuple, so every function here reads the name -> size
    mapping through ``mesh_shape``;
  * ``P`` is the PartitionSpec: a tuple with one entry a tensor dim (None,
    a mesh axis name, or a tuple of names split major to minor);
  * ``NamedSharding(mesh, spec)`` gives DTensor ``placements()`` (one per
    mesh dim) and every rank's slice (``devices_indices_map``);
  * ``constrain`` ``redistribute``s a DTensor activation to the rule's
    placements (``with_sharding_constraint``'s counterpart).
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..core.device_stats import resolve_device

# logical axis -> mesh axis name(s) (None = replicated)
DEFAULT_RULES: Dict[str, Any] = {
    "batch": ("pod", "data"),
    "fsdp": "data",          # weight sharding along the data axis
    "embed": None,           # d_model
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "experts": "model",
    # 'resident' MoE sharding: experts over the DP axes, expert d_ff over
    # model — weights stay put, tokens all-to-all to them.
    "experts_resident": ("pod", "data"),
    "moe_ff": "model",
    "ssm_heads": "model",
    "ssm_inner": "model",
    "ssm_state": None,
    "conv": None,
    "seq": None,
    "kv_seq": None,          # flipped to 'model' for context-parallel decode
    "layers": None,          # stacked scan-over-layers axis
    "head_dim": None,
    "prefix": None,
}


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


# ---------------------------------------------------------------------------
# meshes, specs and shardings
# ---------------------------------------------------------------------------

class P(tuple):
    """PartitionSpec: one entry a tensor dim — None (replicated), a mesh
    axis name, or a tuple of names (the dim split over them, major to
    minor)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A device-free mesh: axis sizes and names (``jax.sharding.
    AbstractMesh``'s counterpart), for specs computed without a process
    group.  Its ranks are ``range(size)`` in row-major order."""
    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def mesh_dim_names(self) -> Tuple[str, ...]:
        return self.axis_names

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.axis_sizes

    def size(self) -> int:
        return math.prod(self.axis_sizes)


def mesh_shape(mesh) -> Dict[str, int]:
    """The mesh's axis name -> size mapping (JAX's ``mesh.shape``); a
    ``DeviceMesh``'s own ``shape`` is a tuple."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def mesh_size(mesh) -> int:
    return math.prod(mesh_shape(mesh).values())


def mesh_ranks(mesh) -> torch.Tensor:
    """The global rank at every mesh coordinate, shaped like the mesh."""
    if isinstance(mesh, AbstractMesh):
        return torch.arange(mesh.size()).reshape(mesh.axis_sizes)
    return mesh.mesh


def mesh_axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    shape = mesh_shape(mesh)
    if isinstance(axis, tuple):
        return math.prod(shape[a] for a in axis if a in shape)
    return int(shape.get(axis, 1))


def resolve_axis(dim: int, axis, mesh):
    """Divisibility resolution: replicate when the dim doesn't divide."""
    if axis is None:
        return None
    shape = mesh_shape(mesh)
    if isinstance(axis, tuple):
        axis = tuple(a for a in axis if a in shape)
        if not axis:
            return None
        size = mesh_axis_size(mesh, axis)
        if size > 1 and dim % size == 0:
            return axis if len(axis) > 1 else axis[0]
        # try the largest prefix that divides
        for end in range(len(axis) - 1, 0, -1):
            sub = axis[:end]
            if dim % mesh_axis_size(mesh, sub) == 0:
                return sub if len(sub) > 1 else sub[0]
        return None
    if axis not in shape:
        return None
    size = shape[axis]
    return axis if (size > 1 and dim % size == 0) else None


def logical_to_pspec(logical: Tuple[str, ...], shape: Tuple[int, ...], mesh,
                     rules: Optional[Dict[str, Any]] = None) -> P:
    rules = {**DEFAULT_RULES, **(rules or {})}
    used: set = set()
    out = []
    for dim, name in zip(shape, logical):
        axis = resolve_axis(dim, rules.get(name), mesh)
        # a mesh axis may appear only once in a PartitionSpec
        flat = axis if isinstance(axis, tuple) else (axis,) if axis else ()
        if any(a in used for a in flat):
            axis = None
        for a in flat:
            used.add(a)
        out.append(axis)
    return P(*out)


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a ``P`` over it (JAX's ``NamedSharding``)."""
    mesh: Any
    spec: P

    def placements(self) -> tuple:
        """DTensor placements, one per mesh dim: ``Shard(d)`` where the
        spec names that mesh axis on tensor dim d, else ``Replicate()``.

        DTensor splits a dim sharded over several mesh dims in mesh-dim
        order, so a tuple entry must list its axes in that order (the
        rules only make such tuples); another order raises
        ``ValueError``."""
        from torch.distributed.tensor import Replicate, Shard

        names = tuple(self.mesh.mesh_dim_names)
        dim_of: Dict[str, int] = {}
        for d, entry in enumerate(self.spec):
            axes = _entry_axes(entry)
            pos = [names.index(a) for a in axes]
            if pos != sorted(pos):
                raise ValueError(f"spec entry {entry} is not in the mesh's "
                                 f"axis order {names}")
            for a in axes:
                dim_of[a] = d
        return tuple(Shard(dim_of[n]) if n in dim_of else Replicate()
                     for n in names)

    def devices_indices_map(self, shape: Tuple[int, ...]) -> Dict[int, tuple]:
        """{rank: the tuple of slices of a ``shape`` tensor it holds}, as
        JAX's ``devices_indices_map`` gives them (``slice(None)`` on an
        unsharded dim)."""
        sizes = mesh_shape(self.mesh)
        names = tuple(self.mesh.mesh_dim_names)
        ranks = mesh_ranks(self.mesh)
        out = {}
        for coord in itertools.product(*(range(n) for n in ranks.shape)):
            at = dict(zip(names, coord))
            idx = []
            for d, n in enumerate(shape):
                axes = _entry_axes(self.spec[d] if d < len(self.spec)
                                   else None)
                if not axes:
                    idx.append(slice(None))
                    continue
                block, i = n, 0
                for a in axes:
                    block //= sizes[a]
                    i = i * sizes[a] + at[a]
                idx.append(slice(i * block, (i + 1) * block))
            out[int(ranks[coord])] = tuple(idx)
        return out


def spec_sharding(spec: ParamSpec, mesh, rules=None) -> NamedSharding:
    return NamedSharding(mesh, logical_to_pspec(spec.logical, spec.shape,
                                                mesh, rules))


def tree_shardings(specs, mesh, rules=None):
    return tree_map(lambda s: spec_sharding(s, mesh, rules), specs)


def tree_abstract(specs):
    """Tensors on the ``meta`` device for the dry-run (no allocation):
    ``jax.ShapeDtypeStruct``'s counterpart."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                          device="meta"), specs)


_CURRENT_MESH = None
_CURRENT_RULES: Optional[Dict[str, Any]] = None


def current_mesh():
    """The mesh ``use_mesh`` activated, or None."""
    return _CURRENT_MESH


def on_mesh() -> bool:
    """A mesh of more than one rank is active: activations are DTensors."""
    return _CURRENT_MESH is not None and mesh_size(_CURRENT_MESH) > 1


def constrain(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """Activation sharding constraint by logical axes.

    No-op when no mesh is active or the mesh has one rank, so model code
    can sprinkle constraints unconditionally.  Under a larger mesh a
    DTensor is ``redistribute``d to the rule's placements (a ``Partial``
    sum is reduced there); a plain tensor is taken as replicated on every
    rank and sliced to them (no communication).
    """
    if not on_mesh():
        return x
    from torch.distributed.tensor import DTensor, Replicate

    mesh = _CURRENT_MESH
    pspec = logical_to_pspec(
        tuple(l if l is not None else "_replicated" for l in logical),
        tuple(x.shape), mesh, _CURRENT_RULES)
    placements = NamedSharding(mesh, pspec).placements()
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * len(placements),
                               run_check=False)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(mesh, placements)


def mesh_zeros(shape: Tuple[int, ...], dtype, logical: Tuple[Optional[str], ...]
               ) -> torch.Tensor:
    """Zeros of ``shape`` as a DTensor on the active mesh, sharded by
    ``logical`` under the active rules: each rank allocates only its
    shard."""
    from torch.distributed.tensor import zeros

    mesh = _CURRENT_MESH
    pspec = logical_to_pspec(
        tuple(l if l is not None else "_replicated" for l in logical),
        tuple(shape), mesh, _CURRENT_RULES)
    return zeros(tuple(shape), dtype=dtype, device_mesh=mesh,
                 placements=NamedSharding(mesh, pspec).placements())


def entry_dims(entry) -> Tuple[int, ...]:
    """The active mesh's dims (indices, in the entry's order: major to
    minor) that one ``P`` entry names; () for a replicated dim."""
    names = tuple(_CURRENT_MESH.mesh_dim_names)
    return tuple(names.index(a) for a in _entry_axes(entry))


def axis_dims(logical: str, dim: int) -> Tuple[int, ...]:
    """The mesh dims of the active mesh that shard a tensor dim of size
    ``dim`` named ``logical`` (``"batch"``, ``"experts"``, ...): the
    active rules and divisibility, as ``logical_to_pspec`` resolves one
    dim; () where it is replicated."""
    rules = {**DEFAULT_RULES, **(_CURRENT_RULES or {})}
    return entry_dims(resolve_axis(dim, rules.get(logical), _CURRENT_MESH))


def dims_group(dims: Tuple[int, ...]):
    """A functional-collective group over the active mesh's ``dims``:
    ``(mesh, dim)`` for one dim, a flattened mesh of them (major to minor)
    for several; None for none."""
    if not dims:
        return None
    from torch.utils._python_dispatch import _disable_current_modes

    mesh = _CURRENT_MESH
    if len(dims) == 1:
        return (mesh, dims[0])
    names = tuple(mesh.mesh_dim_names)
    # the mesh's own rank tables are plain tensors: built outside any
    # dispatch mode (the dry-run's fake tensors, its collective counter)
    with _disable_current_modes():
        return (mesh[tuple(names[d] for d in dims)]._flatten(), 0)


def axis_group(logical: str, dim: int):
    """The process group of a logical axis on the active mesh (as
    ``dims_group`` gives it), or None where the axis is replicated."""
    return dims_group(axis_dims(logical, dim))


def dims_index(dims: Tuple[int, ...]) -> int:
    """This rank's block along ``dims`` of the active mesh: its
    coordinates on them, the first the major."""
    mesh = _CURRENT_MESH
    coord = mesh.get_coordinate()
    i = 0
    for d in dims:
        i = i * mesh.size(d) + coord[d]
    return i


def spec_pspec(spec: ParamSpec) -> P:
    """A leaf's ``P`` on the active mesh under the active rules."""
    return logical_to_pspec(spec.logical, spec.shape, _CURRENT_MESH,
                            _CURRENT_RULES)


def spec_placements(spec: ParamSpec) -> tuple:
    """The DTensor placements of a leaf declared by ``spec`` on the active
    mesh under the active rules: what ``reshard`` gives it and what
    ``local_map`` takes as its ``in_placements``."""
    return NamedSharding(_CURRENT_MESH, spec_pspec(spec)).placements()


class use_mesh:
    """Activate a mesh (+ optional rule overrides) for ``constrain``.

    With a mesh of more than one rank the block also runs under DTensor's
    ``implicit_replication``: a plain tensor that meets a DTensor in an op
    (positions, masks, constants) counts as replicated, as an unsharded
    array does under ``jax.jit``."""

    def __init__(self, mesh, rules: Optional[Dict[str, Any]] = None):
        self.mesh = mesh
        self.rules = rules
        self._implicit = None

    def __enter__(self):
        global _CURRENT_MESH, _CURRENT_RULES
        self._prev = (_CURRENT_MESH, _CURRENT_RULES)
        _CURRENT_MESH = self.mesh
        _CURRENT_RULES = self.rules
        if mesh_size(self.mesh) > 1:
            from torch.distributed.tensor.experimental import \
                implicit_replication
            self._implicit = implicit_replication()
            self._implicit.__enter__()
        return self.mesh

    def __exit__(self, *exc):
        global _CURRENT_MESH, _CURRENT_RULES
        if self._implicit is not None:
            self._implicit.__exit__(*exc)
            self._implicit = None
        _CURRENT_MESH, _CURRENT_RULES = self._prev
        return False
