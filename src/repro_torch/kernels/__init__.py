"""Hand-written CUDA kernels of the port, their plain PyTorch versions
(``ref``) and the wrappers that wire them into the engine (``ops``).

Nothing is compiled at import: a kernel's library is built from
``csrc/`` at its first launch on a CUDA tensor (``build.py``).
"""

from . import ops, ref
from .minmax_prune_batched import minmax_prune_batched

__all__ = ["ops", "ref", "minmax_prune_batched"]
