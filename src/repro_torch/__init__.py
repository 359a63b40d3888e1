"""PyTorch + CUDA port of the pruning engine (filter + LIMIT slice).

Mirrors the JAX package ``repro`` module for module (``core``, ``data``,
``kernels``, ``serve``) and imports neither JAX nor ``repro``.  Entry
points run on the GPU unless the caller passes ``device="cpu"``.
"""
