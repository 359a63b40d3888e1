"""Model substrate of the port: the dense decoder (``build_model``), its
layers, the ParamSpec system and the carry of the JAX package's
parameters (``convert.params_from_numpy``)."""

from .model import build_model

__all__ = ["build_model"]
