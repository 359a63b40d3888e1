"""Model substrate of the port: the dense and MoE decoders
(``build_model``), their layers and MoE block (``moe``), the ParamSpec
system and the carry of the JAX package's parameters
(``convert.params_from_numpy``)."""

from .model import build_model

__all__ = ["build_model"]
