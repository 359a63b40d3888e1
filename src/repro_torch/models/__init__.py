"""Model substrate of the port: every family's loss and serving path
(``build_model``: dense, MoE, vlm, ssm, hybrid, encdec), their layers, MoE
block (``moe``) and Mamba2 mixer (``mamba``), the ParamSpec system and the
carry of the JAX package's parameters (``convert.params_from_numpy``).
The optimizer and the train step are in ``repro_torch.train``."""

from .model import build_model

__all__ = ["build_model"]
