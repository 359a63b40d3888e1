"""Architecture configs: one module per assigned architecture.

``get_config(name)`` returns the full published config;
``get_smoke_config(name)`` a reduced same-family config for CPU tests.
"""

from .base import (ARCH_REGISTRY, ModelConfig, get_config, get_smoke_config,
                   list_archs)

__all__ = ["ModelConfig", "get_config", "get_smoke_config", "list_archs",
           "ARCH_REGISTRY"]
