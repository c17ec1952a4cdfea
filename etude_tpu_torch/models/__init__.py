"""Part of etude_tpu_torch; see the package docstring."""

from torch import nn


def param_count(model: nn.Module) -> int:
    """The number of parameters (JAX `param_count` in each model module)."""
    return sum(p.numel() for p in model.parameters())
