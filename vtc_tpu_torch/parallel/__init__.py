"""Parallel layers of the port: the mixture-of-experts MLP on one device."""

from .expert import MoEMLP, moe_layers

__all__ = ["MoEMLP", "moe_layers"]
