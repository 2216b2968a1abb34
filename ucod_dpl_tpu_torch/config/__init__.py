"""Configuration of the PyTorch port (a copy of the JAX package's, jax-free)."""

from .config import CfgNode, load_config

__all__ = ["CfgNode", "load_config"]
