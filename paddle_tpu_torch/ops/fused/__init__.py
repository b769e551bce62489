"""Fused ops of the PyTorch port (plain torch compositions)."""
from .cross_entropy import fused_softmax_cross_entropy

__all__ = ["fused_softmax_cross_entropy"]
