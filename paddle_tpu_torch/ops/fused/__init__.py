"""Fused ops of the PyTorch port (plain torch compositions and the
operands that dispatch to kernels)."""
from .cross_entropy import fused_softmax_cross_entropy
from .int8_matmul import (Int8Weight, int8_weight_matmul,
                          quantize_weight_per_channel)

__all__ = ["fused_softmax_cross_entropy", "Int8Weight",
           "int8_weight_matmul", "quantize_weight_per_channel"]
