"""Load-time model transforms of the PyTorch port (the counterparts of
``paddle_tpu/analysis``'s rewrite passes)."""
from .rewrite_conv import ConvBnAct, FoldResult, fold_conv_bn

__all__ = ["ConvBnAct", "FoldResult", "fold_conv_bn"]
