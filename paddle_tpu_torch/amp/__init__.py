"""Mixed precision of the PyTorch port (``paddle_tpu/amp``): O1
``auto_cast``, O2 ``decorate``, the dynamic loss scaler ``GradScaler``
and the nan/inf tools of ``debugging``."""
from . import debugging
from .auto_cast import (amp_cast, amp_state, amp_transform_args, auto_cast,
                        black_list, decorate, is_bfloat16_supported,
                        is_float16_supported, white_list)
from .grad_scaler import AmpScaler, GradScaler

amp_guard = auto_cast

__all__ = ["AmpScaler", "GradScaler", "amp_cast", "amp_guard", "amp_state",
           "amp_transform_args", "auto_cast", "black_list", "debugging",
           "decorate", "is_bfloat16_supported", "is_float16_supported",
           "white_list"]
