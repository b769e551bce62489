"""Mixed precision of the PyTorch port: O1 ``auto_cast``."""
from .auto_cast import (amp_cast, amp_state, amp_transform_args, auto_cast,
                        black_list, white_list)

__all__ = ["amp_cast", "amp_state", "amp_transform_args", "auto_cast",
           "black_list", "white_list"]
