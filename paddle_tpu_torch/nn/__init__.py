"""``nn`` of the PyTorch port: the Paddle-semantics functionals
(``nn.functional``), the loss layers ``CrossEntropyLoss`` / ``MSELoss``
(``modules_loss``) and the gradient clips (``clip``)."""
from . import functional
from .clip import (ClipGradBase, ClipGradByGlobalNorm, ClipGradByNorm,
                   ClipGradByValue)
from .modules_loss import CrossEntropyLoss, MSELoss

__all__ = ["functional", "ClipGradBase", "ClipGradByGlobalNorm",
           "ClipGradByNorm", "ClipGradByValue", "CrossEntropyLoss",
           "MSELoss"]
