"""Paddle-semantics functionals of the PyTorch port: ``cross_entropy``
for class logits, ``mse_loss`` and ``dropout`` with an explicit
key."""
from .common import dropout
from .loss import cross_entropy, mse_loss

__all__ = ["cross_entropy", "dropout", "mse_loss"]
