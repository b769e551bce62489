"""Paddle-semantics functionals of the PyTorch port: ``cross_entropy``
for class logits and ``dropout`` with an explicit key."""
from .common import dropout
from .loss import cross_entropy

__all__ = ["cross_entropy", "dropout"]
