"""``nn`` of the PyTorch port: the Paddle-semantics functionals the
vision train step calls (``nn.functional``)."""
from . import functional

__all__ = ["functional"]
