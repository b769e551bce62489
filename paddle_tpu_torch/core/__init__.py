"""Core objects of the PyTorch port: the explicit key stream
(``generator.Generator``)."""
from .generator import Generator

__all__ = ["Generator"]
