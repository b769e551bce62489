"""Optimizers of the PyTorch port: ``Momentum`` (the vision train step's
SGD with momentum). Llama's AdamW is ``models.llama.AdamW``."""
from .momentum import Momentum

__all__ = ["Momentum"]
