"""``hapi`` of the PyTorch port: the high-level ``Model`` (``prepare`` /
``fit`` / ``evaluate`` / ``predict`` / ``save`` / ``load``), its
callbacks and ``summary`` (``paddle_tpu/hapi/``)."""
from .model import Model  # noqa: F401
from .callbacks import (  # noqa: F401
    Callback, CallbackList, ProgBarLogger, ModelCheckpoint, EarlyStopping,
    LRScheduler,
)
from .summary import summary  # noqa: F401

__all__ = ["Model", "Callback", "CallbackList", "ProgBarLogger",
           "ModelCheckpoint", "EarlyStopping", "LRScheduler", "summary"]
