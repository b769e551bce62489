"""Optimizers of the PyTorch port (``paddle_tpu/optimizer/``): the
Paddle optimizer classes over torch parameters (``optimizer.py``) and the
LR schedulers (``lr``). Llama's fused AdamW is ``models.llama.AdamW``;
``LBFGS`` is not ported."""
from . import lr
from .optimizer import (Optimizer, SGD, Momentum, Adam, AdamW, Adagrad,
                        RMSProp, Adamax, Lamb, L1Decay, L2Decay,
                        Adadelta, ASGD, Rprop, NAdam, RAdam)

__all__ = ["lr", "Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adagrad",
           "RMSProp", "Adamax", "Lamb", "L1Decay", "L2Decay", "Adadelta",
           "ASGD", "Rprop", "NAdam", "RAdam"]
