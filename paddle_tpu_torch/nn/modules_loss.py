"""Loss layers: ``paddle_tpu/nn/modules_loss.py`` ``CrossEntropyLoss``
and ``MSELoss``, as ``torch.nn.Module``s over ``nn.functional``.

``CrossEntropyLoss`` keeps the JAX layer's arguments; those the port's
``cross_entropy`` does not implement (soft labels, class weights, label
smoothing, ``use_softmax=False``) raise at the call, as the functional
does.
"""
from __future__ import annotations

from torch import nn

from . import functional as F

__all__ = ["CrossEntropyLoss", "MSELoss"]


class CrossEntropyLoss(nn.Module):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True,
                 label_smoothing=0.0, name=None):
        super().__init__()
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction
        self.soft_label = soft_label
        self.axis = axis
        self.use_softmax = use_softmax
        self.label_smoothing = label_smoothing

    def forward(self, input, label):
        return F.cross_entropy(input, label, weight=self.weight,
                               ignore_index=self.ignore_index,
                               reduction=self.reduction,
                               soft_label=self.soft_label, axis=self.axis,
                               use_softmax=self.use_softmax,
                               label_smoothing=self.label_smoothing)


class MSELoss(nn.Module):
    def __init__(self, reduction="mean"):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return F.mse_loss(input, label, self.reduction)
