"""The vision train step: ``tools/resnet_bench.py``'s step (:99-115) for
any model of the zoo.

``make_train_step(model)`` returns ``step(x, y) -> loss``: under
``auto_cast`` (O1, bf16 unless ``amp=False``) the model's forward in
training mode (BN with the batch's statistics, updating its running
statistics in place; every ``Dropout`` drawing one key a call from the
step's ``core.Generator``), the loss ``cross_entropy(logits.float(),
y)`` (its mean over the batch) or ``loss_fn(outputs, y)``, its backward,
then ``Momentum`` (``lr``, ``momentum``: ``optax.sgd(0.1, momentum=0.9)``
by default) on every parameter in place. The loss of the parameters before the update
comes back as a 0-d f32 tensor; nothing in a step waits for the device.

GoogLeNet's loss with its auxiliary heads (``out + 0.3 · aux1 + 0.3 ·
aux2``, as ``tests/test_vision_zoo.py`` writes it) is such a
``loss_fn``: ``googlenet_aux_loss``. The step runs where the model's
parameters are, ``device`` (the card unless ``"cpu"`` is asked,
``device.resolve_device``) after the model has been moved there.
"""
from __future__ import annotations

from typing import Callable, Optional

from torch import nn

from ..amp import auto_cast
from ..core.generator import Generator
from ..device import resolve_device
from ..models._layers import Dropout
from ..nn.functional import cross_entropy
from ..optimizer import Momentum

__all__ = ["classification_loss", "googlenet_aux_loss", "make_train_step"]


def classification_loss(out, y):
    """``resnet_bench``'s loss, ``cross_entropy(out.float(), y).mean()``:
    the mean over the batch is ``cross_entropy``'s own (a 0-d f32), so
    the second mean would change nothing."""
    return cross_entropy(out.float(), y)


def googlenet_aux_loss(outs, y):
    """GoogLeNet's training loss over ``(out, aux1, aux2)``."""
    out, aux1, aux2 = outs
    return (classification_loss(out, y) + 0.3 * classification_loss(aux1, y)
            + 0.3 * classification_loss(aux2, y))


def make_train_step(model: nn.Module, *, lr: float = 0.1,
                    momentum: float = 0.9, amp: bool = True,
                    generator: Optional[Generator] = None,
                    loss_fn: Optional[Callable] = None, device=None):
    """``step(x, y) -> loss`` (module docstring). ``generator`` gives the
    dropout keys (``Generator(0)`` on the step's device when None); the
    step's ``optimizer`` and ``generator`` are attributes of it. The
    model is put in training mode."""
    dev = resolve_device(device)
    model.to(dev).train()
    gen = Generator(0, device=dev) if generator is None else generator
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = gen
    opt = Momentum(lr, momentum, [p for p in model.parameters()
                                  if p.requires_grad])
    loss_of = classification_loss if loss_fn is None else loss_fn

    def step(x, y):
        with auto_cast(amp):
            loss = loss_of(model(x), y)
        loss.backward()
        opt.step()
        return loss.detach()

    step.optimizer = opt
    step.generator = gen
    return step
