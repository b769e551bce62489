"""``framework`` of the PyTorch port: ``save`` / ``load`` (``io``), the
JAX package's ``paddle_tpu/framework/io.py`` on torch tensors. The JAX
package's device helpers here (``set_device``, the Places) are JAX
device plumbing; the port names its devices with ``torch.device``
(``device.resolve_device``)."""
from . import io
from .io import load, save

__all__ = ["io", "load", "save"]
