"""``vision`` of the PyTorch port: the model zoo (``vision.models``),
the numpy image ``transforms`` and the ``datasets``
(``paddle_tpu/vision/``), and the vision train step (``vision.train``).
"""
from . import datasets  # noqa: F401
from . import transforms  # noqa: F401
