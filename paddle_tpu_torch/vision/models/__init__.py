"""vision.models — the ported part of the model zoo under the reference's
path (``paddle_tpu/vision/models/__init__.py``): the ResNet family."""
from ...models.resnet import (  # noqa: F401
    ResNet, BasicBlock, BottleneckBlock,
    resnet18, resnet34, resnet50, resnet101, resnet152,
    wide_resnet50_2, wide_resnet101_2, resnext50_32x4d, resnext50_64x4d,
    resnext101_32x4d, resnext101_64x4d, resnext152_32x4d, resnext152_64x4d,
)
