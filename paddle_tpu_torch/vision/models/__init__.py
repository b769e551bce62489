"""vision.models — the model zoo under the reference's path
(``paddle_tpu/vision/models/__init__.py``), every family it exports, and
``params_from_jax``: the JAX model's ``state_dict()`` as numpy arrays,
for any model of the zoo, as a state dict for ``load_state_dict`` in the
same layouts and dtypes (``llama.params_from_jax``)."""
from ...models.llama import params_from_jax  # noqa: F401
from ...models.lenet import LeNet  # noqa: F401
from ...models.resnet import (  # noqa: F401
    ResNet, BasicBlock, BottleneckBlock,
    resnet18, resnet34, resnet50, resnet101, resnet152,
    wide_resnet50_2, wide_resnet101_2, resnext50_32x4d, resnext50_64x4d,
    resnext101_32x4d, resnext101_64x4d, resnext152_32x4d, resnext152_64x4d,
)
from ...models.vgg import VGG, vgg11, vgg13, vgg16, vgg19  # noqa: F401
from ...models.alexnet import AlexNet, alexnet  # noqa: F401
from ...models.squeezenet import (  # noqa: F401
    SqueezeNet, squeezenet1_0, squeezenet1_1)
from ...models.mobilenet import (  # noqa: F401
    MobileNetV1, MobileNetV2, MobileNetV3Small, MobileNetV3Large,
    mobilenet_v1, mobilenet_v2, mobilenet_v3_small, mobilenet_v3_large)
from ...models.densenet import (  # noqa: F401
    DenseNet, densenet121, densenet161, densenet169, densenet201,
    densenet264)
from ...models.shufflenetv2 import (  # noqa: F401
    ShuffleNetV2, shufflenet_v2_x0_25, shufflenet_v2_x0_33,
    shufflenet_v2_x0_5, shufflenet_v2_x1_0, shufflenet_v2_x1_5,
    shufflenet_v2_x2_0, shufflenet_v2_swish)
from ...models.googlenet import GoogLeNet, googlenet  # noqa: F401
from ...models.inceptionv3 import InceptionV3, inception_v3  # noqa: F401
