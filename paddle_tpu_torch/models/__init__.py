"""Models of the PyTorch port: Llama (serving, paged and int8 decode,
training), Qwen2-MoE (training, cached decode, serving) and the vision
zoo (inference and the train step): ResNet, LeNet, AlexNet, VGG,
SqueezeNet, MobileNet V1-V3, ShuffleNetV2, DenseNet, GoogLeNet and
Inception v3."""
from . import llama, qwen2_moe
from .llama import LlamaConfig
from .qwen2_moe import Qwen2MoeConfig
from .lenet import LeNet
from .vgg import VGG, vgg11, vgg13, vgg16, vgg19
from .alexnet import AlexNet, alexnet
from .squeezenet import SqueezeNet, squeezenet1_0, squeezenet1_1
from .mobilenet import (MobileNetV1, MobileNetV2, MobileNetV3Small,
                        MobileNetV3Large, mobilenet_v1, mobilenet_v2,
                        mobilenet_v3_small, mobilenet_v3_large)
from .densenet import (DenseNet, densenet121, densenet161, densenet169,
                       densenet201, densenet264)
from .shufflenetv2 import (ShuffleNetV2, shufflenet_v2_x0_25,
                           shufflenet_v2_x0_33, shufflenet_v2_x0_5,
                           shufflenet_v2_x1_0, shufflenet_v2_x1_5,
                           shufflenet_v2_x2_0, shufflenet_v2_swish)
from .googlenet import GoogLeNet, googlenet
from .inceptionv3 import InceptionV3, inception_v3

__all__ = ["llama", "qwen2_moe", "LlamaConfig", "Qwen2MoeConfig", "LeNet",
           "VGG", "vgg11", "vgg13", "vgg16", "vgg19", "AlexNet", "alexnet",
           "SqueezeNet", "squeezenet1_0", "squeezenet1_1", "MobileNetV1",
           "MobileNetV2", "MobileNetV3Small", "MobileNetV3Large",
           "mobilenet_v1", "mobilenet_v2", "mobilenet_v3_small",
           "mobilenet_v3_large", "DenseNet", "densenet121", "densenet161",
           "densenet169", "densenet201", "densenet264", "ShuffleNetV2",
           "shufflenet_v2_x0_25", "shufflenet_v2_x0_33",
           "shufflenet_v2_x0_5", "shufflenet_v2_x1_0", "shufflenet_v2_x1_5",
           "shufflenet_v2_x2_0", "shufflenet_v2_swish", "GoogLeNet",
           "googlenet", "InceptionV3", "inception_v3"]
