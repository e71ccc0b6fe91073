"""Vision models of the port (counterpart of
`mxnet_tpu.gluon.model_zoo.vision`; ResNet v1 so far)."""
from .resnet import (BasicBlockV1, BottleneckV1, ResNetV1, get_resnet,
                     resnet18_v1, resnet34_v1, resnet50_v1, resnet101_v1,
                     resnet152_v1)

__all__ = ["BasicBlockV1", "BottleneckV1", "ResNetV1", "get_resnet",
           "resnet18_v1", "resnet34_v1", "resnet50_v1", "resnet101_v1",
           "resnet152_v1"]
