"""Vision models of the port (``paddle_tpu/vision/models``): the ResNet
family."""
from .resnet import (BasicBlock, BottleneckBlock, ResNet,  # noqa: F401
                     load_reference_state, reference_state, resnet18,
                     resnet34, resnet50, resnet101, resnet152)

__all__ = ["BasicBlock", "BottleneckBlock", "ResNet", "load_reference_state",
           "reference_state", "resnet18", "resnet34", "resnet50",
           "resnet101", "resnet152"]
