from dorknet_tpu_torch.models.mnist_convnet import MNISTNet
from dorknet_tpu_torch.models.mobilenet_v2 import MobileNetV2
from dorknet_tpu_torch.models.resnet import ResNet18, build_resnet18_plain

__all__ = ["MNISTNet", "ResNet18", "build_resnet18_plain", "MobileNetV2"]
