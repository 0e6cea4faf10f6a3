from dorknet_tpu_torch.models.mnist_convnet import MNISTNet
from dorknet_tpu_torch.models.resnet import ResNet18, build_resnet18_plain
from dorknet_tpu_torch.models.mobilenet_v2 import MobileNetV2
from dorknet_tpu_torch.models.mobilenet_v3 import MobileNetV3Large, MobileNetV3Small
from dorknet_tpu_torch.models.resnet50 import ResNet50, ResNet101
from dorknet_tpu_torch.models.efficientnet_lite import EfficientNetLite, EfficientNetLite0

__all__ = ["MNISTNet", "ResNet18", "build_resnet18_plain", "MobileNetV2", "MobileNetV3Small",
           "MobileNetV3Large", "ResNet50", "ResNet101", "EfficientNetLite", "EfficientNetLite0"]
