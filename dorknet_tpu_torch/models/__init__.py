from dorknet_tpu_torch.models.resnet import ResNet18

__all__ = ["ResNet18"]
