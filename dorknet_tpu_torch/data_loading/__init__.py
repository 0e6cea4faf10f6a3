"""The on-device training input path (counterpart of
``dorknet_tpu.data_loading``): packed datasets, the index sampler, the
device-resident dataset, prefetch, and the augmentation pipeline."""

from dorknet_tpu_torch.data_loading.device_augment import (
    augment_batch_planes, draw_batch_params, draw_mixup, mixup_pair, train_pipeline)
from dorknet_tpu_torch.data_loading.device_dataset import DeviceResidentDataset, fits_in_hbm
from dorknet_tpu_torch.data_loading.image_data_loader import ImageDataLoader, default_precrop
from dorknet_tpu_torch.data_loading.packed_dataset import (
    PACKED_FORMAT, PACKED_META, PackedDataset, is_packed_dir, write_packed_arrays)
from dorknet_tpu_torch.data_loading.prefetch import device_prefetch, stack_batches

__all__ = [
    "augment_batch_planes",
    "draw_batch_params",
    "draw_mixup",
    "mixup_pair",
    "train_pipeline",
    "DeviceResidentDataset",
    "fits_in_hbm",
    "ImageDataLoader",
    "default_precrop",
    "PACKED_FORMAT",
    "PACKED_META",
    "PackedDataset",
    "is_packed_dir",
    "write_packed_arrays",
    "device_prefetch",
    "stack_batches",
]
