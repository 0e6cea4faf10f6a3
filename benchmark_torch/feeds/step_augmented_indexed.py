"""Rows of a device-resident canvas set through the program's
``Trainer.step_augmented_indexed``: the flagship script's resident path.

The set holds the configuration's ``train_set_size`` uint8 precrop canvases
on the card; rows are drawn as a seeded shuffled cycle, ``rows_per_step``
a step, augmented and mixed up in the step. The augmentation's draws come
from a seeded ``torch.Generator`` that the reference seeds alike.
"""

import numpy as np
import torch
import torch.nn.functional as F

from benchmark_torch.harness import weights
from benchmark_torch.reference import augment as ref_augment
from benchmark_torch.work import counts


class Feed:
    def __init__(self, cfg, mix, seed, device):
        self.cfg = cfg
        self.rows = int(mix["rows_per_step"])
        self.images_per_step = 2 * self.rows if cfg.get("mixup") else self.rows
        N, (ph, pw) = int(cfg["train_set_size"]), cfg["precrop_hw"]
        gen = torch.Generator(device=device).manual_seed(weights.sub_seed(seed, 3))
        self.images = torch.empty((N, ph, pw, 3), dtype=torch.uint8, device=device)
        step = max(1, (1 << 30) // (ph * pw * 3))
        for s in range(0, N, step):
            self.images[s:s + step].random_(0, 256, generator=gen)
        self.labels = torch.randint(0, cfg["num_classes"], (N,), generator=gen, device=device,
                                    dtype=torch.int32)
        rng = np.random.RandomState(weights.sub_seed(seed, 4) % (1 << 32))
        self.order = rng.permutation(N).astype(np.int64)
        self.aug_seed = weights.sub_seed(seed, 5)
        self.generator = torch.Generator(device=device).manual_seed(self.aug_seed)
        self.out_hw = tuple(cfg["image_hw"])
        self.mixup = tuple(cfg["mixup"]) if cfg.get("mixup") else None

    def row_ids(self, i):
        return np.take(self.order, np.arange(i * self.rows, (i + 1) * self.rows), mode="wrap")

    def call(self, trainer, i):
        return trainer.step_augmented_indexed(
            self.generator, self.images, self.labels, self.row_ids(i), self.out_hw,
            self.cfg["num_classes"], mixup=self.mixup, **self.cfg["augment"])

    def keep_for_reference(self, n):
        """The canvases and labels of the first n steps, copied out of the
        set before it is freed."""
        return [(self.images[torch.as_tensor(self.row_ids(i), device=self.images.device)].clone(),
                 self.labels[torch.as_tensor(self.row_ids(i), device=self.images.device)].long())
                for i in range(n)]

    def reference_batches(self, kept, device):
        gen = torch.Generator(device=device).manual_seed(self.aug_seed)
        for canvases, labels in kept:
            one_hot = F.one_hot(labels, self.cfg["num_classes"]).float()
            yield ref_augment.train_batch(gen, canvases, one_hot, self.out_hw,
                                          self.cfg["augment"], self.mixup)

    def handles(self):
        """The augmentation call of one step, alone, for its roofline."""
        from dorknet_tpu_torch.data_loading.device_augment import (augment_planes_fused,
                                                                   draw_batch_params)
        aug = self.cfg["augment"]
        X = self.images[torch.as_tensor(self.row_ids(0), device=self.images.device)]
        gen = torch.Generator(device=X.device).manual_seed(11)
        params = draw_batch_params(gen, self.rows, X.shape[1:3], self.out_hw, **aug)
        P = ref_augment.shear_pad(aug["rotation_tuple"], *self.out_hw)
        return {"augment": lambda: augment_planes_fused(X, params, self.out_hw, **aug),
                "augment_bound_ms": counts.augment_bound_ms(self.rows, *self.out_hw, P)}
