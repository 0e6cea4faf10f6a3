"""Batches already on the card through the program's ``Trainer.step``: fp32
NCHW batches of ``batch`` images, cycled from a seeded pool of
``pool_batches``, with no input path."""

import torch
import torch.nn.functional as F

from benchmark_torch.harness import weights


class Feed:
    def __init__(self, cfg, mix, seed, device):
        self.cfg = cfg
        B, P = int(mix["batch"]), int(mix["pool_batches"])
        self.images_per_step = B
        H, W = cfg["image_hw"]
        gen = torch.Generator(device=device).manual_seed(weights.sub_seed(seed, 3))
        self.X = torch.randn((P, B, 3, H, W), generator=gen, device=device)
        labels = torch.randint(0, cfg["num_classes"], (P, B), generator=gen, device=device)
        self.Y = F.one_hot(labels, cfg["num_classes"]).float()

    def call(self, trainer, i):
        return trainer.step(self.X[i % len(self.X)], self.Y[i % len(self.Y)])

    def keep_for_reference(self, n):
        return [(self.X[i % len(self.X)].clone(), self.Y[i % len(self.Y)].clone())
                for i in range(n)]

    def reference_batches(self, kept, device):
        yield from kept

    def handles(self):
        return {}
