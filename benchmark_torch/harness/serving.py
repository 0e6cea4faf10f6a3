"""What the serving loops share: the served network's weights, the pool of
images, the reference's probabilities and the comparison."""

import numpy as np
import torch

from benchmark_torch.harness import cell as cells
from benchmark_torch.harness import weights
from benchmark_torch.reference.plain import Executor, layer_table
from benchmark_torch.work import counts


class Served:
    """The reference's forward, the weights and calibrated running stats
    made from the seed, and the layer table at the served batch."""

    def __init__(self, rec, batch):
        self.cfg = cfg = rec.cell.config
        self.forward = cells.reference(rec.cell).forward
        spec, rec.layers, _ = layer_table(self.forward, cfg, batch)
        rec.counters["forward_flops_per_image"] = counts.forward_flops_per_image(rec.layers)
        self.params = weights.make_params(spec, rec.seed, rec.device)
        rec.mark("weights made")
        self.stats = weights.calibrated_stats(self.forward, cfg, self.params, rec.seed,
                                              rec.device)
        rec.mark("running stats calibrated")

    def pool(self, rec, shape):
        """Host fp32 images of ``shape`` + (3, H, W), N(0, 1), made on the
        card from the seed."""
        H, W = rec.cell.config["image_hw"]
        gen = torch.Generator(device=rec.device).manual_seed(weights.sub_seed(rec.seed, 6))
        return torch.randn(tuple(shape) + (3, H, W), generator=gen,
                           device=rec.device).cpu().numpy()

    def reference_probs(self, images, device, block=64):
        """The reference's test-mode probabilities of host images (N, 3, H,
        W), computed in blocks on ``device``; a host array (N, classes)."""
        out = []
        with torch.no_grad():
            for s in range(0, len(images), block):
                x = torch.from_numpy(images[s:s + block]).to(device)
                ex = Executor("eval", self.params, self.stats)
                out.append(torch.softmax(self.forward(ex, x, self.cfg), dim=1).cpu())
        return torch.cat(out).numpy()


def prob_gap(served, reference):
    """The largest absolute gap between a served probability and the
    reference's, over every compared answer."""
    return float(np.max(np.abs(np.asarray(served, np.float64) - reference)))
