"""Experiment lifecycle (counterpart of ``dorknet_tpu/utils/experiment.py``):
a checkpoint every epoch, resume from the latest, and the structure json
the reference's flagship script writes by hand.

Checkpoints are the reference's h5+json (accuracy-stamped
``epoch_{e}_testacc_{acc}.h5``), so runs are interchangeable with the JAX
package's and the reference's; writing and reading them needs h5py.
"""

import os
import re

from dorknet_tpu_torch.network.feed_forward_network import FeedForwardNetwork

_CKPT_RE = re.compile(r"epoch_(\d+)_testacc_([0-9.eE+-]+?)\.h5$")
# the accuracy group takes scientific notation: str(6.1e-05) names real
# early-epoch checkpoints of many-class problems


def checkpoint_path(experiment_dir, epoch, test_acc):
    return os.path.join(experiment_dir,
                        "epoch_{}_testacc_{}.h5".format(epoch, test_acc))


def find_latest_checkpoint(experiment_dir):
    """Returns (h5_path, epoch, test_acc) of the highest-epoch checkpoint, or
    (None, 0, None) when the directory has none."""
    best = (None, 0, None)
    if not os.path.isdir(experiment_dir):
        return best
    for f in os.listdir(experiment_dir):
        m = _CKPT_RE.match(f)
        if m and int(m.group(1)) > best[1]:
            best = (os.path.join(experiment_dir, f), int(m.group(1)),
                    float(m.group(2)))
    return best


class Experiment:
    """The reference's script-level training plumbing:

        exp = Experiment("DogsRun", network_factory=lambda: ResNet18(...))
        net, start_epoch = exp.resume_or_init()
        for e in range(start_epoch, 40):
            ... train ...
            exp.save_epoch(net, e, test_acc)

    ``resume_or_init`` rebuilds the network from the latest accuracy-stamped
    h5 when there is one, else builds a fresh network and writes the
    structure json."""

    def __init__(self, name, network_factory, base_dir=".",
                 empty_network_factory=None):
        """empty_network_factory (optional) builds a layer-less carrier for
        resume, e.g. ``lambda: ResNet18("", load_layers=False)``, so the
        restored object keeps its model class. Defaults to a plain
        FeedForwardNetwork."""
        self.name = name
        self.network_factory = network_factory
        self.empty_network_factory = empty_network_factory
        self.dir = os.path.join(base_dir, name)
        self.json_path = os.path.join(self.dir, name + ".json")

    def resume_or_init(self):
        os.makedirs(self.dir, exist_ok=True)
        ckpt, epoch, acc = find_latest_checkpoint(self.dir)
        if ckpt is not None and not os.path.exists(self.json_path):
            # checkpoints without the structure json: re-initialising would
            # rewrite the json and restart at epoch 1, and the next resume
            # would load the stale high-epoch h5 against the new json
            raise RuntimeError(
                "{} contains checkpoints (latest: {}) but no structure json "
                "at {}; restore the json or remove the stale checkpoints "
                "before resuming".format(self.dir, ckpt, self.json_path))
        if ckpt is not None:
            if self.empty_network_factory is not None:
                net = self.empty_network_factory()
            else:
                net = FeedForwardNetwork("")
            net.load_network_from_json_and_h5(self.json_path, ckpt)
            return net, epoch + 1
        net = self.network_factory()
        net.save_layer_structure_to_json(self.json_path)
        return net, 1

    def save_epoch(self, network, epoch, test_acc):
        path = checkpoint_path(self.dir, epoch, test_acc)
        network.save_weights_to_h5(path)
        return path
