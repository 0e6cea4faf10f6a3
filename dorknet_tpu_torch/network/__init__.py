from dorknet_tpu_torch.network.feed_forward_network import FeedForwardNetwork
from dorknet_tpu_torch.network.inference import InferenceRunner
from dorknet_tpu_torch.network.serving import BatchingServer, OverloadedError
from dorknet_tpu_torch.network.trainer import Trainer

__all__ = ["FeedForwardNetwork", "InferenceRunner", "BatchingServer",
           "OverloadedError", "Trainer"]
