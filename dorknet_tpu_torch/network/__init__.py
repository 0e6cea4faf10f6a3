from dorknet_tpu_torch.network.feed_forward_network import FeedForwardNetwork
from dorknet_tpu_torch.network.inference import (InferenceRunner, ServingArtifact,
                                                 load_serving_artifact,
                                                 load_serving_program)
from dorknet_tpu_torch.network.serving import BatchingServer, OverloadedError
from dorknet_tpu_torch.network.trainer import Trainer

__all__ = ["FeedForwardNetwork", "InferenceRunner", "BatchingServer",
           "OverloadedError", "Trainer", "load_serving_program", "ServingArtifact",
           "load_serving_artifact"]
