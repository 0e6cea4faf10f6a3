from dorknet_tpu_torch.optimisers.SGD import SGD
from dorknet_tpu_torch.optimisers.SGDMomentum import SGDMomentum
from dorknet_tpu_torch.optimisers.RMSProp import RMSProp
from dorknet_tpu_torch.optimisers.AdamW import AdamW

__all__ = ["SGD", "SGDMomentum", "RMSProp", "AdamW"]
