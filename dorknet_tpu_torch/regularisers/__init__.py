from dorknet_tpu_torch.regularisers.l2 import l2

__all__ = ["l2"]
