"""Global configuration for dorknet_tpu_torch.

The counterpart of ``dorknet_tpu/config.py``: fp32 is the default compute
dtype, for numerics parity with the reference; ``torch.bfloat16`` makes
convolutions and matmuls take bf16 inputs and lets activations flow in bf16,
while parameters stay fp32 and batch norm and the softmax compute in fp32.

Under fp32 the policy also turns TF32 off for both cuBLAS matmuls and cuDNN
convolutions. cuDNN's default is TF32, which keeps about three decimal digits
and would break the stem convolution's parity with the JAX package.

There is no ``use_pallas`` counterpart: on a CUDA tensor the hand-written
kernels always run (see ``ops/cuda/``).
"""

import torch

_COMPUTE_DTYPE = torch.float32


def set_compute_dtype(dtype):
    """Set the dtype of conv/matmul inputs and of the activation flow:
    ``torch.float32`` (default) or ``torch.bfloat16``."""
    global _COMPUTE_DTYPE
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("compute dtype must be torch.float32 or "
                         "torch.bfloat16, got {}".format(dtype))
    _COMPUTE_DTYPE = dtype
    if dtype == torch.float32:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def get_compute_dtype():
    return _COMPUTE_DTYPE


set_compute_dtype(torch.float32)
