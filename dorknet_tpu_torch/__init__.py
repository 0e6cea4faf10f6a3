"""dorknet_tpu_torch — the PyTorch and CUDA port of dorknet_tpu.

It mirrors the JAX package's module paths, class names and method names, and
is held against it by the ``tests/test_torch_*.py`` parity tests. Every
Pallas kernel on a ported path becomes a CUDA kernel written by hand for
Hopper (``csrc/``), built with ``nvcc`` at first use.

This package imports ``torch`` and ``numpy``, never ``jax`` or
``dorknet_tpu``; ``h5py`` only inside the checkpoint loader.
"""

__version__ = "0.1.0"
