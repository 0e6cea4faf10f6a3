"""Plain fp32 PyTorch references of the benchmark's architectures, one
module per architecture (``forward(ex, x, cfg)``), on ``plain.Executor``.
Nothing here imports the program, JAX or the JAX package."""
