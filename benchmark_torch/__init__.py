"""The benchmark of the PyTorch and CUDA port (``dorknet_tpu_torch``).

``python3 benchmark_torch/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. Everything a cell needs is found by name: its configuration
(``configs/``), its plain reference (``reference/``), its traffic mix
(``traffic/``, naming a loop in ``loops/``), its limits (``limits/``)
and its per-layer readers (``metrics/``). Nothing here imports ``jax`` or
the JAX package."""
