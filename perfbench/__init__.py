"""The benchmark of the PyTorch and CUDA port (``recman_tpu_torch``).

``python3 -m perfbench.run --workload <config>.<traffic> --seed <n>
--seconds <s> --trace <0|1>`` runs one cell of ``BENCHMARK.json`` on one
CUDA card and prints one JSON line. Configurations, traffic mixes,
per-layer metrics and the limits of each cell's check are data files
under ``configs/``, ``traffic/``, ``metrics/`` and ``limits/``, found by
name; the code that reads them (``loops/``, ``readers/``, ``costs/``,
``reference/``) is found by the names those files give. Nothing here
imports ``jax`` or the JAX package, and ``reference/`` imports nothing
of the port.
"""
