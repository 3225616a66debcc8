"""The benchmark of ``raytpu_torch``, the PyTorch and CUDA port, on an
NVIDIA H100.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once (``run.py``).
The harness (``harness.py``) finds a cell's configuration, traffic mix,
driver, metric readers and limits by name; the yardstick (the plain
reference, the work counts and the peaks) lives in ``reference/``, which
imports nothing of the program. Nothing here imports ``jax`` or
``raytpu``, the JAX package the port was made from.
"""
