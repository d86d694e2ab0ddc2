"""The benchmark of ``needletail_tpu_torch``, the PyTorch and CUDA port.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on one card: it
generates the cell's inputs from the seed, times whole jobs of the port's
public entry back to back, checks every sampled answer against the plain
NumPy reference in ``reference/`` and prints one JSON line.  Cells,
configurations, traffic mixes, metrics and kernel names are all found by
name in files of their own (``configs/``, ``traffic/``, ``metrics/``,
``kernels.json``).  Nothing here imports JAX or the JAX package.
"""
