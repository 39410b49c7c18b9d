"""The benchmark of the PyTorch and CUDA port (``crdt_tpu_torch``).

``python -m portbench --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json`` once (:mod:`portbench.run`).
Configurations, traffic mixes and per-layer metrics are files of their
own under ``configs/``, ``traffic/`` and ``metrics/``; the plain
reference that decides ``correct`` is under ``reference/`` and imports
nothing of the program.
"""
