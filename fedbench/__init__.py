"""The benchmark of ``repro_torch``: whole FeDepth rounds on one card.

``python -m fedbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Everything that belongs to one configuration, traffic mix,
cell or per-layer metric is a file of its own under ``configs/``,
``traffic/``, ``workloads/`` and ``metrics/``, found by its name; the
plain reference that decides ``correct`` is under ``reference/``.
"""
