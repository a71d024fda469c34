"""The benchmark of ``flashdeconv_tpu_torch`` on one NVIDIA card.

``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. Configurations (``configs/``), traffic mixes (``traffic/``),
per-cell limits of the correctness check (``limits/``) and metric readers
(``metrics/``) are files found by the names in ``BENCHMARK.json``; the
plain reference that decides ``correct`` is in ``reference/``.
"""
