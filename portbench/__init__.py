"""portbench: the benchmark of ``radix_sort_tpu_torch`` on NVIDIA cards.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Everything a cell needs is found by name: its configuration
file (``BENCHMARK.json`` ``configs[].file``), its traffic file
``traffic/<traffic>.json``, whose ``mix`` names the driver module
``mixes/<mix>.py`` and the plain reference ``reference/<mix>.py``, and
one reader ``metrics/<metric>.py`` a per-layer metric.

The yardstick lives here and nowhere in the program: the generators
(``gen/``), the window arithmetic (``window.py``), the peaks
(``peaks.py``), the trace reduction (``trace.py``) and the references.
Nothing here imports JAX or the JAX package ``radix_sort_tpu``;
``reference/`` imports nothing of ``radix_sort_tpu_torch`` either.
"""
