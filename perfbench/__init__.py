"""The benchmark of bath_tpu_torch on an NVIDIA H100.

``python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``: see ``harness.py`` for a run, ``check.py`` for what
decides ``correct``, ``reference/`` for the plain reference and
``BENCHMARK.json`` at the checkout's root for the cells and metrics.
"""
