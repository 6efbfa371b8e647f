"""The benchmark of ``bgt_tpu_torch``: its HTTP server under open- and
closed-loop traffic on one H100, with every answer held to a plain NumPy
reference.  ``python3 benchmark/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` runs one cell once; ``BENCHMARK.json`` at the
root of the checkout names the cells, and the configurations, traffic mixes
and per-layer metrics are files found by name under this folder."""
