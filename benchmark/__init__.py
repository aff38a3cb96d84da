"""The benchmark of the PyTorch/CUDA port ``gkgnet_tpu_torch`` on one H100.

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. Everything a cell is made of sits in files found by name:
``configs/<config>.json`` (the model and recipe as run),
``traffic/<traffic>.json`` (the parameters of the general input generator
and window), ``limits/<workload>.json`` (the limits of the comparison that
decides ``correct``) and ``metrics/<metric>.py`` (one reader per metric, or
per family of metrics named ``<family>.<suffix>``). The yardstick (the
frozen FLOP and byte formulas, the peaks, the plain reference and the
comparison) lives here too, beside the program and apart from it.
"""
