"""The benchmark of ``nmf_tpu_torch``: whole ``nnmf`` solves on a card, timed
from outside the program and checked against a plain PyTorch reference.

``python portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one JSON line.
Everything a cell is made of is a file found by name: ``configs/`` (the
matrix), ``traffic/`` (the solve), ``limits/`` (what ``correct`` allows),
``generators/`` (how a configuration's data is drawn from the seed),
``metrics/`` (one reader a metric) and ``reference/`` (the plain solvers).
"""
