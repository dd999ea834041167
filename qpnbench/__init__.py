"""The benchmark of the PyTorch and CUDA port (``qpn_tpu_torch``).

``python3 qpnbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one JSON
line; the pieces of a cell are found by name under this folder: its
configuration (``configs/``), traffic mix (``mixes/``), cell (``cells/``),
the model's assembly by the program (``models/``) and its plain reference
(``reference/``), the route (``routes/``) and one reader per metric
(``metrics/``).
"""
