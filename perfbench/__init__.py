"""The benchmark of the PyTorch/CUDA port of DSLog (``repro_torch``).

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once.  Configurations,
cells, traffic kinds, store kinds and metric readers are separate files,
found by name: ``configs/<config>.json``, ``workloads/<cell>.json``,
``traffic/<kind>.py``, ``stores/<kind>.py`` and ``metrics/<metric>.py``.
The plain reference that decides ``correct`` is ``reference/``.
"""
