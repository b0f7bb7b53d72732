"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

One command runs one cell (a model configuration under a traffic mix)
once::

    python3 -m pdbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, one traffic mix or one
per-layer metric is a file of its own, found by the name that
``BENCHMARK.json`` gives it: ``configs/<config>.json``,
``traffic/<traffic>.json`` and ``metrics/<metric>.py``. The plain
reference that decides ``correct`` lives in ``reference/`` and imports
nothing of the port.
"""
