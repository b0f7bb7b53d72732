"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

One command runs one cell (a model configuration under a traffic mix)
once::

    python3 -m pdbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, one traffic mix or one
per-layer metric is a file of its own, found by the name that
``BENCHMARK.json`` gives it: ``configs/<config>.json``,
``traffic/<traffic>.json`` and ``metrics/<metric>.py``. The plain
reference that decides ``correct`` and counts the model's weights and
operations lives in ``reference/``, one module a kind of model that a
configuration names (``model.py`` by default), and imports nothing of the
port (``spec.py`` says what a new architecture adds).
"""
