"""Share of the profiled stretch's wall time in which the device was idle
while the host was inside a ``prefill.batch`` span of the program (see
``device_idle_share.decode_step.py``, whose ``split`` this reads)."""
import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "pdbench_idle_split",
    Path(__file__).with_name("device_idle_share.decode_step.py"))
_split = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_split)


def read(rec):
    ns = _split.split(rec)
    return None if ns is None else ns["prefill.batch"] / (rec.stretch.wall_s
                                                           * 1e9)
