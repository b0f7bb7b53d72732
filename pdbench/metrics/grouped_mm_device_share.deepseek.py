"""Device time of the grouped product's kernels (sorted MoE dispatch) over
the device's busy time in the profiled stretch."""
from pdbench.trace import is_grouped


def read(rec):
    st = rec.stretch
    if st is None or not st.kernels:
        return None
    g = st.device_s(is_grouped)
    return g / st.busy_s() if g else None
