"""Share of the profiled stretch's wall time in which no operation ran on
the device: 1 - (union of kernel and copy intervals) / wall."""


def read(rec):
    st = rec.stretch
    if st is None or not st.kernels:
        return None
    return 1.0 - st.busy_s() / st.wall_s
