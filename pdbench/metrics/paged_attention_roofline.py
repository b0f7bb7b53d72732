"""The profiled decode steps' paged attention at its bound: the KV pages
their contexts needed (``roofline.paged_attention_bytes``) at 3.35 TB/s,
over the device time of the ``paged_attention`` kernels, in %."""
from pdbench import roofline


def read(rec):
    st = rec.stretch
    if st is None:
        return None
    t = st.device_s(lambda n: "paged_attention" in n)
    if not t:
        return None
    c = rec.config
    nbytes = sum(roofline.paged_attention_bytes(c, s.work, s.table_entries)
                 for s in rec.decode_spans if s.in_stretch and s.work)
    return 100.0 * roofline.bound_s(0.0, nbytes) / t
