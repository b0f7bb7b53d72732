"""The profiled prefills' flash attention at its bound: the larger of the
causal operations their prompts needed (each query row against its prefix
and its own earlier rows) at 495 TFLOP/s and their bytes at 3.35 TB/s,
over the device time of the ``flash_prefill`` kernels, in %."""
from pdbench import roofline


def read(rec):
    st = rec.stretch
    if st is None:
        return None
    t = st.device_s(lambda n: "flash_prefill" in n)
    if not t:
        return None
    c = rec.config
    work = [w for s in rec.prefill_spans if s.in_stretch for w in s.work]
    flops = sum(roofline.attention_flops(c, roofline.attention_pairs(p, n))
                for p, n in work)
    nbytes = sum(roofline.flash_prefill_bytes(c, p, n) for p, n in work)
    return 100.0 * roofline.bound_s(flops, nbytes) / t
