"""Model operations of the window's computed prompt tokens and decode
tokens (``roofline.forward_flops`` from the configuration's shapes, each
token against its context) over the window's real seconds, as a share of
495 TFLOP/s (TF32), in %."""
from pdbench import roofline


def read(rec):
    c = rec.config
    flops = sum(roofline.forward_flops(c, p, n)
                for s in rec.prefill_spans for p, n in s.work)
    flops += sum(roofline.forward_flops(c, x - 1, 1)
                 for s in rec.decode_spans for x in s.work)
    if not flops:
        return None
    return 100.0 * flops / rec.wall_s / roofline.PEAK_FLOPS
