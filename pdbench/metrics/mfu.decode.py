"""The decode step's share of the card's peak: model operations of the
window's decode tokens (each against its context) over the card time of
the ``DecodeNode.step`` spans, as a share of 495 TFLOP/s (TF32), in %. It
bounds what any kernel of the step can gain on TPOT."""
from pdbench import roofline


def read(rec):
    c, spans = rec.config, rec.decode_spans
    flops = sum(roofline.forward_flops(c, x - 1, 1)
                for s in spans for x in s.work)
    ms = sum(s.clock.ms() for s in spans)
    if not flops or not ms:
        return None
    return 100.0 * flops / (ms / 1e3) / roofline.PEAK_FLOPS
