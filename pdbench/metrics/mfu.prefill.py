"""The prefill batch's share of the card's peak: model operations of the
window's computed prompt tokens (each against its prefix and its own
earlier rows) over the card time of the ``PrefillNode.run_batch`` spans,
as a share of 495 TFLOP/s (TF32), in %. It bounds what any kernel of the
prefill can gain on TTFT."""
from pdbench import roofline


def read(rec):
    c, spans = rec.config, rec.prefill_spans
    flops = sum(roofline.forward_flops(c, p, n)
                for s in spans for p, n in s.work)
    ms = sum(s.clock.ms() for s in spans)
    if not flops or not ms:
        return None
    return 100.0 * flops / (ms / 1e3) / roofline.PEAK_FLOPS
