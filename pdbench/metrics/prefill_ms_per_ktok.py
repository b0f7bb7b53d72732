"""Card milliseconds of the window's ``PrefillNode.run_batch`` spans (CUDA
events the harness puts around them) per thousand prompt tokens they
computed."""


def read(rec):
    spans = rec.prefill_spans
    toks = sum(n for s in spans for _, n in s.work)
    if not toks:
        return None
    return sum(s.clock.ms() for s in spans) / (toks / 1e3)
