"""Mean card milliseconds of the window's ``DecodeNode.step`` spans (CUDA
events the harness puts around them)."""


def read(rec):
    spans = rec.decode_spans
    return sum(s.clock.ms() for s in spans) / len(spans) if spans else None
