"""Mean virtual milliseconds from a request's placement on a prefill node
to the start of the prefill batch that ran it: the program's
``request.prefill_queue`` spans recorded during the profiled stretch.
None without them."""


def read(rec):
    try:
        from repro_torch.serving import spans
    except ImportError:
        return None
    xs = [s.end - s.start for s in spans.recorded()
          if s.name == "request.prefill_queue"]
    return 1e3 * sum(xs) / len(xs) if xs else None
