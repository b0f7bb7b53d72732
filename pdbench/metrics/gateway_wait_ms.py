"""Mean virtual milliseconds from a request's due arrival to its placement
on a node, backoff requeues included: the program's ``request.gateway``
spans recorded during the profiled stretch. None without them."""


def read(rec):
    try:
        from repro_torch.serving import spans
    except ImportError:
        return None
    xs = [s.end - s.start for s in spans.recorded()
          if s.name == "request.gateway"]
    return 1e3 * sum(xs) / len(xs) if xs else None
