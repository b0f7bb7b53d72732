"""Gateway backoff requeues in the window per request due in it
(``gateway_stats()["gw_requeues"]``)."""


def read(rec):
    if not rec.stamps:
        return None
    return rec.counters["gw_requeues"] / len(rec.stamps)
