"""Mean active slots a decode step: output tokens the window's decode
steps made (its output tokens less the first tokens prefill made) over its
fused steps."""


def read(rec):
    steps = rec.counters["fused_steps"]
    if not steps:
        return None
    return (rec.output_tokens - rec.first_tokens) / steps
