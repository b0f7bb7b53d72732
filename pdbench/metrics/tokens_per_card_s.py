"""Prompt tokens of the requests first served in the window plus every
output token made in it, over the window's real seconds: the one card ran
every prefill, hand-off and decode of them."""
from pdbench.stats import tokens_per_s


def read(rec):
    return tokens_per_s(rec.prompt_tokens, rec.output_tokens, rec.wall_s)
