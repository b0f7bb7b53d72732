"""Set-up: process start to the window's start (imports, the kernel
library, weights, the frontend, the prelude's captures, the warm-up)."""


def read(rec):
    return rec.setup_s
