"""Seconds from the process's start to the window: imports, the weights made on
the card, the pipeline built, the kernels loaded (built by the checkout's first
run), the warm-up requests that capture the step programs."""


def read(rec):
    return rec.setup_s
