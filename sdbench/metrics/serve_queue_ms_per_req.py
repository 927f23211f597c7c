"""The mean ms a served request of the traced segment waited in the worker's
queue: its ``serve.queue`` span, from its enqueue to its call's dispatch."""

from sdbench.spans import mean_ms


def read(rec):
    return mean_ms(rec.trace, "serve.queue")
