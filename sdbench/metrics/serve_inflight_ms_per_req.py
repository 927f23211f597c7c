"""The mean ms a served request of the traced segment was in flight: its
``serve.inflight`` span, from its call's dispatch to its image handed back."""

from sdbench.spans import mean_ms


def read(rec):
    return mean_ms(rec.trace, "serve.inflight")
