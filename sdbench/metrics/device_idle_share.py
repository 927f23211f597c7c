"""The share of the traced segment, in percent, in which no operation ran on the
card (closed-loop cells)."""

from sdbench.trace import idle_share


def read(rec):
    return idle_share(rec.trace)
