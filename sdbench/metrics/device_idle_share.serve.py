"""The share of the traced open-loop segment, in percent, in which no operation
ran on the card: arrivals, merging and fetches the card waited for."""

from sdbench.trace import idle_share


def read(rec):
    return idle_share(rec.trace)
