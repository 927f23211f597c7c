"""The 90th percentile, over every request due in the open loop's window, of the
seconds from its due time to its image on the host; a failed or unfinished
request is infinitely late."""

from sdbench.harness import percentile


def read(rec):
    if rec.mix["loop"] != "open" or not rec.due:
        return None
    return percentile(rec.latencies(), 90)
