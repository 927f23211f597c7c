"""Device-idle ms an image of the traced segment while the program's host
preparation ran: the idle time that overlaps the union of its ``encode*`` and
``prep.*`` spans, over the segment's images."""

from sdbench.spans import idle_held_ns


def read(rec):
    idle = idle_held_ns(rec.trace, lambda name: name.startswith(("encode", "prep.")))
    if idle is None or not rec.trace.images:
        return None
    return idle / 1e6 / rec.trace.images
