"""The share of the traced open-loop segment, in percent, in which the device was
idle while the serving worker's own code held work: idle time in which the
innermost open span was its merge window, a dispatch or a fetch
(``serve.merge``, ``serve.dispatch``, ``serve.fetch``), less the program's spans
nested in them (the encode, the host preparation, the step program, the fetch),
which the program's layers own; as against idle for want of traffic
(``serve.wait``)."""

from sdbench.spans import idle_ns, own, program_spans

HOLDING = ("serve.merge", "serve.dispatch", "serve.fetch")


def read(rec):
    found = program_spans(rec.trace)
    if not found or not rec.trace.window_s:
        return None
    idle = idle_ns(rec.trace, own(found, lambda name: name in HOLDING))
    if idle is None:
        return None
    return 100.0 * idle / 1e9 / rec.trace.window_s
