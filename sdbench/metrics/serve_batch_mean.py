"""The mean batch of the serving worker's calls into the pipeline in the window
(a span around each ``generate_image`` call, from the harness's proxy)."""


def read(rec):
    calls = [s.batch for s in rec.spans if s.name == "generate_image"]
    return sum(calls) / len(calls) if calls else None
