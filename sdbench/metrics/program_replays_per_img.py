"""Replays of the captured step programs in the window (``ProgramCache.stats()``)
over the images: 25 steps and one decode an image replay 26 graphs."""


def read(rec):
    if rec.replays is None or not rec.images:
        return None
    return rec.replays / rec.images
