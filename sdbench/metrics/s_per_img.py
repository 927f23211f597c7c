"""The window's seconds over the images it completed (closed loop): the window
opens as the first request is sent and closes when the last image is on the
host."""


def read(rec):
    if rec.mix["loop"] != "closed" or not rec.images:
        return None
    return rec.window_s / rec.images
