"""The whole image's share of the card's peak (for the configuration's dtype) in
the window, in percent: the FLOPs of the requests completed (counted on the
benchmark's reference models, ``flops.request_flops``) over the window's
seconds."""


def read(rec):
    if rec.mix["loop"] != "closed" or not rec.images or not rec.peak_flops:
        return None
    return 100.0 * rec.window_flops / rec.window_s / rec.peak_flops
