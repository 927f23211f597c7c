"""Device ms an image of normalisation in the traced segment: GroupNorm's
kernels (its row-wise moments, its fused parameters and its affine) and
LayerNorm's, by name; a random draw's ``normal`` kernel is none of them."""

MARKS = ("groupnorm", "group_norm", "rowwisemoments", "computefusedparams", "layernorm", "layer_norm")
EXCLUDE = ("normal",)


def read(rec):
    t = rec.trace
    if t is None or not t.images:
        return None
    seconds = t.seconds(MARKS, EXCLUDE)
    return 1e3 * seconds / t.images if seconds else None
