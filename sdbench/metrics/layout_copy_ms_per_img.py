"""Device ms an image of layout conversions, casts and copies in the traced
segment: cuDNN's NCHW/NHWC transposes and PyTorch's copy kernels."""

MARKS = ("nchwtonhwc", "nhwctonchw", "direct_copy", "_copy")
EXCLUDE = ("memcpy",)


def read(rec):
    t = rec.trace
    if t is None or not t.images:
        return None
    seconds = t.seconds(MARKS, EXCLUDE)
    return 1e3 * seconds / t.images if seconds else None
