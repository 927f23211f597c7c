"""The attention kernels' share of their roofline in the traced segment, in
percent: the least time of the traced requests' self-attentions of 512 tokens
or more (as the configuration defines them, at the card's bf16 peak and memory
rate; ``flops.long_attentions``), over the device time of every kernel named for
attention: the library's K1 and K2 and PyTorch's SDPA back ends."""

MARKS = ("flash_onepass", "flash_online", "flash_bf16", "fmha", "flash_fwd", "sdpa", "attention")


def read(rec):
    t = rec.trace
    if t is None or not rec.trace_attention_bound_s:
        return None
    seconds = t.seconds(MARKS)
    return 100.0 * rec.trace_attention_bound_s / seconds if seconds else None
