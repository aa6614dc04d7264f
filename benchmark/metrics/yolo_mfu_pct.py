"""Share (%) of the card's bf16 peak that the YOLO configuration's model
reaches: the reference's count of the conv stack's operations per frame
(``forward_flops``, 2 x every conv's multiply-adds at the configuration's
widths and input size) times the frames of the traced slice, over the
device time of every kernel record in the slice (the letterbox, the convs,
decode and NMS), against ``PEAKS["bf16_flops_per_s"]``: the time
``chain_device_ms_per_frame`` reads, as a share of the card's peak."""


def read(ctx):
    ns = sum(e - s for _, s, e in ctx.events["kernel"])
    flops = getattr(ctx.reference, "forward_flops", None)
    if not ns or not ctx.frames or flops is None:
        return None
    return 100.0 * flops(ctx.cfg) * ctx.frames / (ns / 1e9) / ctx.peaks["bf16_flops_per_s"]
