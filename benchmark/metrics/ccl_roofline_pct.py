"""Share (%) of the bytes bound that the CCL entry reaches: per frame one
u8 mask read and one int32 label map written (5 bytes a pixel, counted
from the entry's input and output shapes), over the card's HBM peak,
against the device time of every kernel the entry launches (its three
union-find phases, ``csrc/ccl.cu``) in the traced slice."""

import re

KERNELS = re.compile(r"\b(local|border|final)_kernel\(")


def read(ctx):
    ns = sum(e - s for name, s, e in ctx.events["kernel"] if KERNELS.search(name))
    if not ns or not ctx.frames:
        return None
    least_s = ctx.frames * ctx.cfg["height"] * ctx.cfg["width"] * (1 + 4) / ctx.peaks["hbm_bytes_per_s"]
    return 100.0 * least_s / (ns / 1e9)
