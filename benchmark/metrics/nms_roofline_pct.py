"""Share (%) of its bound that the NMS kernel (``csrc/nms.cu``,
``nms_kernel``) reaches over its records in the traced slice. A launch's
bound is its bytes over the card's HBM peak: the pool read once (boxes,
score, class and angle, 28 B a candidate) and the picks written once (5 B
each), counted from the configuration's ``nms_pool`` and ``max_det``. The
operations greedy NMS needs on the cell's pools (2 per live candidate a
round looks over, 38 per ProbIoU) took less time than the bytes on every
pool counted (9,600-12,400 candidates and 900-1,450 ProbIoUs a frame,
~1.2 ns against ~4.3 ns at 67 TFLOP/s float32), so the bytes decide."""

import re

KERNEL = re.compile(r"\bnms_kernel\b")
POOL_BYTES = 16 + 4 + 4 + 4  # xyxy, score, class, angle
PICK_BYTES = 4 + 1  # index, valid


def read(ctx):
    ns = [e - s for name, s, e in ctx.events["kernel"] if KERNEL.search(name)]
    if not ns:
        return None
    launch_bytes = ctx.cfg["nms_pool"] * POOL_BYTES + ctx.cfg["max_det"] * PICK_BYTES
    return 100.0 * len(ns) * launch_bytes / ctx.peaks["hbm_bytes_per_s"] / (sum(ns) / 1e9)
