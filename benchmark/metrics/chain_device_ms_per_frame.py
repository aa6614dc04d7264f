"""Device ms per frame of every kernel record in the traced slice (the
chain or the model, its hand kernels included; copies not)."""


def read(ctx):
    ns = sum(e - s for _, s, e in ctx.events["kernel"])
    if not ns or not ctx.frames:
        return None
    return ns / 1e6 / ctx.frames
