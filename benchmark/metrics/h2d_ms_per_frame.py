"""Device ms per frame of host-to-device copies (the profiler's HtoD
memcpy records) in the traced slice."""


def read(ctx):
    ns = sum(e - s for _, s, e in ctx.events["HtoD"])
    if not ns or not ctx.frames:
        return None
    return ns / 1e6 / ctx.frames
