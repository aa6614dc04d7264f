"""Host ms per frame that the module's H2D copy holds the dispatching
thread: the benchmark's span around ``DevicePipeline.to_device``, over the
run's window outside the traced slice. The copy is pageable, so it first
waits until the stream has run everything queued before it (the earlier
dispatches' chains) and then copies: this time holds that wait as well as
the copy, and a faster chain lowers it too. ``h2d_ms_per_frame`` is the
copy's own device time."""


def read(ctx):
    ns = sum(e - s for name, s, e in ctx.untraced_spans if name == "h2d")
    if not ns or not ctx.untraced_frames:
        return None
    return ns / 1e6 / ctx.untraced_frames
