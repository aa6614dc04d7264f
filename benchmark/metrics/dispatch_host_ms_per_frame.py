"""Host ms per frame that the module's chain takes to launch: the
benchmark's span around the function of ``build_packed_fn`` (every torch op
and hand kernel of the chain queued on the stream, and the result packed),
over the run's window outside the traced slice. The H2D copy before it is
not counted here (``h2d_host_ms_per_frame``), nor the executor's wait for a
free slot."""


def read(ctx):
    ns = sum(e - s for name, s, e in ctx.untraced_spans if name == "launch")
    if not ns or not ctx.untraced_frames:
        return None
    return ns / 1e6 / ctx.untraced_frames
