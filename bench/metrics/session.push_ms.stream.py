"""Mean host-clock milliseconds of one `push` or `push_poses` call over the
measured window: the stream session's ingest, aggregation and planning, and
whatever dispatching the call does."""


def read(ctx):
    n = ctx.get("push_calls", 0)
    if not n:
        return None
    return 1e3 * ctx["push_s"] / n
