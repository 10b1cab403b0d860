"""The 95th percentile of the window's depth-map latencies, in ms: the
tail of the same latencies whose median is `depth_p50_ms`. It has no bound,
because host stalls inside `push` make it swing from run to run."""


def read(ctx):
    return ctx.get("depth_p95_ms")
