"""Segments returned per sweep dispatched over the measured window, from the
engines' public `stats` counters: how much the dispatcher coalesces."""


def read(ctx):
    d = ctx.get("dispatches", 0)
    if not d:
        return None
    return ctx["segments"] / d
