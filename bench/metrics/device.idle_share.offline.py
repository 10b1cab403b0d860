"""The share of the traced window in which no operation ran on the card,
in percent (offline cells)."""


def read(ctx):
    summary = ctx.get("summary")
    if summary is None or summary.window_s <= 0:
        return None
    return 100.0 * (1.0 - summary.busy_s / summary.window_s)
