"""B2's share of its roofline: the least time of the window's real B2 work
(bench/harness/roofline.py) over B2's summed device time, in percent."""
from bench.harness import roofline
from bench.harness.trace import kernel_seconds

KERNEL = "depth_argmax_kernel"


def read(ctx):
    summary, work = ctx.get("summary"), ctx.get("b2_work")
    if summary is None or work is None:
        return None
    spent = kernel_seconds(summary, KERNEL)
    if spent <= 0:
        return None
    return 100.0 * roofline.least_seconds(*work) / spent
