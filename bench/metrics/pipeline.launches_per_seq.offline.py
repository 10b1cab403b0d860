"""Device kernels launched per finished sequence in the traced window:
the offline pipeline's launch count (memory copies and fills left out)."""


def read(ctx):
    summary, seqs = ctx.get("summary"), ctx.get("sequences", 0)
    if summary is None or not seqs:
        return None
    kernels = [o for o in summary.ops if not o.name.startswith(("Memcpy", "Memset"))]
    return len(kernels) / seqs
