"""Row bands per B1 launch, from the program's launch counters: how many
times each launch streams a segment's events (one band CTA per plane and
segment each). Every launch of a cell uses one band plan, so the ratio of
the process's totals, warm-up included, is the window's. None where the
program has no band counter or launched no B1."""


def read(ctx):
    from repro_torch.kernels import cuda

    counts = cuda.launch_counts
    launches, bands = counts.get("backproject_vote", 0), counts.get("backproject_vote_bands")
    if not launches or bands is None:
        return None
    return bands / launches
