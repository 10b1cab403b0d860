"""Small sizes for the CPU tests: the same cells, with fewer planes, fewer
scene points and a slow stream, so that a run takes seconds."""


def tweak(cfg: dict, traffic: dict) -> None:
    cfg["emvs"]["num_planes"] = 24
    cfg["scene"]["points_per_plane"] = 150
    if traffic["mode"] == "offline":
        traffic["sequences"] = 2
    else:
        traffic.update(rate_events_per_s=traffic["cameras"] * 60000, warmup_s=0.5,
                       tail_s=0.5, sample_segments=4)
