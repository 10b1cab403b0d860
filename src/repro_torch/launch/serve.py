"""Serving launcher: continuous-batching engine demo.

On the card, at full width (random bf16 weights):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \
        --requests 12 --slots 4 --max-new 16 [--int8-kv]

On the CPU, at the reduced width:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \
        --reduced --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.serving.engine import Engine, EngineConfig, Request


def main(argv: list[str] | None = None) -> list[Request]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device; default the CUDA card ('cpu' for the plain path)")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--int8-kv", action="store_true")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = M.init_params(cfg, generator=gen, device=dev)
    eng = Engine(cfg, params,
                 EngineConfig(slots=args.slots, max_len=args.max_len,
                              temperature=args.temperature,
                              kv_quantized=args.int8_kv,
                              prefill_buckets=(32, 64, 128)),
                 eos_id=-1)  # random weights never "finish"; run to budget
    rng = np.random.default_rng(args.seed)
    reqs = []
    for i in range(args.requests):
        plen = int(rng.integers(4, 24))
        req = Request(rid=i,
                      prompt=rng.integers(1, cfg.vocab_size, plen).astype(np.int32),
                      max_new_tokens=args.max_new)
        reqs.append(req)
        eng.submit(req)

    t0 = time.perf_counter()
    steps = 0
    while True:
        st = eng.step()
        steps += 1
        if st["active"] == 0 and st["queued"] == 0:
            break
        if steps > 100000:
            raise RuntimeError("engine did not drain")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    total_new = sum(len(r.generated) for r in reqs)
    print(f"served {len(reqs)} requests / {total_new} tokens in {dt:.2f}s "
          f"({total_new / dt:,.1f} tok/s, {steps} engine steps, "
          f"int8_kv={args.int8_kv}) on {where}")
    for r in reqs[:3]:
        print(f"  req {r.rid}: prompt[:6]={r.prompt[:6].tolist()} "
              f"-> generated[:8]={r.generated[:8]}")
    return reqs


if __name__ == "__main__":
    main()
