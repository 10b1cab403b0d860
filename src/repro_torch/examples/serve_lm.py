"""Serving example: continuous batching with int8 KV-cache quantization.

Compares bf16 and int8 KV caches on identical traffic, the LM
instantiation of the paper's Table-1 memory-halving insight.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm [--arch qwen3-8b] [--device cpu]

Counterpart of the reference's `examples/serve_lm.py`: the arch's reduced
config with random bf16 weights, 4 slots. Runs on the CUDA card unless
`--device cpu`.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.models.kv_cache import KVCache, cache_bytes
from repro_torch.serving.engine import Engine, EngineConfig, Request


def drive(cfg, params, *, int8: bool, n_requests: int, seed: int = 0):
    """Serve `n_requests` seeded prompts; returns (requests, tok/s, KV bytes)."""
    eng = Engine(cfg, params,
                 EngineConfig(slots=4, max_len=192, kv_quantized=int8,
                              prefill_buckets=(32, 64)),
                 eos_id=-1)
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n_requests):
        p = rng.integers(1, cfg.vocab_size, int(rng.integers(8, 32)))
        r = Request(rid=i, prompt=p.astype(np.int32), max_new_tokens=24)
        reqs.append(r)
        eng.submit(r)
    t0 = time.time()
    eng.run_until_done(100000)
    dt = time.time() - t0
    toks = sum(len(r.generated) for r in reqs)
    kv_bytes = sum(cache_bytes(s) for s in eng.state if isinstance(s, KVCache))
    return reqs, toks / dt, kv_bytes


def main(argv: list[str] | None = None) -> dict:
    """Returns {"bf16", "int8"} (each tok/s and KV bytes) and "agreement"."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch).reduced()
    params = M.init_params(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                           device=dev)

    r16, tps16, b16 = drive(cfg, params, int8=False, n_requests=args.requests)
    r8, tps8, b8 = drive(cfg, params, int8=True, n_requests=args.requests)

    agree = np.mean([
        np.mean([a == b for a, b in zip(x.generated, y.generated)])
        for x, y in zip(r16, r8)])
    print(f"bf16 KV: {tps16:8.1f} tok/s  cache {b16 / 2 ** 20:6.1f} MiB")
    print(f"int8 KV: {tps8:8.1f} tok/s  cache {b8 / 2 ** 20:6.1f} MiB "
          f"({b16 / max(b8, 1):.2f}x smaller)")
    print(f"greedy-token agreement bf16 vs int8: {agree * 100:.1f}%")
    return {"bf16": {"tok_s": tps16, "kv_bytes": b16},
            "int8": {"tok_s": tps8, "kv_bytes": b8}, "agreement": float(agree),
            "generated": [len(r.generated) for r in r16 + r8]}


if __name__ == "__main__":
    main()
