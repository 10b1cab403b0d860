"""End-to-end LM training on the port: a ~100M-parameter qwen3-family
model trained with the full substrate (AdamW + cosine, remat,
microbatching, rolling checkpoints, preemption drain, straggler
watchdog, deterministic restartable data).

    PYTHONPATH=src python -m repro_torch.examples.train_lm            # ~100M, the card
    PYTHONPATH=src python -m repro_torch.examples.train_lm --tiny --device cpu

Counterpart of the reference's `examples/train_lm.py`, with the same two
configs. Runs on the CUDA card unless `--device cpu`; checkpoints go to
`--ckpt-dir` (default under `results/`), and a rerun resumes from the
latest one.
"""
from __future__ import annotations

import argparse
import time

import torch
from torch.utils import _pytree as pytree

from repro_torch.configs import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.distributed.fault_tolerance import PreemptionHandler, StragglerMonitor
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.data import DataConfig, TokenStream
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_step import TrainOptions, init_train_state, make_train_step

# ~100M params: 12 x d512 GQA blocks + 32k vocab (qwen3 family: qk-norm)
LM100M = ArchConfig(
    name="lm-100m", family="dense", n_layers=12, d_model=512, n_heads=8,
    n_kv_heads=4, d_ff=2048, vocab_size=32768, d_head=64, qk_norm=True,
    source="example config (~100M params)")

TINY = ArchConfig(
    name="lm-tiny", family="dense", n_layers=2, d_model=128, n_heads=4,
    n_kv_heads=2, d_ff=256, vocab_size=2048, d_head=32,
    source="example smoke config")


def main(argv: list[str] | None = None) -> dict:
    """Train; returns {"start_step", "steps", "losses" (one per step run),
    "tokens_per_s" (end to end), "state"}."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--ckpt-dir", default="results/lm100m_ckpt_torch")
    ap.add_argument("--ckpt-every", type=int, default=50)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = TINY if args.tiny else LM100M
    if args.tiny:
        args.steps, args.seq, args.batch = min(args.steps, 30), 64, 4

    opts = TrainOptions(
        microbatches=args.microbatches, remat=True,
        opt=AdamWConfig(peak_lr=6e-4, warmup_steps=max(args.steps // 10, 10),
                        total_steps=args.steps))
    state = init_train_state(torch.Generator(device=dev).manual_seed(0), cfg, opts,
                             device=dev)
    n_params = sum(t.numel() for t in pytree.tree_leaves(state.params))
    print(f"model {cfg.name}: {n_params / 1e6:.1f}M params, "
          f"{args.steps} steps @ batch {args.batch} x seq {args.seq} on {dev}")

    start = 0
    last = ckpt.latest(args.ckpt_dir)
    if last is not None and last < args.steps:
        state = ckpt.restore(args.ckpt_dir, last, state, cfg)
        start = last
        print(f"[restore] resumed from step {last}")

    step_fn = make_train_step(cfg, opts)
    data = TokenStream(DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                                  global_batch=args.batch))
    drain, watchdog = PreemptionHandler(), StragglerMonitor()
    out = {"start_step": start, "steps": args.steps, "losses": [], "state": state}
    t_start, tokens_seen = time.time(), 0
    try:
        for step in range(start, args.steps):
            batch = {k: torch.from_numpy(v).to(dev) for k, v in data.batch(step).items()}
            t0 = time.time()
            state, metrics = step_fn(state, batch)
            out["state"] = state
            metrics = {k: float(v) for k, v in metrics.items()}
            dt = time.time() - t0
            tokens_seen += args.batch * args.seq
            out["losses"].append(metrics["loss"])
            if (step + 1) % 10 == 0 or step == start:
                print(f"step {step + 1:4d}  loss {metrics['loss']:.4f}  "
                      f"lr {metrics['lr']:.2e}  gnorm {metrics['grad_norm']:.2f}  "
                      f"{args.batch * args.seq / dt:,.0f} tok/s", flush=True)
            if watchdog.observe(dt) == "drain":
                print("[straggler] persistent slow steps: checkpoint + drain")
                ckpt.save(args.ckpt_dir, step + 1, state, cfg)
                return out
            if (step + 1) % args.ckpt_every == 0 or drain.should_drain:
                ckpt.save(args.ckpt_dir, step + 1, state, cfg)
                if drain.should_drain:
                    print("[drain] preempted; exiting cleanly")
                    return out
        ckpt.save(args.ckpt_dir, args.steps, state, cfg)
    finally:
        drain.restore()
    dt = time.time() - t_start
    out["tokens_per_s"] = tokens_seen / dt
    print(f"done: {tokens_seen:,} tokens in {dt:.0f}s "
          f"({tokens_seen / dt:,.0f} tok/s end-to-end)")
    return out


if __name__ == "__main__":
    main()
