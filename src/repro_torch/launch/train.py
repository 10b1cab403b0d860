"""Training launcher: an end-to-end training loop with fault tolerance.

On the CPU, at a reduced width:

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b --reduced \
        --steps 50 --batch 8 --seq 128 --ckpt-dir results/ckpt --device cpu

On the card drop `--device cpu`; without it and without a card it
raises. Counterpart of `repro.launch.train`:
  * a deterministic restartable data stream (resume = replay the step
    counter);
  * checkpoint/restart (rolling, atomic; `training.checkpoint`) and the
    preemption drain (SIGTERM: checkpoint, then exit cleanly);
  * the straggler watchdog on logged step times.
The step is `training.train_step.make_train_step` on one card (remat on);
the host reads the metrics only at logged steps.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.distributed.fault_tolerance import PreemptionHandler, StragglerMonitor
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.data import DataConfig, TokenStream
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_step import TrainOptions, init_train_state, make_train_step


def main(argv: list[str] | None = None) -> dict:
    """Train; returns {"start_step", "losses" (logged step -> loss), "state"}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (CPU-runnable)")
    ap.add_argument("--device", default=None,
                    help="torch device; default the CUDA card ('cpu' for the plain path)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    opts = TrainOptions(
        microbatches=args.microbatches,
        remat=True,
        opt=AdamWConfig(peak_lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                        total_steps=args.steps),
    )
    state = init_train_state(torch.Generator(device=dev).manual_seed(args.seed), cfg, opts,
                             device=dev)
    start_step = 0
    if args.ckpt_dir:
        last = ckpt.latest(args.ckpt_dir)
        if last is not None:
            print(f"[restore] resuming from step {last}")
            state = ckpt.restore(args.ckpt_dir, last, state, cfg)
            start_step = last

    step_fn = make_train_step(cfg, opts)
    data = TokenStream(DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                                  global_batch=args.batch, seed=args.seed))
    drain = PreemptionHandler()
    watchdog = StragglerMonitor()
    losses: dict[int, float] = {}
    try:
        t_last = time.time()
        for step in range(start_step, args.steps):
            batch = {k: torch.from_numpy(v).to(dev) for k, v in data.batch(step).items()}
            state, metrics = step_fn(state, batch)
            if (step + 1) % args.log_every == 0 or step == start_step:
                loss = float(metrics["loss"])
                losses[step + 1] = loss
                dt = time.time() - t_last
                t_last = time.time()
                tok_s = args.batch * args.seq * args.log_every / max(dt, 1e-9)
                print(f"step {step + 1:5d}  loss {loss:.4f}  "
                      f"lr {float(metrics['lr']):.2e}  "
                      f"gnorm {float(metrics['grad_norm']):.2f}  "
                      f"{tok_s:,.0f} tok/s", flush=True)
                action = watchdog.observe(dt)
                if action:
                    print(f"[straggler] {action}: step time {dt:.2f}s")
            want_ckpt = args.ckpt_dir and (step + 1) % args.ckpt_every == 0
            if want_ckpt or (drain.should_drain and args.ckpt_dir):
                path = ckpt.save(args.ckpt_dir, step + 1, state, cfg)
                print(f"[ckpt] step {step + 1} -> {path}")
            if drain.should_drain:
                print("[drain] preemption signal received; exiting cleanly")
                return {"start_step": start_step, "losses": losses, "state": state}
        if args.ckpt_dir:
            ckpt.save(args.ckpt_dir, args.steps, state, cfg)
    finally:
        drain.restore()
    print("done")
    return {"start_step": start_step, "losses": losses, "state": state}


if __name__ == "__main__":
    main()
