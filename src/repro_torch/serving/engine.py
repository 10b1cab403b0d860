"""Serving engine: slot-based continuous batching over prefill/decode.

Counterpart of `repro.serving.engine`, on one device:
  * a fixed decode batch of B slots; one `decode_step_batched` call
    decodes one token for every slot, each at its own length;
  * finished slots are refilled from the queue between device steps;
  * each admitted request is prefilled alone, right-padded to the
    smallest bucket that holds it, and its KV cache is spliced into its
    slot's rows;
  * optional int8 KV cache (`EngineConfig.kv_quantized`).

Sampling runs on the host in numpy, as in the reference. The engine's KV
cache is bf16 whatever the weights' dtype, as the reference's is.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.configs import ArchConfig
from repro_torch.models import model as M


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (P,) int32
    max_new_tokens: int
    generated: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    slots: int = 8  # decode batch size
    max_len: int = 1024
    temperature: float = 0.0  # 0 => greedy
    kv_quantized: bool = False
    prefill_buckets: tuple[int, ...] = (64, 128, 256, 512)


class Engine:
    """Continuous-batching engine around one model's prefill/decode. Runs on
    the device that holds `params`."""

    def __init__(self, cfg: ArchConfig, params: Any, ecfg: EngineConfig,
                 eos_id: int = 0):
        self.cfg = cfg
        self.params = params
        self.ecfg = ecfg
        self.eos_id = eos_id
        self.ctx = M.ModelCtx(kv_quantized=ecfg.kv_quantized)
        self.device = params["embed"]["table"].device

        B, L = ecfg.slots, ecfg.max_len
        self.state = M.init_decode_state(cfg, B, L, self.ctx, device=self.device)
        self.lengths = np.zeros(B, np.int32)  # tokens so far per slot
        self.budget = np.zeros(B, np.int32)  # remaining new tokens
        self.active = np.zeros(B, bool)
        self.slot_req: list[Optional[Request]] = [None] * B
        self.queue: list[Request] = []
        self.step_count = 0

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def bucket_for(self, p: int) -> int:
        """The smallest prefill bucket that holds a p-token prompt (p itself
        past the largest)."""
        return next((x for x in self.ecfg.prefill_buckets if x >= p),
                    max(self.ecfg.prefill_buckets[-1], p))

    def _admit(self) -> None:
        """Fill free slots from the queue (prefill + cache splice)."""
        for b in range(self.ecfg.slots):
            if self.active[b] or not self.queue:
                continue
            req = self.queue.pop(0)
            p = len(req.prompt)
            # padding right of the read position is causally inert
            prompt = np.zeros((1, self.bucket_for(p)), np.int64)
            prompt[0, :p] = req.prompt
            logits, pstate = M.prefill(self.params, self._tensor(prompt), self.cfg,
                                       self.ecfg.max_len, ctx=self.ctx,
                                       logit_index=p - 1)
            logits = logits[0, 0].cpu().numpy()
            M.splice_slot(self.state, pstate, slot=b)
            req.generated.append(self._sample_host(logits))
            self.slot_req[b] = req
            self.lengths[b] = p  # cache holds p tokens; next write at p
            self.budget[b] = req.max_new_tokens - 1
            self.active[b] = True

    def _sample_host(self, logits: np.ndarray) -> int:
        if self.ecfg.temperature <= 0:
            return int(np.argmax(logits))
        z = logits / self.ecfg.temperature
        z = z - z.max()
        p = np.exp(z) / np.exp(z).sum()
        return int(np.random.default_rng(self.step_count).choice(len(p), p=p))

    def step(self) -> dict:
        """One engine iteration: admit, decode one token for active slots."""
        self._admit()
        if not self.active.any():
            return {"active": 0, "queued": len(self.queue)}
        tokens = np.zeros((self.ecfg.slots, 1), np.int64)
        for b in range(self.ecfg.slots):
            if self.active[b]:
                tokens[b, 0] = self.slot_req[b].generated[-1]
        logits, self.state = M.decode_step_batched(
            self.params, self.state, self._tensor(tokens),
            self._tensor(self.lengths.astype(np.int64)), self.cfg, ctx=self.ctx)
        logits = logits[:, 0].cpu().numpy()
        for b in range(self.ecfg.slots):
            if not self.active[b]:
                continue
            nxt = self._sample_host(logits[b])
            req = self.slot_req[b]
            req.generated.append(nxt)
            self.lengths[b] += 1
            self.budget[b] -= 1
            hit_eos = (nxt == self.eos_id)
            full = self.lengths[b] + 1 >= self.ecfg.max_len
            if hit_eos or self.budget[b] <= 0 or full:
                req.done = True
                self.active[b] = False
                self.slot_req[b] = None
        self.step_count += 1
        return {"active": int(self.active.sum()), "queued": len(self.queue)}

    def run_until_done(self, max_steps: int = 10000) -> None:
        for _ in range(max_steps):
            st = self.step()
            if st["active"] == 0 and st["queued"] == 0:
                return
