"""Architecture configs: the 10 assigned LM-family architectures + the
paper's own EMVS workload, as selectable configs (``--arch <id>``).

Plain dataclasses and data, copied from the reference's `configs` so the
port imports nothing of it; the tests hold the two registries equal.
Every entry records its public source; CPU tests instantiate
``cfg.reduced()`` (same family, tiny dims); the card runs full widths.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["ArchConfig", "MoEConfig", "SSMConfig", "get_config", "list_archs",
           "ARCH_IDS"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001
    # which layers are MoE: "all" | "alternate" (odd layers dense)
    layout: str = "all"


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_kernel: int = 4
    chunk_size: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def num_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0  # 0 -> d_model // n_heads
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    mlp_variant: str = "swiglu"  # swiglu | gelu
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid interleave: repeating super-block, e.g. ("attn",) + ("mamba",)*7
    block_pattern: Optional[tuple[str, ...]] = None
    # modality frontend stub (assignment: frontends are stubs; input_specs()
    # provides precomputed frame/patch embeddings)
    frontend: Optional[str] = None  # None | "audio_frames" | "vision_patches"
    n_frontend_tokens: int = 0
    # sharding-driven head padding (§Perf H1): extra q/kv heads whose
    # outputs are masked to zero after attention — exact fwd AND bwd
    # (masked outputs kill both the padded wo contribution and every
    # gradient into padded projections), but head counts become divisible
    # by the TP degree so attention shards instead of replicating.
    head_pad: int = 0
    kv_head_pad: int = 0
    source: str = ""

    @property
    def head_dim(self) -> int:
        if self.d_head:
            return self.d_head
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def n_heads_eff(self) -> int:
        """Head count including sharding pad (projection/layout size)."""
        return self.n_heads + self.head_pad

    @property
    def n_kv_heads_eff(self) -> int:
        return self.n_kv_heads + self.kv_head_pad

    def pad_heads_to(self, tp: int) -> "ArchConfig":
        """Pad q/kv head counts up to multiples of the TP degree.

        No-op when already divisible. Padded heads are exact-zero in the
        model function (outputs masked), so this is a pure layout
        transform that converts TP-replicated attention into sharded
        attention (§Perf H1)."""
        if self.n_heads == 0:
            return self

        def pad(n: int) -> int:
            return (-n) % tp

        hp, kp = pad(self.n_heads), pad(self.n_kv_heads)
        if hp == 0 and kp == 0:
            return self
        # groups must stay integral: (hq+hp) % (hkv+kp) == 0
        hq_p, hkv_p = self.n_heads + hp, self.n_kv_heads + kp
        while hq_p % hkv_p:
            hq_p += tp
        return dataclasses.replace(self, head_pad=hq_p - self.n_heads,
                                   kv_head_pad=kp)

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def full_attention(self) -> bool:
        """True if the arch has quadratic attention only (no sub-quadratic
        path) — such archs skip the long_500k cell per the assignment."""
        return self.family not in ("ssm", "hybrid")

    def pattern(self) -> tuple[str, ...]:
        """Per-super-block layer kinds; scan runs over super-blocks."""
        if self.block_pattern is not None:
            return self.block_pattern
        if self.family == "ssm":
            return ("mamba",)
        return ("attn",)

    def n_superblocks(self) -> int:
        p = len(self.pattern())
        assert self.n_layers % p == 0, (self.name, self.n_layers, p)
        return self.n_layers // p

    def active_params(self) -> int:
        """Approximate active (per-token) parameter count."""
        d, hd = self.d_model, self.head_dim
        per_attn = d * (self.n_heads * hd + 2 * self.n_kv_heads * hd) + self.n_heads * hd * d
        if self.ssm is not None:
            di = self.ssm.d_inner(d)
            nh = self.ssm.num_heads(d)
            # in_proj (z,x,B,C,dt) + out_proj + conv + head params
            per_mamba = (d * (2 * di + 2 * self.ssm.d_state + nh)
                         + di * d + self.ssm.conv_kernel * (di + 2 * self.ssm.d_state)
                         + 3 * nh)
        else:
            per_mamba = 0
        n_mats = 3 if self.mlp_variant == "swiglu" else 2
        if self.moe is not None:
            per_mlp = n_mats * d * self.moe.d_ff_expert * (
                self.moe.top_k + self.moe.num_shared_experts)
        else:
            per_mlp = n_mats * d * self.d_ff
        pat = self.pattern()
        n_sb = self.n_superblocks()
        total = 0
        for i, kind in enumerate(pat):
            mlp = per_mlp
            if self.moe is not None and self.moe.layout == "alternate" and i % 2 == 1:
                mlp = 3 * d * self.d_ff
            total += (per_attn if kind == "attn" else per_mamba) + mlp + 2 * d
        total *= n_sb
        total += self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return total

    def total_params(self) -> int:
        """Approximate total parameter count (MoE: all experts)."""
        if self.moe is None:
            return self.active_params()
        d = self.d_model
        per_moe_all = 3 * d * self.moe.d_ff_expert * (
            self.moe.num_experts + self.moe.num_shared_experts)
        per_moe_active = 3 * d * self.moe.d_ff_expert * (
            self.moe.top_k + self.moe.num_shared_experts)
        pat = self.pattern()
        n_moe_layers = sum(
            1 for i, _ in enumerate(pat)
            if not (self.moe.layout == "alternate" and i % 2 == 1)
        ) * self.n_superblocks()
        return self.active_params() + n_moe_layers * (per_moe_all - per_moe_active)

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        kw: dict = dict(
            name=self.name + "-reduced",
            family=self.family,
            n_layers=len(self.pattern()),
            d_model=64,
            n_heads=4,
            n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            d_ff=128,
            vocab_size=512,
            d_head=16,
            qk_norm=self.qk_norm,
            qkv_bias=self.qkv_bias,
            mlp_variant=self.mlp_variant,
            tie_embeddings=self.tie_embeddings,
            block_pattern=self.block_pattern,
            frontend=self.frontend,
            n_frontend_tokens=8 if self.frontend else 0,
            source="reduced-for-smoke",
        )
        if self.moe is not None:
            kw["moe"] = MoEConfig(
                num_experts=8, top_k=min(self.moe.top_k, 2), d_ff_expert=32,
                num_shared_experts=min(self.moe.num_shared_experts, 1),
                layout=self.moe.layout)
        if self.ssm is not None:
            kw["ssm"] = SSMConfig(d_state=16, head_dim=16, expand=2,
                                  conv_kernel=4, chunk_size=32)
        return ArchConfig(**kw)


def _registry() -> dict[str, ArchConfig]:
    from repro_torch.configs import archs

    return archs.REGISTRY


def get_config(name: str) -> ArchConfig:
    reg = _registry()
    if name not in reg:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(reg)}")
    return reg[name]


def list_archs() -> list[str]:
    return sorted(_registry())


ARCH_IDS = [
    "kimi-k2-1t-a32b",
    "deepseek-moe-16b",
    "musicgen-large",
    "stablelm-3b",
    "qwen3-8b",
    "starcoder2-15b",
    "qwen1.5-4b",
    "jamba-1.5-large-398b",
    "llava-next-mistral-7b",
    "mamba2-2.7b",
]
