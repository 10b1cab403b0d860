"""The 10 assigned architectures (public literature) + the paper's EMVS
workload, in one module so the registry is greppable. The `source`
strings are the reference's, word for word.
"""
from __future__ import annotations

from repro_torch.configs import ArchConfig, MoEConfig, SSMConfig

REGISTRY: dict[str, ArchConfig] = {}


def _add(cfg: ArchConfig) -> ArchConfig:
    REGISTRY[cfg.name] = cfg
    return cfg


# --- MoE -------------------------------------------------------------------

KIMI_K2 = _add(ArchConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_head=112,  # 7168 / 64
    d_ff=2048,
    vocab_size=163840,
    moe=MoEConfig(num_experts=384, top_k=8, d_ff_expert=2048,
                  num_shared_experts=1),
    source="arXiv:2501.kimi2 (paper-table; unverified). Deviation: K2's "
           "first dense layer is modelled as MoE to keep the layer stack "
           "scan-homogeneous (noted in DESIGN.md).",
))

DEEPSEEK_MOE = _add(ArchConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_head=128,
    d_ff=1408,
    vocab_size=102400,
    moe=MoEConfig(num_experts=64, top_k=6, d_ff_expert=1408,
                  num_shared_experts=2),
    source="arXiv:2401.06066 (hf). Fine-grained 2-shared + 64-routed top-6. "
           "Deviation: first dense layer modelled as MoE (scan-homogeneous).",
))

# --- dense -----------------------------------------------------------------

MUSICGEN = _add(ArchConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    mlp_variant="gelu",
    frontend="audio_frames",
    n_frontend_tokens=0,  # decoder over EnCodec tokens; embeddings stubbed
    source="arXiv:2306.05284 (hf). Decoder-only over EnCodec codes; the "
           "EnCodec frontend is a stub per assignment (input_specs provides "
           "precomputed frame embeddings).",
))

STABLELM = _add(ArchConfig(
    name="stablelm-3b",
    family="dense",
    n_layers=32,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=6912,
    vocab_size=50304,
    source="hf:stabilityai/stablelm-2 family (unverified).",
))

QWEN3 = _add(ArchConfig(
    name="qwen3-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=12288,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1e6,
    source="hf:Qwen/Qwen3-8B (hf). qk_norm + GQA kv=8.",
))

STARCODER2 = _add(ArchConfig(
    name="starcoder2-15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    d_head=128,
    d_ff=24576,
    vocab_size=49152,
    qkv_bias=True,
    mlp_variant="gelu",
    source="arXiv:2402.19173 (hf). GQA kv=4, RoPE.",
))

QWEN15 = _add(ArchConfig(
    name="qwen1.5-4b",
    family="dense",
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    d_head=128,
    d_ff=6912,
    vocab_size=151936,
    qkv_bias=True,
    source="hf:Qwen/Qwen1.5 family (hf). QKV bias.",
))

# --- hybrid / ssm ----------------------------------------------------------

JAMBA = _add(ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=24576,
    vocab_size=65536,
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=24576,
                  num_shared_experts=0, layout="alternate"),
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2, conv_kernel=4,
                  chunk_size=256),
    # Jamba period-8 super-block: attention at position 4 of 8 (1:7)
    block_pattern=("mamba", "mamba", "mamba", "mamba",
                   "attn", "mamba", "mamba", "mamba"),
    source="arXiv:2403.19887 (hf). MoE every other layer (top-2 of 16); "
           "Mamba layers use our Mamba-2 SSD cell (Jamba ships Mamba-1; "
           "adaptation noted in DESIGN.md §Arch-applicability).",
))

LLAVA = _add(ArchConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14336,
    vocab_size=32000,
    frontend="vision_patches",
    n_frontend_tokens=2880,  # anyres 4 tiles + base, 576 each
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf (unverified). Mistral-7B "
           "backbone; anyres vision tower stubbed (patch embeddings input).",
))

MAMBA2 = _add(ArchConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, conv_kernel=4,
                  chunk_size=256),
    tie_embeddings=True,
    source="arXiv:2405.21060 (unverified). SSD (state-space duality).",
))

# --- the paper's own workload ----------------------------------------------
# Not an LM: kept in the same registry so `--arch eventor-davis240` selects
# the EMVS pipeline in the launcher/dry-run (see configs/shapes.py).

EVENTOR = _add(ArchConfig(
    name="eventor-davis240",
    family="emvs",
    n_layers=0, d_model=0, n_heads=0, n_kv_heads=0, d_ff=0, vocab_size=0,
    source="The paper: DAVIS240 (240x180) event camera, 1024-event frames, "
           "DSI 240x180xNz. See repro.core.",
))
