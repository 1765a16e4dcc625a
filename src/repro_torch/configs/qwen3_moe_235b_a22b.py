"""qwen3-moe-235b-a22b [moe] — 94L d_model=4096 64H (GQA kv=4) d_ff=1536
(per expert) vocab=151936, MoE 128 experts top-8. [hf:Qwen/Qwen3-30B-A3B; hf]

Qwen3 family: SwiGLU experts, RoPE theta 1e6, GQA 64/4."""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="qwen3-moe-235b-a22b",
        family="moe",
        n_layers=94,
        d_model=4096,
        n_heads=64,
        n_kv_heads=4,
        head_dim=64,
        d_ff=1536,
        vocab=151936,
        mlp="swiglu",
        n_experts=128,
        top_k=8,
        rope_theta=1000000.0,
    )
)
