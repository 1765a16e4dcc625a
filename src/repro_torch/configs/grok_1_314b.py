"""grok-1-314b [moe] — 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072, MoE 8 experts top-2. [hf:xai-org/grok-1; unverified]

Grok-1 specifics: GeGLU experts, attention-logit soft cap 30, final-logit
soft cap (we apply a single output cap), RoPE."""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="grok-1-314b",
        family="moe",
        n_layers=64,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        head_dim=128,
        d_ff=32768,
        vocab=131072,
        mlp="geglu",
        n_experts=8,
        top_k=2,
        logit_softcap=30.0,
        rope_theta=10000.0,
    )
)
