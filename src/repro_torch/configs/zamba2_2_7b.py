"""zamba2-2.7b [hybrid] — 54L d_model=2560 32H (GQA kv=32) d_ff=10240
vocab=32000, ssm_state=64 — Mamba2 blocks + ONE weight-shared transformer
block (attn + MLP) applied after every 6 SSM blocks. [arXiv:2411.15242; hf]

Sub-quadratic family: runs the long_500k shape."""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="zamba2-2.7b",
        family="hybrid",
        n_layers=54,
        d_model=2560,
        n_heads=32,
        n_kv_heads=32,
        head_dim=80,
        d_ff=10240,
        vocab=32000,
        mlp="gelu",
        ssm_state=64,
        ssm_expand=2,
        ssm_head_dim=64,
        attn_every=6,
        rope_theta=10000.0,
    )
)
