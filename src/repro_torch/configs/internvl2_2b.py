"""internvl2-2b [vlm] — 24L d_model=2048 16H (GQA kv=8) d_ff=8192
vocab=92553 — InternViT + InternLM2. [arXiv:2404.16821; hf]

The InternViT frontend is a STUB per the assignment: ``input_specs``
supplies 256 precomputed patch embeddings per image as ``prefix_embeds``;
this config describes the InternLM2 language backbone."""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="internvl2-2b",
        family="vlm",
        n_layers=24,
        d_model=2048,
        n_heads=16,
        n_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab=92553,
        mlp="swiglu",
        n_prefix=256,
        rope_theta=1000000.0,
    )
)
