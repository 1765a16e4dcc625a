"""musicgen-medium [audio] — 48L d_model=1536 24H (kv=24, MHA) d_ff=6144
vocab=2048 — decoder-only over EnCodec tokens. [arXiv:2306.05284; hf]

The EnCodec/conditioning frontend is a STUB per the assignment:
``input_specs`` supplies 64 precomputed conditioning-frame embeddings as
``prefix_embeds``; tokens are the (flattened) EnCodec codebook stream."""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="musicgen-medium",
        family="audio",
        n_layers=48,
        d_model=1536,
        n_heads=24,
        n_kv_heads=24,
        head_dim=64,
        d_ff=6144,
        vocab=2048,
        mlp="gelu",
        n_prefix=64,
        rope_theta=10000.0,
    )
)
