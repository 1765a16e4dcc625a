"""nemotron-4-340b [dense] — 96L d_model=18432 96H (GQA kv=8) d_ff=73728
vocab=256000 — GQA, squared-ReLU MLP. [arXiv:2402.16819; unverified]"""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="nemotron-4-340b",
        family="dense",
        n_layers=96,
        d_model=18432,
        n_heads=96,
        n_kv_heads=8,
        head_dim=192,
        d_ff=73728,
        vocab=256000,
        mlp="relu2",
        rope_theta=10000.0,
    )
)
