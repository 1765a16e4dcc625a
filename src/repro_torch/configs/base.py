"""Architecture + shape configuration schema and the --arch registry.

The port's own copy of ``repro.configs.base``: the same dataclasses and
fields, so a configuration reads the same in both packages. Every
architecture of the reference is registered (``repro_torch.configs``)."""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    mlp: str = "swiglu"  # swiglu | geglu | relu2 | gelu
    # MoE
    n_experts: int = 0
    top_k: int = 0
    # SSM / hybrid / xLSTM structure
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_head_dim: int = 64
    attn_every: int = 0  # hybrid: shared attention block after every k SSM blocks
    slstm_every: int = 0  # xlstm: one sLSTM block after every k mLSTM blocks
    # modality frontend stub (vlm/audio): number of prefix embedding slots
    n_prefix: int = 0
    # numerics
    rope_theta: float = 10000.0
    logit_softcap: float = 0.0
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    # runtime structure
    remat: bool = True
    remat_policy: str = "full"  # full | dots (save matmul outputs)
    scan_layers: bool = True
    moe_block: int = 1024  # tokens per routing group (one-hot dispatch)
    capacity_factor: float = 1.25

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def sub_quadratic(self) -> bool:
        return self.family in ("hybrid", "ssm")

    def scaled(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def smoke(self) -> "ArchConfig":
        """A reduced same-family config for CPU smoke tests."""
        kw = dict(
            n_layers=min(self.n_layers, 2),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab=256,
            ssm_head_dim=16 if self.ssm_state else 64,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            attn_every=min(self.attn_every, 2) if self.attn_every else 0,
            slstm_every=min(self.slstm_every, 2) if self.slstm_every else 0,
            n_prefix=min(self.n_prefix, 4) if self.n_prefix else 0,
            moe_block=32,
            dtype="float32",
            param_dtype="float32",
        )
        return self.scaled(**kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode
    grad_accum: int = 1  # microbatch count for training shapes


# The assigned input-shape set (LM transformer shapes).
TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


_REGISTRY: dict = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    import repro_torch.configs  # noqa: F401  (ensures the config modules are loaded)

    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def all_archs() -> dict:
    import repro_torch.configs  # noqa: F401

    return dict(_REGISTRY)


def shape_applicable(cfg: ArchConfig, shape: ShapeConfig) -> bool:
    """long_500k only runs for sub-quadratic families."""
    if shape.name == "long_500k":
        return cfg.sub_quadratic
    return True
