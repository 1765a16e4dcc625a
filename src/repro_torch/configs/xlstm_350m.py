"""xlstm-350m [ssm] — 24L d_model=1024 4H d_ff=0 vocab=50304 — sLSTM +
mLSTM blocks at a 7:1 ratio (one sLSTM closes each 8-block segment).
[arXiv:2405.04517; unverified]

d_ff=0: xLSTM blocks carry their own up/down projections (factor-2 mLSTM
up-projection) instead of a separate FFN. Recurrent family: O(1)-state
decode, runs the long_500k shape."""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="xlstm-350m",
        family="ssm",
        n_layers=24,
        d_model=1024,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        vocab=50304,
        slstm_every=8,
    )
)
