"""Architecture registry of the port: the reference's ten architectures,
one module each, copied from ``repro.configs`` with their exact dims.

Every family serves on the card through the port's LM (``models.lm``):
dense (llama3.2-3b, minitron-4b, nemotron-4-340b, starcoder2-7b), moe
(qwen3-moe-235b-a22b, grok-1-314b), vlm (internvl2-2b), audio
(musicgen-medium), hybrid (zamba2-2.7b) and ssm (xlstm-350m).
``chip_smoke.py`` serves each at full width (phase 7b): at full depth but
for the three that do not fit one card with their float32 params beside
the bfloat16 compute copy, which it cuts to 2 of 94 layers (qwen3-moe),
1 of 64 (grok-1) and 1 of 96 with bfloat16 params (nemotron-4). Every
family trains through ``models.lm.train_loss`` (held to the reference on
the CPU); ``chip_smoke.py`` phase 10 trains llama3.2-3b at full width and
depth on the card."""

from repro_torch.configs import (  # noqa: F401
    grok_1_314b,
    internvl2_2b,
    llama3_2_3b,
    minitron_4b,
    musicgen_medium,
    nemotron_4_340b,
    qwen3_moe_235b_a22b,
    starcoder2_7b,
    xlstm_350m,
    zamba2_2_7b,
)
from repro_torch.configs.base import (  # noqa: F401
    ArchConfig,
    SHAPES,
    ShapeConfig,
    all_archs,
    get_arch,
)
